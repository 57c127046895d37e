"""The port's CLIs over ranks, on the CPU at a tiny size:
``cli.train_amd --mesh 2,1,1`` in 2 gloo processes (launched with the JAX
CLI's ``HIVAE_MULTIHOST=1`` variables, then resumed under ``torchrun``'s),
its checkpoint served by ``cli.amd_inference`` in one process,
``cli.amd_inference`` with a ``ring`` config over 2 gloo processes, and a
config's ``attn_impl`` taking effect in ``cli.amd_inference`` (``xla``
sends no call to a kernel where ``auto`` sends the large ones)."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from test_torch_ring import run_ranks

T, PIX = 4, 32
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=1,
                norm_num_groups=8)


def worker(rank, world, port, argv_file, launch):
    """One rank of a CLI: ``cli.train_amd`` launched with the JAX CLI's
    variables ("hivae") or torchrun's ("torchrun"); ``cli.amd_inference``
    under torchrun's ("serve": it saves the frames it hands to the mp4
    writer and its ring calls; "serve_fail": rank 1's videos fail)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hivae_tpu_torch.cli import common, train_amd
    from hivae_tpu_torch.models import vae as tvae

    torch.set_num_threads(2)
    if launch == "hivae":
        os.environ.update(HIVAE_MULTIHOST="1",
                          HIVAE_COORDINATOR=f"127.0.0.1:{port}",
                          HIVAE_NUM_PROCESSES=str(world),
                          HIVAE_PROCESS_ID=str(rank))
    else:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
    common.VAE_CONFIG = tvae.VAEConfig(**TINY_VAE)
    with open(argv_file) as f:
        argv = json.load(f)
    if not launch.startswith("serve"):
        train_amd.make_writer = lambda out_dir: train_amd.StdoutWriter()
        sys.exit(train_amd.main(argv))
    from hivae_tpu_torch.cli import amd_inference
    from hivae_tpu_torch.data import video as vio
    from hivae_tpu_torch.parallel.ring_attention import sequence_sharded_sdpa

    written = _record_frames(vio)
    if launch == "serve_fail" and rank == 1:
        def fail(*a, **k):
            raise RuntimeError("a video that fails on one rank")
        amd_inference.AMDReconstructionPipeline.sample = fail
    code = amd_inference.main(argv)
    torch.save({"frames": written, "calls": sequence_sharded_sdpa.calls},
               os.path.join(os.path.dirname(argv_file), f"serve{rank}.pt"))
    sys.exit(code)


def _record_frames(vio):
    """Record the frames handed to ``vio.write_video``, by file name (the
    file is still written)."""
    written = {}

    def record(path, video, *a, _write=vio.write_video, **k):
        written[os.path.basename(path)] = torch.from_numpy(np.array(video))
        return _write(path, video, *a, **k)
    vio.write_video = record
    return written


@pytest.fixture
def attn_state():
    from hivae_tpu_torch.ops import attention as A

    saved = (A._DEFAULT_IMPL, A._RING_MESH)
    yield
    A._DEFAULT_IMPL, A._RING_MESH = saved


def _run_cli(tmp_path, argv, launch, ok=True):
    argv_file = tmp_path / f"argv_{launch}.json"
    argv_file.write_text(json.dumps(argv))
    return run_ranks(os.path.abspath(__file__), 2, [argv_file, launch], ok=ok)


def _tiny_checkpoint(tmp_path, size=16):
    """The tiny config at a ``size`` x ``size`` latent, a model of it from
    seed 0 saved as a trainer checkpoint, and one mp4 -> (config,
    checkpoint dir, video dir)."""
    from hivae_tpu_torch.cli import train_amd
    from hivae_tpu_torch.models import amd as tamd
    from test_torch_data import _frames, _write_mp4
    from test_torch_train_cli import TINY_FLAGS

    flags = list(TINY_FLAGS)
    for flag in ("--image_height", "--image_width"):
        flags[flags.index(flag) + 1] = str(size)
    args = train_amd.parse_args(["--video_dir", "v", "--device", "cpu"] +
                                flags)
    cfg = train_amd.build_config(args)
    torch.manual_seed(0)
    model = tamd.AMDModelNew(cfg, device="cpu")
    ckpt = tmp_path / "checkpoints" / "checkpoint-1"
    ckpt.mkdir(parents=True)
    torch.save({"params": model.state_dict()}, ckpt / "state.pt")
    videos = tmp_path / "videos"
    videos.mkdir()
    _write_mp4(videos / "v0.mp4", _frames(0, frames=8, size=4 * size))
    return cfg, ckpt, videos


def _serve_argv(config, ckpt, videos, out):
    return ["--amd_config", str(config), "--amd_ckpt", str(ckpt),
            "--video_dir", str(videos), "--output_dir", str(out),
            "--video_frames", str(T), "--sample_step", "1",
            "--device", "cpu"]


def test_cli_trains_on_two_ranks_resumes_and_serves(tmp_path, monkeypatch,
                                                    attn_state):
    from hivae_tpu_torch.cli import amd_inference
    from hivae_tpu_torch.cli import common as cli_common
    from hivae_tpu_torch.models import vae as tvae
    from hivae_tpu_torch.training import checkpoint as tckpt
    from test_torch_data import _frames, _write_mp4
    from test_torch_train_cli import TINY_FLAGS

    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(4):
        _write_mp4(videos / f"v{i}.mp4", _frames(i, frames=12, size=PIX))
    argv = ["--video_dir", str(videos), "--output_dir", str(tmp_path),
            "--exp_name", "run", "--device", "cpu", "--mp", "no",
            "--mesh", "2,1,1", "--train_batch_size", "2",
            "--dataloader_num_workers", "1",
            "--save_checkpoint_interval_step", "1", "--remat", "true",
            "--max_train_steps", "2"] + TINY_FLAGS
    outs = _run_cli(tmp_path, argv, "hivae")
    assert "final metrics:" in outs[0] and "step 2: train/loss=" in outs[0]
    assert "final metrics:" not in outs[1]
    run = tmp_path / "run"
    assert sorted(os.listdir(run / "checkpoints")) == ["checkpoint-1",
                                                       "checkpoint-2"]
    assert tckpt.load_config(str(run))["image_height"] == 16
    step2 = tckpt.load_trained_params(str(run / "checkpoints"))

    resumed = [a if a != "2" or argv[i - 1] != "--max_train_steps" else "3"
               for i, a in enumerate(argv)] + ["--resume_training", "true"]
    outs = _run_cli(tmp_path, resumed, "torchrun")
    assert "resumed at step 2" in outs[0]
    state = torch.load(str(run / "checkpoints" / "checkpoint-3" / "state.pt"),
                       weights_only=True)
    assert state["step"] == 3
    assert any(not torch.equal(state["params"][k], v)
               for k, v in step2.items())

    # one process serves what two trained
    monkeypatch.setattr(cli_common, "VAE_CONFIG",
                        tvae.VAEConfig(**TINY_VAE))
    one = tmp_path / "one"
    one.mkdir()
    shutil.copy(videos / "v0.mp4", one / "v0.mp4")
    assert amd_inference.main([
        "--amd_config", str(run / "config.json"),
        "--amd_ckpt", str(run / "checkpoints"), "--video_dir", str(one),
        "--output_dir", str(tmp_path / "recon"), "--video_frames", str(T),
        "--sample_step", "1", "--device", "cpu"]) == 0
    assert (tmp_path / "recon" / "v0_recon.mp4").stat().st_size > 0


def test_ring_inference_on_two_ranks(tmp_path, monkeypatch, attn_state):
    """``cli.amd_inference`` with a ``ring`` config under a 2-rank launch
    (torchrun's variables, ``--dist_backend gloo``): every attention call
    whose sequences divide by 2 runs sequence-sharded (as many calls on
    each rank as the one-process ``auto`` run makes with such shapes), the
    others take ``auto``'s route; rank 0 alone writes the mp4, and its
    frames match the one-process ``auto`` run's by the gate the sampling
    under ring is held to on the card (mean difference within 1 level,
    99th percentile within 8; the bf16 model's hops skip the bf16 rounding
    of the probabilities that ``auto``'s plain path makes). A video that
    fails on one rank ends the run on both."""
    from hivae_tpu_torch.cli import amd_inference
    from hivae_tpu_torch.cli import common as cli_common
    from hivae_tpu_torch.data import video as tvio
    from hivae_tpu_torch.models import vae as tvae
    from hivae_tpu_torch.ops import attention as A

    monkeypatch.setattr(cli_common, "VAE_CONFIG",
                        tvae.VAEConfig(**TINY_VAE))
    cfg, ckpt, videos = _tiny_checkpoint(tmp_path)
    configs = {}
    for impl in ("auto", "ring"):
        configs[impl] = tmp_path / f"config_{impl}.json"
        configs[impl].write_text(json.dumps(
            cfg.replace(attn_impl=impl).to_dict()))

    # the one-process auto run, counting the calls a ring of 2 shards
    shardable = []

    def route(q, k, v=None, implementation=None, _route=A.kernel_route):
        shardable.append(q.shape[2] % 2 == 0 and k.shape[2] % 2 == 0)
        return _route(q, k, v, implementation)
    monkeypatch.setattr(A, "kernel_route", route)
    monkeypatch.setattr(tvio, "write_video", tvio.write_video)
    want = _record_frames(tvio)
    assert amd_inference.main(_serve_argv(
        configs["auto"], ckpt, videos, tmp_path / "one")) == 0
    assert sum(shardable) > 0

    argv = _serve_argv(configs["ring"], ckpt, videos, tmp_path / "ring") + \
        ["--dist_backend", "gloo"]
    _run_cli(tmp_path, argv, "serve")
    ranks = [torch.load(tmp_path / f"serve{r}.pt", weights_only=True)
             for r in range(2)]
    for r in ranks:
        assert r["calls"] == {"kernel": 0, "plain": sum(shardable)}
    assert list(ranks[1]["frames"]) == []
    assert os.listdir(tmp_path / "ring") == ["v0_recon.mp4"]
    got = ranks[0]["frames"]["v0_recon.mp4"].numpy().astype(np.int32)
    diff = np.abs(got - want["v0_recon.mp4"].numpy().astype(np.int32))
    assert diff.mean() <= 1 and np.percentile(diff, 99) <= 8, \
        (diff.mean(), np.percentile(diff, 99))

    outs = _run_cli(tmp_path, argv, "serve_fail", ok=False)
    # the failing rank stops (no "FAILED" report of a skipped video)
    assert "a video that fails on one rank" in outs[1]
    assert "FAILED" not in outs[1]


def test_config_attn_impl_takes_effect_in_inference(tmp_path, monkeypatch,
                                                    attn_state):
    """A 32 x 32 latent puts the camera joint blocks (512 tokens) and the
    VAE mid-block (1024) above 256^2 logits: ``auto`` sends them to the
    kernels (here their plain versions), ``xla`` sends none."""
    from hivae_tpu_torch.cli import amd_inference
    from hivae_tpu_torch.cli import common as cli_common
    from hivae_tpu_torch.models import vae as tvae
    from hivae_tpu_torch.ops.kernels import flash_attention as fa

    monkeypatch.setattr(cli_common, "VAE_CONFIG",
                        tvae.VAEConfig(**TINY_VAE))
    cfg, ckpt, videos = _tiny_checkpoint(tmp_path, size=32)

    calls = {}

    def spy(name):
        fn = getattr(fa, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return counted

    for name in ("full_block_attention", "stream_attention"):
        monkeypatch.setattr(fa, name, spy(name))
    seen = {}
    for impl in ("auto", "xla"):
        config = tmp_path / f"config_{impl}.json"
        config.write_text(json.dumps(cfg.replace(attn_impl=impl).to_dict()))
        calls.clear()
        assert amd_inference.main([
            "--amd_config", str(config), "--amd_ckpt", str(ckpt),
            "--video_dir", str(videos), "--output_dir",
            str(tmp_path / impl), "--video_frames", str(T),
            "--sample_step", "1", "--device", "cpu"]) == 0
        seen[impl] = dict(calls)
    assert seen["auto"].get("full_block_attention", 0) > 0, seen
    assert not any(seen["xla"].values()), seen


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker(*map(int, sys.argv[2:5]), *sys.argv[5:])
