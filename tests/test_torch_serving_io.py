"""Checkpoint reading for inference and the three inference CLIs of the port
(``utils/checkpoint_io.py``, ``training/checkpoint.py``,
``hivae_tpu_torch/cli``), on the tiny flagship AMD_N and a tiny SD-VAE on
the CPU.

``load_safetensors`` is held to the ``safetensors`` package (exact);
``normalize_vae_keys`` and ``load_pretrain_partial`` to the JAX package's
(exact tensors; the loaded models' outputs within ``common.TOL``). The
CLIs run their ``main`` on a JAX-schema ``config.json``, the port's own
trainer checkpoint or a reference-named ``.safetensors`` and tiny mp4s with
``--device cpu``; the SD-VAE they build is swapped for the tiny one.
"""

import json
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

import test_torch_serving as common
from hivae_tpu.training import checkpoint as jckpt
from hivae_tpu.utils import torch_convert as jconvert
from hivae_tpu_torch.cli import amd_inference, amd_inference_single
from hivae_tpu_torch.cli import common as cli_common
from hivae_tpu_torch.cli import extract_motion
from hivae_tpu_torch.data import video as tvio
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.training import checkpoint as tckpt
from hivae_tpu_torch.training.trainer import AMDTrainer, TrainConfig
from hivae_tpu_torch.utils import checkpoint_io
from hivae_tpu_torch.utils.params import flax_to_torch

W = common.FRAMES
SIZE = 32
VAE_CFG = dict(block_out_channels=(32, 64), layers_per_block=1,
               norm_num_groups=8)


def _reference_named(state, patch):
    """The port's state dict as the reference names and lays it out: a
    ``PatchEmbed`` Linear (O, I*p*p) is a stride-p conv (O, I, p, p)."""
    out = {}
    for k, v in state.items():
        if k.endswith("patch_embed.proj.weight"):
            v = v.reshape(v.shape[0], -1, patch, patch)
        out[k] = v.contiguous()
    return out


@pytest.fixture(scope="module")
def amd():
    return common.tiny_amd()


@pytest.fixture
def no_safetensors_package(monkeypatch):
    """Make ``import safetensors`` fail, as where the package is missing."""
    for name in [m for m in sys.modules if m.split(".")[0] == "safetensors"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "safetensors", None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_load_safetensors_matches_package(tmp_path, monkeypatch, dtype):
    g = torch.Generator().manual_seed(0)
    state = {"a.weight": torch.randn(3, 5, generator=g).to(dtype),
             "b": torch.randn(7, generator=g).to(dtype),
             "scalar": torch.tensor(2.5).to(dtype),
             "empty": torch.zeros(0, 4, dtype=dtype),
             "q8": torch.randint(-128, 127, (4, 4), dtype=torch.int8),
             "idx": torch.arange(6, dtype=torch.int64).reshape(2, 3),
             "keep": torch.tensor([True, False, True])}
    path = str(tmp_path / "s.safetensors")
    safetensors.torch.save_file(state, path, metadata={"format": "pt"})
    want = safetensors.torch.load_file(path)
    with monkeypatch.context() as m:  # read without the package
        m.setitem(sys.modules, "safetensors", None)
        got = checkpoint_io.load_safetensors(path)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    with open(path, "rb") as f:
        raw = f.read()
    bad = str(tmp_path / "cut.safetensors")
    with open(bad, "wb") as f:
        f.write(raw[:-8])
    with pytest.raises(ValueError, match="outside"):
        checkpoint_io.load_safetensors(bad)


def test_normalize_vae_keys_matches_jax():
    rng = np.random.RandomState(1)
    old = {"encoder.mid_block.attentions.0.query.weight":
           rng.randn(8, 8, 1, 1), "encoder.mid_block.attentions.0.key.bias":
           rng.randn(8), "decoder.mid_block.attentions.0.value.weight":
           rng.randn(8, 8), "decoder.mid_block.attentions.0.proj_attn.weight":
           rng.randn(8, 8, 1, 1), "quant_conv.weight": rng.randn(8, 8, 1, 1),
           "encoder.conv_in.weight": rng.randn(4, 3, 3, 3)}
    old = {k: v.astype(np.float32) for k, v in old.items()}
    want = jconvert.normalize_vae_keys(old)
    got = checkpoint_io.normalize_vae_keys(
        {k: torch.from_numpy(v) for k, v in old.items()})
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), w), k


def test_load_pretrain_partial_matches_jax(amd, tmp_path):
    """A reference-named checkpoint of the tiny JAX parameters, loaded by
    both packages into freshly initialised models, which then agree."""
    jmod, params, tmod = amd
    patch = tmod.cfg.image_patch_size
    state = _reference_named(flax_to_torch(params), patch)
    state["stray.weight"] = torch.zeros(2)
    path = str(tmp_path / "amd.safetensors")
    safetensors.torch.save_file(state, path)
    skip = ("diffusion_transformer.proj_out",)

    v = jnp.zeros((1, W, 4, common.LAT, common.LAT))
    template = jax.device_get(jax.jit(jmod.init)(
        {"params": jax.random.PRNGKey(9), "noise": jax.random.PRNGKey(9)},
        v, v, v, v))
    jparams, jreport = jckpt.load_pretrain_partial(template, path, skip)
    fresh = tamd.AMDModelNew(tmod.cfg, device="cpu").eval()
    report = tckpt.load_pretrain_partial(fresh, path, skip)

    assert sorted(report["missing"]) == sorted(jreport["missing"]) == \
        ["diffusion_transformer.proj_out.bias",
         "diffusion_transformer.proj_out.weight"]
    assert sorted(report["unused"]) == sorted(jreport["unused"])
    want = flax_to_torch(jparams)
    got = fresh.state_dict()
    for k in got:
        if not k.startswith("diffusion_transformer.proj_out"):
            assert torch.equal(got[k], want[k]), k
    fresh.diffusion_transformer.proj_out.load_state_dict(
        {n[len("diffusion_transformer.proj_out."):]: want[n] for n in want
         if n.startswith("diffusion_transformer.proj_out")})

    video, ref, grey, gref = common._clip(90)
    jm = jax.jit(partial(jmod.apply, method="encode"))(
        jparams, *map(jnp.asarray, (video, ref, grey, gref)))
    zi = jnp.asarray(ref.reshape((W, 4, common.LAT, common.LAT)))
    ts = jnp.full((W,), 500.0)
    jv = jax.jit(partial(jmod.apply, method="velocity"))(
        jparams, jnp.concatenate([zi, zi], axis=1), ts, *jm)
    with torch.no_grad():
        tm = fresh.encode(*map(common.t, (video, ref, grey, gref)))
        tv = fresh.velocity(torch.cat([common.t(zi)] * 2, dim=1),
                            common.t(ts), *tm)
    for g, w in zip(list(tm) + [tv], list(jm) + [jv]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **common.TOL)
    bad = str(tmp_path / "bad.safetensors")
    safetensors.torch.save_file(
        {"diffusion_transformer.proj_out.weight": torch.zeros(3, 3)}, bad)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pretrain_partial(fresh, bad)


@pytest.fixture(scope="module")
def tiny_vae():
    mod = tvae.AutoencoderKL(tvae.VAEConfig(**VAE_CFG), device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return mod.eval()


@pytest.fixture(scope="module")
def serving_files(amd, tiny_vae, tmp_path_factory):
    """config.json, a trainer checkpoint with an EMA that differs from the
    parameters, the same weights as a reference-named .safetensors, the
    tiny VAE under its old diffusers names, and a directory with one mp4
    and one broken file."""
    jmod, params, tmod = amd
    d = tmp_path_factory.mktemp("serving_cli")
    with open(d / "config.json", "w") as f:
        json.dump(jmod.cfg.to_dict(), f)
    trainer = AMDTrainer(tmod, tiny_vae, TrainConfig(
        output_dir=str(d / "run"), ema_decay=0.9, mixed_precision="no"))
    with torch.no_grad():
        for e in trainer.state.ema_params.values():
            e.mul_(0.5)
    trainer.save()
    safetensors.torch.save_file(
        _reference_named(tmod.state_dict(), tmod.cfg.image_patch_size),
        str(d / "amd.safetensors"))
    vae_state = {k.replace(".to_q.", ".query.").replace(".to_out.0.",
                                                         ".proj_attn."):
                 (v[:, :, None, None] if ".to_q.weight" in k else v)
                 for k, v in tiny_vae.state_dict().items()}
    safetensors.torch.save_file(vae_state, str(d / "vae.safetensors"))
    vids = d / "videos"
    vids.mkdir()
    rng = np.random.RandomState(4)
    tvio.write_video(str(vids / "a.mp4"), rng.randint(
        0, 255, (2 * W + 2, SIZE, 40, 3), dtype=np.uint8), fps=8)
    (vids / "broken.mp4").write_bytes(b"not a video")
    return d


@pytest.fixture(scope="module")
def dual_files(tiny_vae, serving_files, tmp_path_factory):
    """config.json and a trainer checkpoint of a tiny dual-encoder
    AMDModel (``test_torch_amd_family.TINY``, grey and band filters on,
    the spatial DiT), beside ``serving_files``' videos and VAE."""
    from test_torch_amd_family import TINY

    d = tmp_path_factory.mktemp("dual_cli")
    cfg = tamd.AMDConfig(**dict(TINY, video_frames=W), use_filter=True,
                         use_grey=True, diffusion_model_type="spatial")
    with open(d / "config.json", "w") as f:
        json.dump(cfg.to_dict(), f)
    torch.manual_seed(5)
    AMDTrainer(tamd.AMDModel(cfg, device="cpu"), tiny_vae, TrainConfig(
        output_dir=str(d / "run"), mixed_precision="no")).save()
    for name in ("videos", "vae.safetensors"):
        (d / name).symlink_to(serving_files / name)
    return d


def _model_args(files, ckpt="run/checkpoints", *extra):
    return ["--amd_config", str(files / "config.json"),
            "--amd_ckpt", str(files / ckpt),
            "--vae_ckpt", str(files / "vae.safetensors"),
            "--video_frames", str(W), "--device", "cpu", *extra]


@pytest.fixture
def tiny_cli_vae(monkeypatch):
    monkeypatch.setattr(cli_common, "VAE_CONFIG", tvae.VAEConfig(**VAE_CFG))


def test_trainer_checkpoint_params_ema_and_fallback(amd, serving_files,
                                                    capsys, tmp_path):
    tmod = amd[2]
    run = str(serving_files / "run" / "checkpoints")
    params = tckpt.load_trained_params(run)
    ema = tckpt.load_trained_params(run, use_ema=True)
    assert "using EMA" in capsys.readouterr().out
    for k, p in tmod.state_dict().items():
        assert torch.equal(params[k], p) and torch.equal(ema[k], 0.5 * p), k
    no_ema = AMDTrainer(tmod, tvae.AutoencoderKL(
        tvae.VAEConfig(**VAE_CFG), device="cpu"),
        TrainConfig(output_dir=str(tmp_path), mixed_precision="no"))
    no_ema.save()
    got = tckpt.load_trained_params(str(tmp_path / "checkpoints"),
                                    use_ema=True)
    assert "no EMA tree" in capsys.readouterr().out
    assert torch.equal(got["diffusion_transformer.proj_out.weight"],
                       tmod.diffusion_transformer.proj_out.weight)


def test_orbax_checkpoint_is_refused(tmp_path):
    mgr = jckpt.CheckpointManager(str(tmp_path / "ckpts"))
    mgr.save(3, {"params": {"w": np.zeros(2, np.float32)}})
    mgr.wait()
    with pytest.raises(ValueError, match="Orbax"):
        tckpt.load_trained_params(str(tmp_path / "ckpts"))
    with pytest.raises(FileNotFoundError):
        tckpt.load_trained_params(str(tmp_path))


@pytest.mark.parametrize("ckpt,extra", [
    ("run/checkpoints", ["--use_ema", "--solver", "heun"]),
    ("amd.safetensors", ["--long", "--max_frames", str(W + 2),
                         "--mask_ratio", "0.5", "--drop_prev_img"])])
def test_amd_inference_cli(serving_files, tiny_cli_vae, no_safetensors_package,
                           tmp_path, capsys, ckpt, extra):
    out = tmp_path / "out"
    rc = amd_inference.main(_model_args(serving_files, ckpt, *extra) + [
        "--video_dir", str(serving_files / "videos"),
        "--output_dir", str(out), "--sample_step", "1"])
    log = capsys.readouterr().out
    assert rc == 1 and "FAILED" in log and "broken.mp4" in log
    frames = (W + 3) if "--long" in extra else W + 1
    total, _ = tvio.video_metadata(str(out / "a_recon.mp4"))
    got = tvio.read_video_frames(str(out / "a_recon.mp4"),
                                 np.arange(total))
    assert got.shape == (frames, SIZE, SIZE, 3)


def test_cli_refuses_unported_models_and_orbax(dual_files, serving_files,
                                               tiny_cli_vae, tmp_path):
    """``--model_type AMD_S`` serves the dual-encoder AMDModel's checkpoint
    (the one mp4 written, the broken file reported); an Orbax checkpoint is
    refused."""
    out = tmp_path / "dual"
    assert amd_inference.main(_model_args(dual_files) + [
        "--model_type", "AMD_S", "--video_dir", str(dual_files / "videos"),
        "--output_dir", str(out), "--sample_step", "1"]) == 1
    assert tvio.video_metadata(str(out / "a_recon.mp4"))[0] == W + 1
    orbax = tmp_path / "orbax" / "checkpoint-5"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        amd_inference.main(_model_args(serving_files, str(orbax.parent)) + [
            "--video_dir", str(tmp_path)])


def test_amd_inference_single_cli(serving_files, dual_files, tiny_cli_vae,
                                  tmp_path):
    """The cross clip on AMD_N; ``--diff_motion`` on the dual-encoder
    AMDModel (``--model_type AMD_S``) writes the diff-motion mp4 (video 2
    the subject, video 1 the camera source) and is refused on AMD_N, as
    the JAX CLI refuses it."""
    out = str(tmp_path / "cross.mp4")
    vid = str(serving_files / "videos" / "a.mp4")
    args = ["--video_path_1", vid, "--video_path_2", vid, "--output_path",
            out, "--sample_step", "1"]
    assert amd_inference_single.main(_model_args(serving_files) + args) == 0
    assert tvio.video_metadata(out)[0] == W + 1
    with pytest.raises(SystemExit, match="dual-encoder AMDModel"):
        amd_inference_single.main(_model_args(serving_files) + args +
                                  ["--diff_motion"])
    out = str(tmp_path / "diff.mp4")
    args[args.index("--output_path") + 1] = out
    assert amd_inference_single.main(_model_args(dual_files) + args + [
        "--model_type", "AMD_S", "--diff_motion"]) == 0
    assert tvio.video_metadata(out)[0] == W + 1


def test_extract_motion_cli_chunks(amd, serving_files, tiny_cli_vae,
                                   tmp_path):
    tmod = amd[2]
    got = {}
    for chunk in (W, 2):
        out = tmp_path / f"m{chunk}"
        rc = extract_motion.main(_model_args(serving_files) + [
            "--video_dir", str(serving_files / "videos"),
            "--output_dir", str(out), "--chunk_frames", str(chunk)])
        assert rc == 1  # the broken file
        got[chunk] = np.load(out / "a_motion.npy")
    want = (1, W, tmod.cfg.object_motion_token_num,
            tmod.cfg.object_motion_token_channel)
    assert got[W].shape == want and got[W].dtype == np.float32
    assert np.isfinite(got[W]).all()
    np.testing.assert_allclose(got[2], got[W], atol=2e-2, rtol=2e-2)
