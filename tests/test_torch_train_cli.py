"""The port's trainer around the step (``validate``, ``_log``, the
``camera_mask`` batch key, the profiler window, the prefetching ``fit``)
and its training CLI (``hivae_tpu_torch.cli.train_amd``) against the JAX
package on the CPU, at the tiny flagship size with a tiny SD-VAE.

  * ``validate``: posterior-mode encodes, ``sample`` with the EMA weights
    (set apart from the live ones on both sides) and the decode, with the
    JAX draws replayed: decoded frames within one uint8 level;
  * a ``use_mask`` training step on a batch with a ``camera_mask``,
    composed on the JAX side from the package's functions as its trainer
    composes them: loss 1e-5 relative (the gradients of a ``use_mask``
    model are held in ``test_torch_train_variants.py``);
  * the argument parser and the model config of the CLI against
    ``train_amd.py``'s on the same argument lists;
  * the CLI end to end on synthetic mp4s: 2 steps with flow masks,
    ``config.json``, ``args.txt``, checkpoints, a resume, and the port's
    inference CLI serving the checkpoint it wrote;
  * ``utils/misc.py`` against the JAX package's, and ``utils/profiling.py``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import train_amd as jtrain_cli
from hivae_tpu.models import amd as jamd
from hivae_tpu.models import vae as jvae
from hivae_tpu.training import trainer as jtr
from hivae_tpu_torch.cli import amd_inference
from hivae_tpu_torch.cli import common as cli_common
from hivae_tpu_torch.cli import train_amd
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.training import checkpoint as tckpt
from hivae_tpu_torch.training import trainer as ttr
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_data import _frames, _write_mp4
from test_torch_serving import recorded_draws
from test_torch_training import TINY_VAE, _perturb, _replay

KEY = jax.random.PRNGKey(0)
N, T, LAT, PIX = 2, 4, 16, 32
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "amd", "amd_n_t1d512_spatial.json")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these tiny models gain nothing from more, and
    the suite runs several test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stack():
    """(JAX AMD, params, JAX VAE, VAE params, port AMD, port VAE), tiny,
    perturbed."""
    jmod = graft._flagship(tiny=True, frames=T)
    v = jnp.zeros((1, T, 4, LAT, LAT))
    params = _perturb(jax.device_get(jax.jit(jmod.init)(
        {"params": KEY, "noise": KEY}, v, v, v, v)), seed=21)
    jv = jvae.AutoencoderKL(cfg=jvae.VAEConfig(**TINY_VAE))
    vparams = _perturb(jax.device_get(jax.jit(jv.init)(
        KEY, jnp.zeros((1, 3, PIX, PIX)))), seed=22)
    tmod = tamd.AMDModelNew(tamd.AMDConfig.from_dict(jmod.cfg.to_dict()),
                            device="cpu")
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    tv = tvae.AutoencoderKL(tvae.VAEConfig(**TINY_VAE), device="cpu").eval()
    tv.load_state_dict(flax_to_torch(vparams), strict=True)
    return jmod, params, jv, vparams, tmod, tv


def _batch(seed, mask=False, n=N):
    rng = np.random.RandomState(seed)
    clips = np.clip(rng.randn(n, T + 1, 3, PIX, PIX) * 0.5, -1, 1).astype(
        np.float32)
    grey = np.repeat(clips.mean(2, keepdims=True), 3, 2)
    batch = ttr.batch_from_clips(list(clips), list(grey))
    if mask:
        m = (rng.rand(n, 1, 1, LAT, LAT) > 0.4).astype(np.float32)
        batch["camera_mask"] = np.ascontiguousarray(
            np.broadcast_to(m, (n, 2 * T, 4, LAT, LAT)))
    return batch


def test_validate_matches_jax(stack, monkeypatch, tmp_path):
    jmod, params, jv, vparams, tmod, tv = stack
    batch = _batch(1)
    jtrainer = jtr.AMDTrainer(jmod, params, jv, vparams, jtr.TrainConfig(
        output_dir=str(tmp_path / "jax"), ema_decay=0.9))
    # on the host: the recorders' ordered callbacks run on one device
    jtrainer.state = jax.device_get(jtrainer.state.replace(
        ema_params=jax.tree.map(lambda x: 0.5 * x, jtrainer.state.params)))
    # the JAX validate's calls, jitted (eager flax on the CPU is slow)
    for name in ("vae_encode", "vae_decode"):
        monkeypatch.setattr(jvae, name, jax.jit(getattr(jvae, name),
                                                static_argnums=(0,)))
    monkeypatch.setattr(jamd, "sample", jamd.sample_jit)
    with recorded_draws(monkeypatch) as draws:
        want = jtrainer.validate(batch, sample_step=2,
                                 key=jax.random.PRNGKey(5))

    trainer = ttr.AMDTrainer(tmod, tv, ttr.TrainConfig(
        output_dir=str(tmp_path / "port"), ema_decay=0.9,
        mixed_precision="no"))
    with torch.no_grad():
        for e in trainer.state.ema_params.values():
            e.mul_(0.5)
    live = {k: p.clone() for k, p in tmod.state_dict().items()}
    got = trainer.validate(batch, sample_step=2,
                           generator=tamd.SampleDraws(replay=draws),
                           grid_path=str(tmp_path / "grid.mp4"))
    assert got.shape == want.shape == (N, T, 3, PIX, PIX)
    assert got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (tmp_path / "grid.mp4").exists()
    for k, p in tmod.state_dict().items():   # the live weights are back
        assert torch.equal(p, live[k]), k


class _Writer:
    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, value, step))

    def add_images(self, tag, images, step):
        self.calls.append(("images", tag, images.shape, step))

    def add_video(self, tag, video, step, fps=8):
        self.calls.append(("video", tag, video.shape, step))


def test_log_and_validate_panels_match_jax(stack, tmp_path):
    tmod, tv = stack[4:]
    metrics = {"loss": 1.5, "grad_norm": 0.25}
    want = _Writer()
    fake = type("T", (), {"tb": want, "global_step": 7})()
    jtr.AMDTrainer._log(fake, metrics)
    trainer = ttr.AMDTrainer(tmod, tv, ttr.TrainConfig(
        output_dir=str(tmp_path), mixed_precision="no"), tb_writer=_Writer())
    trainer.global_step = 7
    trainer._log(metrics)
    assert trainer.tb.calls == want.calls == [
        ("scalar", "train/loss", 1.5, 7), ("scalar", "train/grad_norm", 0.25,
                                           7)]
    trainer.tb.calls.clear()
    trainer.validate(_batch(2), sample_step=1)
    assert [c[:3] for c in trainer.tb.calls] == [
        ("images", "val/first_frame_pred", (N, 3, PIX, PIX)),
        ("images", "val/first_frame_gt", (N, 3, PIX, PIX)),
        ("video", "val/video_pred", (N, T, 3, PIX, PIX))]


def test_use_mask_step_matches_jax(stack, tmp_path):
    jmod, params, jv, vparams, tmod, tv = stack
    cfg = jmod.cfg.replace(use_mask=True)
    jmask = type(jmod)(cfg=cfg)
    batch = _batch(3, mask=True)
    rng = np.random.RandomState(4)
    lat = (N * T, 4, LAT, LAT)
    posterior = [rng.randn(*lat).astype(np.float32) for _ in range(4)]
    ts = rng.randint(0, 1001, (N,)).astype(np.int32)
    z0 = rng.randn(*lat).astype(np.float32)
    keys = ("videos", "ref_img", "grey_videos", "ref_grey_img")

    @jax.jit
    def loss(p, vp, pixels, cam, noise, ts, z0):
        with _replay(normal=list(noise)):
            z = [jvae.vae_encode(jv, vp, x, KEY) for x in pixels]
        with _replay(randint=[ts], normal=[z0]):
            _, _, ld = jmask.apply(p, *z, rngs={"noise": KEY},
                                   camera_mask=cam)
        return ld["loss"]

    jloss = loss(params, vparams, [batch[k] for k in keys],
                 batch["camera_mask"], posterior, ts, z0)

    port = tamd.AMDModelNew(tamd.AMDConfig.from_dict(cfg.to_dict()),
                            device="cpu")
    port.load_state_dict(tmod.state_dict(), strict=True)
    trainer = ttr.AMDTrainer(port, tv, ttr.TrainConfig(
        output_dir=str(tmp_path), mixed_precision="no"))
    draws = ttr.StepDraws(
        {k: torch.from_numpy(x) for k, x in zip(keys, posterior)},
        tamd.TrainDraws(time_step=torch.from_numpy(np.repeat(ts, T)),
                        z0=torch.from_numpy(z0)))
    m = trainer.train_step(batch, draws=draws)
    np.testing.assert_allclose(m["loss"], float(jloss), rtol=1e-5)
    assert np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
    with pytest.raises(KeyError, match="camera_mask"):
        trainer.train_step(_batch(3))


def test_fit_profiles_its_window_and_logs(stack, tmp_path):
    tmod, tv = stack[4:]
    trainer = ttr.AMDTrainer(tmod, tv, ttr.TrainConfig(
        output_dir=str(tmp_path), mixed_precision="no", log_every=1,
        profile_steps=1, profile_start=1, save_every=100,
        transfer_dtype="bf16"), tb_writer=_Writer())
    metrics = trainer.fit(iter([_batch(s, n=1) for s in (5, 6, 7)]),
                          max_steps=2)
    assert trainer.global_step == 2 and np.isfinite(metrics["loss"])
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0
    table = (tmp_path / "profile" / "table.txt").read_text()
    assert "aten::" in table
    tags = [c[1] for c in trainer.tb.calls]
    assert tags.count("train/loss") == 2 and "train/steps_per_sec" in tags


# -- the CLI -----------------------------------------------------------------


def _jax_args(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["train_amd.py"] + argv)
    return jtrain_cli.parse_args()


ARGVS = {
    "defaults": [],
    "flagship_json": ["--amd_config", CONFIG],
    "flags": ["--use_mask", "true", "--use_camera_down", "1",
              "--diffusion_model_type", "default", "--remat", "yes",
              "--remat_policy", "dots_sans_ffn", "--mp", "no",
              "--object_motion_token_num", "6", "--enc_nhead", "4",
              "--diffusion_num_layers", "3", "--camera_mask_ratio", "0.5",
              "--mu_dtype", "bf16", "--scan_layers", "true",
              "--use_regularizers", "true", "--image_height", "24"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_cli_args_and_config_match_jax(monkeypatch, case):
    argv = ["--video_dir", "v"] + ARGVS[case]
    want = _jax_args(monkeypatch, argv)
    got = train_amd.parse_args(argv + ["--device", "cpu"])
    assert vars(got) == dict(vars(want), device="cpu", dist_backend=None)
    assert train_amd.build_config(got).to_dict() == \
        jtrain_cli.build_model(want, jnp.float32).cfg.to_dict()


def test_cli_refuses_what_is_not_ported(monkeypatch):
    """Refused: AMDModelRec (``AMD_S_Rec`` and ``AMD_S_RecSplit``: a
    forward and a loss only, which the JAX package's trainer cannot train
    either). A 'tensor' extent without ring attention (weight tensor
    parallelism) is no longer refused: like any mesh of more ranks than
    the launch has, it is an error of the launch here; and
    HIVAE_MULTIHOST=1 without the coordinator's variables is one too."""
    base = ["--video_dir", "v", "--device", "cpu"]
    for extra, item in ((["--model_type", "AMD_S_Rec"], "AMDModelRec"),
                        (["--model_type", "AMD_S_RecSplit"], "AMDModelRec")):
        with pytest.raises(NotImplementedError, match=item):
            train_amd.main(base + extra)
    for mesh in (["--mesh", "2,1,1"], ["--mesh", "1,1,2"],
                 ["--mesh", "1,1,2", "--attn_impl", "xla"]):
        with pytest.raises(ValueError, match="process group has 1"):
            train_amd.main(base + mesh)
    monkeypatch.setenv("HIVAE_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="no launch found"):
        train_amd.main(base)


def test_cli_needs_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        train_amd.main(["--video_dir", "v"])


TINY_FLAGS = ["--image_height", "16", "--image_width", "16",
              "--video_frames", str(T), "--object_motion_token_num", "4",
              "--object_motion_token_channel", "32",
              "--object_enc_num_layers", "2", "--enc_nhead", "2",
              "--enc_ndim", "16", "--camera_motion_token_num", str(T),
              "--camera_motion_token_channel", "16",
              "--camera_enc_num_layers", "2", "--motion_token_num", "4",
              "--motion_token_channel", "32", "--diffusion_attn_head_dim",
              "16", "--diffusion_attn_num_heads", "4",
              "--diffusion_num_layers", "2", "--sample_size", str(PIX)]


def test_cli_trains_resumes_and_serves(monkeypatch, tmp_path, capsys):
    """The stdout writer stands in for TensorBoard (the card's machine has
    TensorBoard; here its import would load TensorFlow)."""
    monkeypatch.setattr(cli_common, "VAE_CONFIG", tvae.VAEConfig(**TINY_VAE))
    monkeypatch.setattr(train_amd, "make_writer",
                        lambda out_dir: train_amd.StdoutWriter())
    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(3):
        _write_mp4(videos / f"v{i}.mp4", _frames(i, frames=12, size=PIX))
    argv = ["--video_dir", str(videos), "--output_dir", str(tmp_path),
            "--exp_name", "run", "--device", "cpu", "--mp", "no",
            "--train_batch_size", "2", "--dataloader_num_workers", "2",
            "--save_checkpoint_interval_step", "1", "--use_mask", "true",
            "--remat", "true", "--max_train_steps", "2"] + TINY_FLAGS
    assert train_amd.main(argv) == 0
    out = capsys.readouterr().out
    assert "final metrics:" in out and "step 2: train/loss=" in out
    run = tmp_path / "run"
    cfg = tckpt.load_config(str(run))
    assert cfg == train_amd.build_config(train_amd.parse_args(argv)).to_dict()
    assert cfg["use_mask"] and cfg["image_height"] == 16
    assert "use_mask: True" in (run / "args.txt").read_text()
    assert sorted(os.listdir(run / "checkpoints")) == ["checkpoint-1",
                                                       "checkpoint-2"]
    step2 = tckpt.load_trained_params(str(run / "checkpoints"))

    resumed = [a if a != "2" or argv[i - 1] != "--max_train_steps" else "3"
               for i, a in enumerate(argv)] + ["--resume_training", "true"]
    assert train_amd.main(resumed) == 0
    assert "resumed at step 2" in capsys.readouterr().out
    state = torch.load(str(run / "checkpoints" / "checkpoint-3" / "state.pt"),
                       weights_only=True)
    assert state["step"] == 3
    assert any(not torch.equal(state["params"][k], v)
               for k, v in step2.items())

    one = tmp_path / "one"
    one.mkdir()
    os.link(videos / "v0.mp4", one / "v0.mp4")
    assert amd_inference.main([
        "--amd_config", str(run / "config.json"),
        "--amd_ckpt", str(run / "checkpoints"), "--video_dir", str(one),
        "--output_dir", str(tmp_path / "recon"), "--video_frames", str(T),
        "--sample_step", "1", "--device", "cpu"]) == 0
    assert (tmp_path / "recon" / "v0_recon.mp4").stat().st_size > 0


def test_misc_and_profiling_utils(stack, tmp_path):
    """``count_params`` and ``save_args`` as the JAX package's; the
    profiling helpers write a trace and time steps."""
    from hivae_tpu.utils import misc as jmisc
    from hivae_tpu_torch.utils import misc, profiling

    params, tmod = stack[1], stack[4]
    assert misc.count_params(tmod) == jmisc.count_params(params)
    args = train_amd.parse_args(["--video_dir", "v", "--use_mask", "true"])
    misc.save_args(args, str(tmp_path / "port"))
    jmisc.save_args(args, str(tmp_path / "jax"))
    assert (tmp_path / "port" / "args.txt").read_text() == \
        (tmp_path / "jax" / "args.txt").read_text()
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    timer = profiling.StepTimer()
    assert timer.stats() == {}
    timer.tic()
    assert timer.toc() >= 0 and set(timer.stats(4)) == {"step_time_s",
                                                          "items_per_sec"}
    assert profiling.device_memory_stats() == {} or torch.cuda.is_available()
