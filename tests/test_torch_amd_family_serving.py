"""Serving and training the dual-encoder ``AMDModel`` with the port, fp32
on the CPU at the tiny widths of ``test_torch_amd_family.TINY``:

  * the sampling drivers ``sample`` (one mask ratio for both encoders, the
    KL posterior sample), ``sample_with_refimg_motion`` (the tokens as the
    camera stream; the pair-temporal encoder's (ref, ref) pair) and
    ``decode`` against the JAX package's, its draws recorded as they are
    made (``test_torch_serving.recorded_draws``) and replayed through
    ``SampleDraws``; latents within ``test_torch_serving.TOL``;
  * ``AMDDiffMotionPipeline.sample_diff`` on synthetic mp4s against the
    JAX pipeline (uint8 within one level, 99% exact, as
    ``test_torch_serving_pipelines`` holds the others), and the
    reconstruction, long-video and GT-motion paths on the dual model;
  * the int8 table of AMD_S at full width (``meta``) against the JAX
    package's ``quantize_params`` on its ``eval_shape`` tree;
  * ``AMDTrainer`` on the model with the KL bottleneck: replayable steps,
    ``KLloss`` in the metrics, a checkpoint save and resume, ``validate``;
  * the CLIs: ``cli.train_amd --model_type AMD_S`` (2 steps, then resumed
    to 3), served by ``cli.amd_inference`` and ``cli.extract_motion`` with
    ``--model_type AMD_S``.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_serving as common
from hivae_tpu.models import amd as jamd
from hivae_tpu.models import vae as jvae
from hivae_tpu.ops import quant as jq
from hivae_tpu.pipelines import pipeline as jpipe
from hivae_tpu_torch.cli import amd_inference
from hivae_tpu_torch.cli import common as cli_common
from hivae_tpu_torch.cli import extract_motion, train_amd
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.ops import quant as tq
from hivae_tpu_torch.pipelines import (AMDDiffMotionPipeline,
                                       AMDReconstructionPipeline,
                                       GTMotionAblationPipeline)
from hivae_tpu_torch.pipelines import pipeline as tpipe
from hivae_tpu_torch.training import checkpoint as tckpt
from hivae_tpu_torch.training.trainer import (AMDTrainer, TrainConfig,
                                              batch_from_clips)
from hivae_tpu_torch.utils.params import flax_path_to_torch_key, flax_to_torch
from test_torch_amd_family import T, TINY, _one_thread
from test_torch_amd_family_models import model
from test_torch_serving_pipelines import SIZE, VAE_CFG, _same_uint8, _write

TOL = common.TOL
KEY = common.KEY


def _t(x):
    return torch.from_numpy(np.array(x))


def _clip(seed, n=1):
    rng = np.random.RandomState(seed)
    video, grey = (rng.randn(n, T, 4, 16, 16).astype(np.float32)
                   for _ in range(2))
    ref, gref = (np.ascontiguousarray(np.broadcast_to(
        rng.randn(n, 1, 4, 16, 16).astype(np.float32), video.shape))
        for _ in range(2))
    return video, ref, grey, gref


# -- the sampling drivers ------------------------------------------------------


@pytest.mark.parametrize("name,ratio", [("spatial_decouple_kl_down", 0.5),
                                        ("dual_kl_motion_transformer", None)])
def test_sample_matches_jax(monkeypatch, name, ratio):
    """The encode's draws (mask uniforms, then the object and camera KL
    posterior noises) and the start noise, replayed in the JAX package's
    order; ``object_mask_ratio`` and ``camera_mask`` are not read."""
    jmod, params, tmod = model(name)
    clip = _clip(1)
    with common.recorded_draws(monkeypatch) as draws:
        want = jamd.sample_jit(jmod, params, jax.random.PRNGKey(3),
                               *map(jnp.asarray, clip), sample_step=2,
                               camera_mask_ratio=ratio)
    assert len(draws) == 2 * (ratio is not None) + 2 + 1
    got = tamd.sample(tmod, *map(_t, clip), sample_step=2,
                      camera_mask_ratio=ratio, object_mask_ratio=0.9,
                      camera_mask=torch.zeros(1, 2 * T, 4, 16, 16),
                      generator=tamd.SampleDraws(replay=draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name,ratio", [("dual_kl_motion_transformer", 0.5),
                                        ("spatial_decouple_kl_down", None)])
def test_refimg_motion_and_decode_match_jax(monkeypatch, name, ratio):
    """The tokens ride as the camera stream; the pair-temporal encoder
    reads a (ref, ref) pair (its mask uniform (2N, patches)), the spatial
    one the reference alone."""
    jmod, params, tmod = model(name)
    video, ref = _clip(2)[:2]
    motion = np.random.RandomState(3).randn(
        1, T, 4, tmod.cfg.motion_token_channel).astype(np.float32)
    with common.recorded_draws(monkeypatch) as draws:
        want = jamd.sample_with_refimg_motion_jit(
            jmod, params, jax.random.PRNGKey(4), jnp.asarray(ref[:, 0]),
            jnp.asarray(motion), sample_step=2, mask_ratio=ratio)
    got = tamd.sample_with_refimg_motion(
        tmod, _t(ref[:, 0]), _t(motion), sample_step=2, mask_ratio=ratio,
        generator=tamd.SampleDraws(replay=draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    with torch.no_grad():
        motions = tmod.encode(*map(_t, _clip(2)), object_kl=torch.zeros(
            tmod.kl_shapes(1, T)[0]), camera_kl=torch.zeros(
            tmod.kl_shapes(1, T)[1]))
    motions.pop("kl_loss")
    jmotions = {k: jnp.asarray(v.numpy()) for k, v in motions.items()}
    with common.recorded_draws(monkeypatch) as draws:
        want = jamd.decode(jmod, params, jax.random.PRNGKey(6),
                           jnp.asarray(ref[:, :1]), jmotions, frames=T,
                           sample_step=2)
    got = tamd.decode(tmod, _t(ref[:, :1]), motions, frames=T, sample_step=2,
                      generator=tamd.SampleDraws(replay=draws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_diff_motion_needs_the_dual_model():
    new = tamd.AMDModelNew(tamd.AMDConfig(**TINY), device="cpu")
    z = torch.zeros(1, T, 4, 16, 16)
    with pytest.raises(TypeError, match="dual-encoder AMDModel"):
        tamd.sample_diff_motion(new, z, z, z, z, z)
    with pytest.raises(TypeError, match="dual-encoder AMDModel"):
        AMDDiffMotionPipeline(None, new)


# -- the pipelines -------------------------------------------------------------


@pytest.fixture(scope="module")
def stacks():
    jmod, params, tmod = model("spatial_decouple_kl_down")
    jvae_mod = jvae.AutoencoderKL(cfg=jvae.VAEConfig(**VAE_CFG))
    vae_params = common.perturb(jax.device_get(jax.jit(jvae_mod.init)(
        KEY, jnp.zeros((1, 3, SIZE, SIZE)))), 2)
    tvae_mod = tvae.AutoencoderKL(tvae.VAEConfig(**VAE_CFG), device="cpu")
    tvae_mod.load_state_dict(flax_to_torch(vae_params), strict=True)
    return jvae_mod, vae_params, jmod, params, tvae_mod.eval(), tmod


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("dual_videos")
    return {"clip": _write(d / "clip.mp4", T + 3, 0),
            "camera": _write(d / "camera.mp4", T + 3, 1),
            "long": _write(d / "long.mp4", 2 * T + 3, 2)}


def test_diff_motion_pipeline_matches_jax(stacks, videos, monkeypatch):
    """The subject's RGB and grey clips and the camera clip's grey frames
    encoded, the diff-motion sample, one decode; and the camera clip must
    matter."""
    jvae_mod, vae_params, jmod, params, tvae_mod, tmod = stacks
    jp = jpipe.AMDDiffMotionPipeline(jvae_mod, vae_params, jmod, params,
                                     window=T, use_grey=True,
                                     sample_size=SIZE)
    with common.recorded_draws(monkeypatch) as draws:
        want = jp.sample_diff(videos["clip"], videos["camera"],
                              video_sample_step=2, key=jax.random.PRNGKey(7))
    pipe = AMDDiffMotionPipeline(tvae_mod, tmod, window=T, sample_size=SIZE)
    got = pipe.sample_diff(videos["clip"], videos["camera"],
                           video_sample_step=2,
                           generator=tamd.SampleDraws(replay=list(draws)))
    _same_uint8(got, np.asarray(want))
    same_camera = pipe.sample_diff(
        videos["clip"], videos["clip"], video_sample_step=2,
        generator=tamd.SampleDraws(replay=list(draws)))
    assert np.abs(same_camera.astype(int) - got.astype(int)).max() > 0


def test_reconstruction_long_and_gt_paths_take_the_dual_model(stacks,
                                                              videos):
    tvae_mod, tmod = stacks[4:]
    gen = torch.Generator().manual_seed(0)
    pipe = AMDReconstructionPipeline(tvae_mod, tmod, window=T,
                                     sample_size=SIZE)
    out = pipe.sample(videos["clip"], video_sample_step=1, generator=gen,
                      camera_mask_ratio=0.5)
    assert out.shape == (T + 1, 3, SIZE, SIZE) and out.dtype == np.uint8
    out = pipe.sample_long(videos["long"], video_sample_step=1,
                           mask_ratio=0.5, generator=gen)
    assert out.shape == (2 * T + 3, 3, SIZE, SIZE)
    gt = GTMotionAblationPipeline(tvae_mod, tmod, window=T, sample_size=SIZE)
    out = gt.reconstruct(videos["long"], num_windows=2, video_sample_step=1,
                         generator=gen)
    assert out.shape == (2 * T + 1, 3, SIZE, SIZE)


def test_amd_s_int8_selection_matches_jax_on_meta():
    """AMD_S at full width: the port's DiT table selects the JAX table's
    layers with the same shapes (the JAX package quantises the model's
    ``diffusion_transformer``, whatever the class)."""
    kw = dict(use_filter=True, use_grey=True)
    jm = jamd.AMD_S(**kw)
    v = jax.ShapeDtypeStruct((1, 16, 4, 32, 32), jnp.float32)
    shapes = jax.eval_shape(lambda *a: jm.init(
        {"params": KEY, "noise": KEY}, *a), v, v, v, v)
    jt = jax.eval_shape(lambda p: jq.quantize_params(
        p, scope=("diffusion_transformer",)), shapes)
    tt = tq.quantize_params(tamd.AMD_S(device="meta", **kw),
                            scope=tpipe.QUANT_SCOPES["dit"])
    want = {}
    for path, e in jt.items():
        key = flax_path_to_torch_key(tuple(path.split("/")) + ("kernel",))
        want[key[:-len(".weight")]] = e["w8"].shape[::-1]
    assert {k: tuple(e["w8"].shape) for k, e in tt.items()} == want
    # 12 joint blocks: q, k, v, out (1024, 1024), FFN up and down
    assert collections.Counter(tuple(e["w8"].shape) for e in tt.values()) \
        == {(1024, 1024): 48, (4096, 1024): 12, (1024, 4096): 12}


# -- training ------------------------------------------------------------------


def _pixel_batch(seed, n=1):
    rng = np.random.RandomState(seed)
    clips = [np.tanh(rng.randn(T + 1, 3, SIZE, SIZE)).astype(np.float32)
             for _ in range(n)]
    grey = [np.repeat(c.mean(1, keepdims=True), 3, 1) for c in clips]
    return batch_from_clips(clips, grey)


def test_trainer_steps_replay_resume_and_validate(stacks, tmp_path):
    tvae_mod = stacks[4]
    cfg = tamd.AMDConfig(**TINY, use_filter=True, use_grey=True,
                         use_regularizers=True, diffusion_model_type="dual")
    torch.manual_seed(1)
    amd = tamd.AMDModel(cfg, device="cpu")
    conf = TrainConfig(output_dir=str(tmp_path), mixed_precision="no",
                       camera_mask_ratio=0.5, object_mask_ratio=0.5)
    trainer = AMDTrainer(amd, tvae_mod, conf)
    batch = _pixel_batch(3, n=2)
    draws = trainer.draw(batch)
    assert draws.model.camera_u is None and draws.model.object_perm is None
    assert draws.model.object_kl.shape == amd.kl_shapes(2, T)[0]
    device_batch = trainer._to_device(batch)
    m1, g1 = trainer.loss_and_grads(device_batch, draws)
    m2, g2 = trainer.loss_and_grads(device_batch, draws)
    assert set(m1) == {"loss", "diff_loss", "rec_loss", "KLloss"}
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    np.testing.assert_allclose(
        m1["loss"].item(), (m1["diff_loss"] + m1["KLloss"]).item(),
        rtol=1e-6)
    metrics = trainer.train_step(batch)
    assert np.isfinite(metrics["KLloss"]) and metrics["grad_norm"] > 0
    trainer.save()

    torch.manual_seed(2)
    resumed = AMDTrainer(tamd.AMDModel(cfg, device="cpu"), tvae_mod,
                         TrainConfig(**dict(conf.__dict__, resume=True)))
    assert resumed.global_step == 1
    want = trainer.train_step(batch)
    assert resumed.train_step(batch) == want
    out = trainer.validate(_pixel_batch(4), sample_step=1)
    assert out.shape == (1, T, 3, SIZE, SIZE) and out.dtype == np.uint8


def test_trainer_refuses_the_reconstruction_model(stacks, tmp_path):
    rec = tamd.AMDModelRec(tamd.AMDConfig(**TINY), device="cpu")
    with pytest.raises(TypeError, match="AMDModelRec"):
        AMDTrainer(rec, stacks[4], TrainConfig(output_dir=str(tmp_path),
                                               mixed_precision="no"))


def test_cli_trains_resumes_and_serves_amd_s(monkeypatch, tmp_path, capsys):
    """``--model_type AMD_S`` from the flags (the KL bottleneck on, equal
    token counts), 2 steps, resumed to 3, then served by
    ``cli.amd_inference`` and ``cli.extract_motion``."""
    from test_torch_train_cli import TINY_FLAGS, TINY_VAE

    monkeypatch.setattr(cli_common, "VAE_CONFIG", tvae.VAEConfig(**TINY_VAE))
    monkeypatch.setattr(train_amd, "make_writer",
                        lambda out_dir: train_amd.StdoutWriter())
    size = TINY_FLAGS[TINY_FLAGS.index("--sample_size") + 1]
    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(2):
        _write(videos / f"v{i}.mp4", 12, i)
    argv = ["--video_dir", str(videos), "--output_dir", str(tmp_path),
            "--exp_name", "run", "--device", "cpu", "--mp", "no",
            "--model_type", "AMD_S", "--use_regularizers", "true",
            "--diffusion_model_type", "default", "--train_batch_size", "2",
            "--dataloader_num_workers", "0",
            "--save_checkpoint_interval_step", "1",
            "--max_train_steps", "2"] + TINY_FLAGS
    assert train_amd.main(argv) == 0
    out = capsys.readouterr().out
    assert "final metrics:" in out and "train/KLloss=" in out
    run = tmp_path / "run"
    cfg = tckpt.load_config(str(run))
    assert cfg["use_regularizers"] and cfg["diffusion_model_type"] == "default"
    assert train_amd.main(argv[:-len(TINY_FLAGS) - 1] + ["3"] + TINY_FLAGS +
                          ["--resume_training", "true"]) == 0
    assert "resumed at step 2" in capsys.readouterr().out
    assert sorted(os.listdir(run / "checkpoints"))[-1] == "checkpoint-3"

    serve = ["--amd_config", str(run / "config.json"), "--amd_ckpt",
             str(run / "checkpoints"), "--video_dir", str(videos),
             "--video_frames", str(T), "--device", "cpu", "--model_type",
             "AMD_S"]
    assert amd_inference.main(serve + ["--output_dir", str(tmp_path / "rec"),
                                       "--sample_step", "1"]) == 0
    assert (tmp_path / "rec" / "v0_recon.mp4").stat().st_size > 0
    assert extract_motion.main(serve + ["--output_dir",
                                        str(tmp_path / "m")]) == 0
    motion = np.load(tmp_path / "m" / "v0_motion.npy")
    assert motion.shape == (1, T, 4, 32) and np.isfinite(motion).all()
    assert int(size) == SIZE
