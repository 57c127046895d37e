"""AMD_S_Camera, the camera-only ``AMDModelNew`` (object stream off), in the
port, fp32 on the CPU at the tiny widths of ``test_torch_amd_family.TINY``
with the spatial DiT:

  * ``encode``, ``velocity`` and ``sample`` against the JAX package's
    camera-only ``AMDModelNew`` (parameters from ``jax.eval_shape`` filled
    by numpy; the JAX sampler's draws recorded and replayed): ``encode``
    and ``velocity`` within ``test_torch_models.TOL`` (2e-4), the sample
    within ``test_torch_serving.TOL``;
  * the inference CLIs build the class the factory of ``--model_type``
    builds (``models.amd.AMD_CLASSES``): a checkpoint that
    ``cli.train_amd --model_type AMD_S_Camera`` writes is served by
    ``cli.amd_inference --model_type AMD_S_Camera`` with the strict load,
    and its reference-named ``.safetensors`` loads with nothing missing.
    (The JAX CLIs build the dual-encoder ``AMDModel`` for every type but
    AMD_N, so there the same checkpoint does not load.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

import test_torch_serving as common
from hivae_tpu.models import amd as jamd
from hivae_tpu_torch.cli import amd_inference
from hivae_tpu_torch.cli import common as cli_common
from hivae_tpu_torch.cli import train_amd
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.training import checkpoint as tckpt
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_amd_family import LAT, N, T, TINY, _one_thread  # noqa: F401
from test_torch_amd_family_models import random_params
from test_torch_models import _close
from test_torch_serving_io import _reference_named

CAMERA = dict(TINY, use_filter=True, use_grey=True, use_object=False,
              diffusion_model_type="spatial")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def camera_model():
    cfg = jamd.AMDConfig(**CAMERA)
    jmod = jamd.AMDModelNew(cfg=cfg)
    v = jnp.zeros((N, T, 4, LAT, LAT))
    params = random_params(jmod, v, v, v, v, seed=7)
    tmod = tamd.AMDModelNew(tamd.AMDConfig.from_dict(cfg.to_dict()),
                            device="cpu")
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    assert not hasattr(tmod, "object_motion_encoder")
    return jmod, params, tmod.eval()


def _clip(seed):
    rng = np.random.RandomState(seed)
    video, grey = (rng.randn(N, T, 4, LAT, LAT).astype(np.float32)
                   for _ in range(2))
    ref, gref = (np.ascontiguousarray(np.broadcast_to(
        rng.randn(N, 1, 4, LAT, LAT).astype(np.float32), video.shape))
        for _ in range(2))
    return video, ref, grey, gref


def test_encode_and_velocity_match_jax(camera_model):
    jmod, params, tmod = camera_model
    clip = _clip(1)
    want = jmod.apply(params, *map(jnp.asarray, clip), method="encode")
    with torch.no_grad():
        got = tmod.encode(*map(_t, clip))
    assert got[1] is None and got[2] is None
    assert want[1] is None and want[2] is None
    _close(got[0], want[0])

    rng = np.random.RandomState(2)
    img = rng.randn(N * T, 8, LAT, LAT).astype(np.float32)
    tstep = np.array([10.0, 300.0, 520.0, 999.0] * 2, np.float32)
    target = np.asarray(want[0])
    jv = jmod.apply(params, jnp.asarray(img), jnp.asarray(tstep),
                    camera_target=jnp.asarray(target), method="velocity")
    with torch.no_grad():
        tv = tmod.velocity(_t(img), _t(tstep), camera_target=_t(target))
    _close(tv, jv)


@pytest.mark.parametrize("ratio", [None, 0.5])
def test_sample_matches_jax(camera_model, monkeypatch, ratio):
    """The camera mask uniform (with a ratio; the object ratio is not
    read, there is no object stream) and the start noise, replayed."""
    jmod, params, tmod = camera_model
    clip = _clip(3)
    with common.recorded_draws(monkeypatch) as draws:
        want = jamd.sample_jit(jmod, params, jax.random.PRNGKey(4),
                               *map(jnp.asarray, clip), sample_step=2,
                               camera_mask_ratio=ratio,
                               object_mask_ratio=ratio)
    assert len(draws) == 1 + (ratio is not None)
    got = tamd.sample(tmod, *map(_t, clip), sample_step=2,
                      camera_mask_ratio=ratio, object_mask_ratio=ratio,
                      generator=tamd.SampleDraws(replay=draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **common.TOL)


def test_amd_classes_match_the_factories():
    for name, factory in tamd.AMD_MODELS.items():
        model = factory(device="meta")
        built = tamd.AMD_CLASSES[name](model.cfg, device="meta")
        assert type(built) is type(model), name
    assert tamd.AMD_CLASSES["AMD_S_RecSplit"](
        tamd.AMDConfig(), device="meta").is_split


def test_cli_trains_and_serves_amd_s_camera(monkeypatch, tmp_path, capsys):
    """``cli.train_amd --model_type AMD_S_Camera`` on a tiny camera-only
    ``config.json`` (2 steps), then ``cli.amd_inference --model_type
    AMD_S_Camera`` on its checkpoint (strict load) and on its weights as a
    reference-named ``.safetensors``."""
    from test_torch_amd_family_serving import _write
    from test_torch_train_cli import PIX, TINY_VAE

    monkeypatch.setattr(cli_common, "VAE_CONFIG", tvae.VAEConfig(**TINY_VAE))
    monkeypatch.setattr(train_amd, "make_writer",
                        lambda out_dir: train_amd.StdoutWriter())
    config = tmp_path / "camera.json"
    config.write_text(__import__("json").dumps(
        tamd.AMDConfig(**CAMERA).to_dict()))
    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(2):
        _write(videos / f"v{i}.mp4", 12, i)
    assert train_amd.main([
        "--video_dir", str(videos), "--output_dir", str(tmp_path),
        "--exp_name", "run", "--device", "cpu", "--mp", "no",
        "--model_type", "AMD_S_Camera", "--amd_config", str(config),
        "--train_batch_size", "2", "--dataloader_num_workers", "0",
        "--sample_size", str(PIX), "--video_frames", str(T),
        "--max_train_steps", "2"]) == 0
    assert "final metrics:" in capsys.readouterr().out
    run = tmp_path / "run"
    assert not tckpt.load_config(str(run))["use_object"]

    serve = ["--amd_config", str(run / "config.json"), "--video_dir",
             str(videos), "--video_frames", str(T), "--device", "cpu",
             "--model_type", "AMD_S_Camera", "--sample_step", "1"]
    built = []
    load = cli_common.load_amd
    monkeypatch.setattr(cli_common, "load_amd", lambda *a, **k: built.append(
        load(*a, **k)) or built[-1])
    assert amd_inference.main(serve + [
        "--amd_ckpt", str(run / "checkpoints"),
        "--output_dir", str(tmp_path / "rec")]) == 0
    assert type(built[-1]) is tamd.AMDModelNew
    assert not built[-1].cfg.use_object
    assert os.path.getsize(tmp_path / "rec" / "v0_recon.mp4") > 0

    params = tckpt.load_trained_params(str(run / "checkpoints"))
    safetensors.torch.save_file(_reference_named(
        params, CAMERA.get("image_patch_size", 2)),
        str(tmp_path / "camera.safetensors"))
    assert amd_inference.main(serve + [
        "--amd_ckpt", str(tmp_path / "camera.safetensors"),
        "--output_dir", str(tmp_path / "rec_st")]) == 0
    assert "converted torch checkpoint; missing=0" in \
        capsys.readouterr().out
    for k, v in built[-1].state_dict().items():
        assert torch.equal(v, params[k].to(v.dtype)), k
