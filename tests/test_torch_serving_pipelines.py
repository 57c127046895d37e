"""The port's serving pipelines and video I/O against the JAX package's, on
the tiny flagship AMD_N and a tiny SD-VAE in fp32 on the CPU, reading
synthetic mp4 files that OpenCV writes here.

The JAX pipelines' draws are recorded as they are made
(``test_torch_serving.recorded_draws``) and replayed into the port. The
uint8 outputs may differ by one level where a value sits on a quantisation
edge (sums run in another order), and in no more than 1% of the values.
Frame indices and transformed pixels are exact.
"""

import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import test_torch_serving as common
from hivae_tpu.data import video as jvio
from hivae_tpu.models import amd as jamd
from hivae_tpu.models import vae as jvae
from hivae_tpu.pipelines import pipeline as jpipe
from hivae_tpu_torch.data import video as tvio
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.pipelines import (AMDCrossVideoPipeline,
                                       AMDReconstructionPipeline,
                                       GTMotionAblationPipeline)
from hivae_tpu_torch.utils.params import flax_to_torch

W = common.FRAMES
SIZE = 32
VAE_CFG = dict(block_out_channels=(32, 64), layers_per_block=1,
               norm_num_groups=8)


@pytest.fixture(scope="module")
def stacks():
    jamd_mod, amd_params, tamd_mod = common.tiny_amd()
    jvae_mod = jvae.AutoencoderKL(cfg=jvae.VAEConfig(**VAE_CFG))
    vae_params = common.perturb(jax.device_get(jax.jit(jvae_mod.init)(
        common.KEY, jnp.zeros((1, 3, SIZE, SIZE)))), 2)
    tvae_mod = tvae.AutoencoderKL(tvae.VAEConfig(**VAE_CFG), device="cpu")
    tvae_mod.load_state_dict(flax_to_torch(vae_params), strict=True)
    return jvae_mod, vae_params, jamd_mod, amd_params, tvae_mod.eval(), \
        tamd_mod


def _write(path, frames, seed):
    """Smooth drifting colour frames with seeded noise, (F, SIZE, SIZE, 3)
    uint8, written as an mp4 at 8 fps."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, 40), np.linspace(0, 1, 48),
                         indexing="ij")
    clip = []
    for i in range(frames):
        chans = [np.sin(2 * np.pi * (f * xx + g * yy) + 0.4 * i + ph)
                 for f, g, ph in rng.uniform(0.5, 2.0, (3, 3))]
        clip.append(np.stack(chans, -1))
    clip = np.clip(127.5 * (np.stack(clip) * 0.8 + 1.0) +
                   8 * rng.randn(frames, 40, 48, 3), 0, 255).astype(np.uint8)
    tvio.write_video(str(path), clip, fps=8)
    return str(path)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_videos")
    return {"clip": _write(d / "clip.mp4", W + 3, 0),
            "other": _write(d / "other.mp4", W + 3, 1),
            # two windows and a ragged tail of 2, plus the reference
            "long": _write(d / "long.mp4", 2 * W + 3, 2),
            "gt": _write(d / "gt.mp4", 2 * W + 1, 3)}


def _same_uint8(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def _jax_pipe(cls, stacks, grey=True, **kw):
    jvae_mod, vae_params, jamd_mod, amd_params = stacks[:4]
    if not grey:
        jamd_mod = jamd.AMDModelNew(cfg=jamd_mod.cfg.replace(use_grey=False))
    return cls(jvae_mod, vae_params, jamd_mod, amd_params, window=W,
               sample_size=SIZE, **kw)


def _port_amd(stacks, grey=True):
    tamd_mod = stacks[5]
    if grey:
        return tamd_mod
    mod = tamd.AMDModelNew(tamd_mod.cfg.replace(use_grey=False),
                           device="cpu")
    mod.load_state_dict(tamd_mod.state_dict())
    return mod.eval()


def test_video_io_matches_jax(videos, tmp_path, monkeypatch):
    path = videos["long"]
    assert tvio.video_metadata(path) == jvio.video_metadata(path)
    for args in [(100, 30.0, 17, 8), (12, 8.0, 5, 8), (3, 25.0, 9, 8)]:
        for start in (None, 0, 3):
            assert np.array_equal(
                tvio.sample_frames_with_fps(*args, start_index=start,
                                            rng=random.Random(5)),
                jvio.sample_frames_with_fps(*args, start_index=start,
                                            rng=random.Random(5)))
    idx = tvio.sample_frames_with_fps(2 * W + 3, 8.0, W + 1, 8, start_index=0)
    frames = tvio.read_video_frames(path, idx)
    assert np.array_equal(frames, jvio.read_video_frames(path, idx))
    assert np.array_equal(tvio.to_grayscale(frames),
                          jvio.to_grayscale(frames))
    for size in (SIZE, 24):
        got = tvio.pixel_transform(frames, size)
        want = jvio.pixel_transform(frames, size)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    out = tvio.write_video(str(tmp_path / "w.mp4"), frames.transpose(
        0, 3, 1, 2))
    assert tvio.video_metadata(out)[0] == W + 1
    # with a wav, the audio is muxed in (an AVI where ffmpeg is missing),
    # byte for byte as the JAX package writes it, at the path returned
    wav = str(tmp_path / "x.wav")
    wavfile.write(wav, 16000, (3000 * np.random.RandomState(1).randn(
        16000)).astype(np.int16))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    got = tvio.write_video(str(tmp_path / "a.mp4"), frames, audio_path=wav)
    want = jvio.write_video(str(tmp_path / "j.mp4"), frames, audio_path=wav)
    assert got == str(tmp_path / "a.avi") and want == str(tmp_path / "j.avi")
    with open(got, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()


def test_reconstruction_pipeline_sample_matches_jax(stacks, videos, tmp_path,
                                                    monkeypatch):
    with common.recorded_draws(monkeypatch) as draws:
        want = _jax_pipe(jpipe.AMDReconstructionPipeline, stacks,
                         use_grey=True).sample(
            videos["clip"], video_sample_step=2, camera_mask_ratio=0.5,
            object_mask_ratio=0.5, key=jax.random.PRNGKey(1), solver="heun")
    pipe = AMDReconstructionPipeline(stacks[4], stacks[5], window=W,
                                     sample_size=SIZE)
    out_path = str(tmp_path / "recon.mp4")
    got = pipe.sample(videos["clip"], out_path, video_sample_step=2,
                      camera_mask_ratio=0.5, object_mask_ratio=0.5,
                      generator=tamd.SampleDraws(replay=draws),
                      solver="heun")
    _same_uint8(got, want)
    assert tvio.video_metadata(out_path)[0] == W + 1


@pytest.mark.parametrize("grey,mask_ratio,drop_prev_img", [
    (True, None, False), (True, 0.5, True), (False, 0.0, False)])
def test_sample_long_matches_jax(stacks, videos, monkeypatch, grey,
                                 mask_ratio, drop_prev_img):
    """Two windows and a ragged tail re-run over the last W frames; a mask
    ratio of 0.0 is off."""
    with common.recorded_draws(monkeypatch) as draws:
        want = _jax_pipe(jpipe.AMDReconstructionPipeline, stacks,
                         grey=grey, use_grey=grey).sample_long(
            videos["long"], video_sample_step=2, mask_ratio=mask_ratio,
            drop_prev_img=drop_prev_img, key=jax.random.PRNGKey(2))
    assert len(draws) == 3 * (1 + 2 * bool(mask_ratio))
    pipe = AMDReconstructionPipeline(stacks[4], _port_amd(stacks, grey),
                                     window=W, sample_size=SIZE)
    got = pipe.sample_long(videos["long"], video_sample_step=2,
                           mask_ratio=mask_ratio, drop_prev_img=drop_prev_img,
                           generator=tamd.SampleDraws(replay=draws))
    assert got.shape == (2 * W + 3, 3, SIZE, SIZE)
    _same_uint8(got, want)


def test_sample_long_caps_frames_and_needs_a_window(stacks, videos):
    pipe = AMDReconstructionPipeline(stacks[4], stacks[5], window=W,
                                     sample_size=SIZE)
    gen = torch.Generator().manual_seed(0)
    out = pipe.sample_long(videos["long"], video_sample_step=1, max_frames=W,
                           generator=gen)
    assert out.shape == (W + 1, 3, SIZE, SIZE)
    with pytest.raises(ValueError, match="window"):
        pipe.sample_long(videos["long"], video_sample_step=1,
                         max_frames=W - 1, generator=gen)


def test_cross_pipeline_matches_jax(stacks, videos, monkeypatch):
    with common.recorded_draws(monkeypatch) as draws:
        want = _jax_pipe(jpipe.AMDCrossVideoPipeline, stacks,
                         use_grey=True).sample_cross(
            videos["clip"], videos["other"], video_sample_step=2,
            key=jax.random.PRNGKey(3))
    pipe = AMDCrossVideoPipeline(stacks[4], stacks[5], window=W,
                                 sample_size=SIZE)
    got = pipe.sample_cross(videos["clip"], videos["other"],
                            video_sample_step=2,
                            generator=tamd.SampleDraws(replay=draws))
    _same_uint8(got, want)


def test_gt_motion_pipeline_matches_jax(stacks, videos, monkeypatch):
    with common.recorded_draws(monkeypatch) as draws:
        want = _jax_pipe(jpipe.GTMotionAblationPipeline, stacks).reconstruct(
            videos["gt"], num_windows=2, video_sample_step=2,
            key=jax.random.PRNGKey(4), mask_ratio=0.5)
    assert len(draws) == 2 * 3
    pipe = GTMotionAblationPipeline(stacks[4], stacks[5], window=W,
                                    sample_size=SIZE)
    got = pipe.reconstruct(videos["gt"], num_windows=2, video_sample_step=2,
                           generator=tamd.SampleDraws(replay=draws),
                           mask_ratio=0.5)
    assert got.shape == (2 * W + 1, 3, SIZE, SIZE)
    _same_uint8(got, want)
