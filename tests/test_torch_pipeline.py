"""The slice end to end: the port's ``reconstruct_clip`` vs the JAX
package's ``_recon_clip`` on the tiny flagship AMD_N and a tiny SD-VAE,
with the JAX run's Euler start noise handed to the port so the two PRNGs
do not enter the comparison.

fp32 on the CPU. The uint8 outputs may differ by one level where a value
sits on a quantisation edge (sums run in another order), and in no more
than 1% of the values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from hivae_tpu.models import amd as jamd
from hivae_tpu.models import vae as jvae
from hivae_tpu.pipelines.pipeline import _recon_clip
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.pipelines import (AMDReconstructionPipeline,
                                       reconstruct_clip)
from hivae_tpu_torch.utils.params import flax_to_torch

FRAMES = 4
SIZE = 32
KEY = jax.random.PRNGKey(0)


def _perturb(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x)).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def stacks():
    jamd_mod = graft._flagship(tiny=True, frames=FRAMES)
    v = jnp.zeros((1, FRAMES, 4, 16, 16))
    amd_params = _perturb(jax.device_get(jax.jit(jamd_mod.init)(
        {"params": KEY, "noise": KEY}, v, v, v, v)), 1)
    vcfg = dict(block_out_channels=(32, 64), layers_per_block=1,
                norm_num_groups=8)
    jvae_mod = jvae.AutoencoderKL(cfg=jvae.VAEConfig(**vcfg))
    vae_params = _perturb(jax.device_get(jax.jit(jvae_mod.init)(
        KEY, jnp.zeros((1, 3, SIZE, SIZE)))), 2)

    tamd_mod = tamd.AMDModelNew(
        tamd.AMDConfig.from_dict(jamd_mod.cfg.to_dict()), device="cpu")
    tamd_mod.load_state_dict(flax_to_torch(amd_params), strict=True)
    tvae_mod = tvae.AutoencoderKL(tvae.VAEConfig(**vcfg), device="cpu")
    tvae_mod.load_state_dict(flax_to_torch(vae_params), strict=True)
    return (jvae_mod, jamd_mod, vae_params, amd_params,
            tvae_mod.eval(), tamd_mod.eval())


def _clip(seed):
    rng = np.random.RandomState(seed)
    pixels = rng.uniform(-1, 1, (FRAMES + 1, 3, SIZE, SIZE)).astype(np.float32)
    grey = np.repeat(pixels.mean(axis=1, keepdims=True), 3, axis=1)
    return pixels, grey


def test_reconstruct_clip_matches_jax(stacks):
    jvae_mod, jamd_mod, vae_params, amd_params, tvae_mod, tamd_mod = stacks
    pixels, grey = _clip(3)
    key = jax.random.PRNGKey(7)
    want = np.asarray(_recon_clip(
        jvae_mod, jamd_mod, vae_params, amd_params, jnp.asarray(pixels),
        jnp.asarray(grey), key, sample_step=2, use_grey=True))
    # the Euler start noise the JAX sampler draws (amd.sample: split, then
    # normal over the target latents' shape)
    _, knoise = jax.random.split(key)
    noise = np.array(jax.random.normal(knoise, (FRAMES, 4, 16, 16)))
    got = reconstruct_clip(tvae_mod, tamd_mod, torch.from_numpy(pixels),
                           torch.from_numpy(grey), sample_step=2,
                           generator=tamd.SampleDraws(replay=[noise]))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


def test_pipeline_sample_uses_generator_and_checks_frames(stacks):
    *_, tvae_mod, tamd_mod = stacks
    pixels, grey = _clip(4)
    pipe = AMDReconstructionPipeline(tvae_mod, tamd_mod, window=FRAMES)
    out = [pipe.sample_pixels(torch.from_numpy(pixels),
                              torch.from_numpy(grey), video_sample_step=1,
                              generator=torch.Generator().manual_seed(0))
           for _ in range(2)]
    assert out[0].shape == (FRAMES + 1, 3, SIZE, SIZE)
    assert torch.equal(out[0], out[1])
    with pytest.raises(ValueError, match="frames"):
        pipe.sample_pixels(torch.from_numpy(pixels[:-1]),
                           torch.from_numpy(grey))
    with pytest.raises(ValueError, match="grey"):
        reconstruct_clip(tvae_mod, tamd_mod, torch.from_numpy(pixels))
