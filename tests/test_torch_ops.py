"""The port's tensor ops vs the JAX package's: embeddings, rectified-flow
sampling, the 3-D band split and the diagonal Gaussian. fp32 throughout;
tolerances are fp32 rounding (1e-5) except the band split, whose JAX side
runs separable complex64 DFT matmuls and the port an FFT (1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivae_tpu.ops import embeddings as jemb
from hivae_tpu.ops import frequency as jfreq
from hivae_tpu.ops import rectified_flow as jrf
from hivae_tpu.ops import regularizers as jreg
from hivae_tpu_torch.ops import embeddings as temb
from hivae_tpu_torch.ops import frequency as tfreq
from hivae_tpu_torch.ops import rectified_flow as trf
from hivae_tpu_torch.ops import regularizers as treg
from hivae_tpu_torch.utils.device import resolve_device


@pytest.mark.parametrize("dim", [64, 1024, 33])
def test_timestep_embedding(dim):
    steps = np.array([0.0, 1.0, 500.0, 999.0], np.float32)
    want = np.asarray(jemb.timestep_embedding(jnp.asarray(steps), dim))
    got = temb.timestep_embedding(torch.from_numpy(steps), dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dim,grid", [(64, (8, 8)), (1024, (16, 16)),
                                      (32, (4, 6))])
def test_sincos_tables(dim, grid):
    np.testing.assert_array_equal(temb.get_2d_sincos_pos_embed(dim, grid),
                                  jemb.get_2d_sincos_pos_embed(dim, grid))
    np.testing.assert_array_equal(temb.get_1d_sincos_pos_embed(dim, 17),
                                  jemb.get_1d_sincos_pos_embed(dim, 17))


@pytest.mark.parametrize("steps,start", [(10, None), (4, 1000), (3, 600)])
def test_step_sequence(steps, start):
    np.testing.assert_array_equal(trf.sample_step_sequence(steps, start),
                                  jrf.sample_step_sequence(steps, start))


def test_euler_start_and_time():
    rng = np.random.RandomState(0)
    z0, z1 = rng.randn(2, 3, 4, 4).astype(np.float32), \
        rng.randn(2, 3, 4, 4).astype(np.float32)
    for start in (1000, 700):
        want = np.asarray(jrf.euler_start(jnp.asarray(z0), jnp.asarray(z1),
                                          start))
        got = trf.euler_start(torch.from_numpy(z0), torch.from_numpy(z1),
                              start)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError):
        trf.euler_start(torch.from_numpy(z0), None, 500)
    ts = np.array([0.0, 250.0, 1000.0], np.float32)
    np.testing.assert_allclose(
        trf.timestep_to_time(torch.from_numpy(ts)).numpy(),
        np.asarray(jrf.timestep_to_time(jnp.asarray(ts))))


def test_euler_sample():
    rng = np.random.RandomState(1)
    z0 = rng.randn(3, 2, 4, 4).astype(np.float32)
    a = rng.randn(3, 2, 4, 4).astype(np.float32)
    seq = jrf.sample_step_sequence(5)
    want = np.asarray(jrf.euler_sample(
        lambda z, t: jnp.asarray(a) - 0.3 * z + t[:, None, None, None] * 1e-3,
        jnp.asarray(z0), seq))
    ta = torch.from_numpy(a)
    got = trf.euler_sample(
        lambda z, t: ta - 0.3 * z + t[:, None, None, None] * 1e-3,
        torch.from_numpy(z0), trf.sample_step_sequence(5))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,cut", [((1, 4, 17, 16, 16), 0.6),
                                       ((2, 3, 5, 8, 8), 0.25),
                                       ((1, 1, 4, 8, 8), 0.0)])
def test_freq_3d_split(shape, cut):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    jl, jh = jfreq.freq_3d_split(jnp.asarray(x), cut, cut)
    tl, th = tfreq.freq_3d_split(torch.from_numpy(x), cut, cut)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)


def test_gaussian_low_pass_filter():
    shape = (2, 4, 5, 8, 8)
    np.testing.assert_allclose(
        tfreq.gaussian_low_pass_filter(shape, 0.3, 0.4).numpy(),
        np.asarray(jfreq.gaussian_low_pass_filter(shape, 0.3, 0.4)))


def test_diagonal_gaussian():
    params = np.random.RandomState(3).randn(2, 8, 4, 4).astype(np.float32) * 20
    jd = jreg.DiagonalGaussian.from_params(jnp.asarray(params), axis=1)
    td = treg.DiagonalGaussian.from_params(torch.from_numpy(params), dim=1)
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    np.testing.assert_allclose(td.std.numpy(), np.asarray(jd.std), rtol=1e-6)
    # a sample is mean + std * N(0, 1) noise drawn from the generator
    s = td.sample(torch.Generator().manual_seed(5))
    noise = torch.randn(td.mean.shape, generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(s.numpy(), (td.mean + td.std * noise).numpy(),
                               rtol=1e-6)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            resolve_device()
