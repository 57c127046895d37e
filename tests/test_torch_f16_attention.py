"""The attention kernels' reach in fp16 and at every head dim that is a
multiple of 8, on the CPU: the port's plain versions (the semantics its
CUDA kernels are held to on the card) against the JAX package's Pallas
kernels in interpret mode, the tile plan that picks each call's kernel
width, the zero-fill that lets one tile serve every head dim below it, and
a small flagship in fp16 with both packages' attention set to ``pallas``
against the JAX package. The CUDA kernels themselves are held against the
plain versions on the card by ``tests/test_torch_cuda.py``.

Inputs are numpy draws from a seed, rounded to the dtype on both sides.
Tolerances, per dtype (outputs of unit scale; gradients relative to the
largest element of each): fp16 ``F16_ATOL`` 2e-3 on outputs and
``F16_GRAD_RTOL`` 5e-3 on gradients (fp16's unit in the last place at 1 is
9.8e-4: both sides round P, O and dS to fp16 at the same points, from fp32
sums taken in another order, so a rounding may flip by one place); bf16
``BF16_ATOL`` 1.6e-2 and ``BF16_GRAD_RTOL`` 2e-2 (its place at 1 is
7.8e-3); the LSE and delta are fp32 (1e-4). The zero-fill is checked in
fp64, where the padded and unpadded calls differ only by the order of
their sums (1e-12). The flagship slice: loss within 1e-3 relative, the
gradient (every parameter as one vector) within 1e-2 relative L2 and
cosine >= 0.9999, ``sample``'s latents within 2e-2: the JAX package's own
fp16 run sits 6.7e-3 (sample) and 2.8e-3 (gradient, relative L2) from its
fp32 run at this size, the noise of fp16 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_serving as common
import test_torch_training as training
from hivae_tpu.models import amd as jamd
from hivae_tpu.ops import attention as jattn
from hivae_tpu.ops.pallas import flash_attention as jfa
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.ops import attention as tattn
from hivae_tpu_torch.ops.kernels import flash_attention as tfa
from hivae_tpu_torch.utils.params import flax_to_torch

F16_ATOL, F16_GRAD_RTOL = 2e-3, 5e-3
BF16_ATOL, BF16_GRAD_RTOL = 1.6e-2, 2e-2
F32_ATOL = 1e-4
F64_ATOL = 1e-12
TOLS = {"float16": (F16_ATOL, F16_GRAD_RTOL),
        "bfloat16": (BF16_ATOL, BF16_GRAD_RTOL)}


def _draw(shape, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _bias(b, sk, seed):
    keep = np.random.RandomState(seed).rand(b, sk) > 0.3
    keep[:, 0] = True   # every row attends to a key
    return np.where(keep, 0.0, -1e30).astype(np.float32)


def _both(xs, dtype):
    """The same values on both sides: jnp and torch arrays in ``dtype``."""
    return ([jnp.asarray(x).astype(getattr(jnp, dtype)) for x in xs],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs])


def _f(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(got, want, atol):
    err = np.abs(_f(got) - _f(want)).max()
    assert err <= atol, (err, atol)


def _close_rel(got, want, rtol):
    want = _f(want)
    err = np.abs(_f(got) - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


# -- the plain versions against the Pallas kernels --------------------------


@pytest.mark.parametrize("dtype,s,d", [("float16", 272, 40),
                                       ("float16", 260, 72),
                                       ("bfloat16", 260, 72)])
def test_full_block_plain_matches_pallas(dtype, s, d):
    """#1 (the full-block forward), #2 (its backward) and its delta
    pre-pass: the JAX package sends these shapes to its full-block Pallas
    kernels (``_full_block_fits``), the port to its full-block kernels on
    the 64 and 96 tiles. The pre-pass's delta = rowsum(dO * O) against the
    Pallas backward's rowsum(dP * P) (equal but for O's rounding), its 1/l
    against the forward's denominator."""
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_draw((1, 2, s, d), 4, s + d),
                                             dtype)
    bias = _bias(1, s, seed=d)
    scale = d ** -0.5

    @jax.jit
    def jax_side(q, k, v, do):
        fn = lambda q, k, v: jfa.flash_attention(q, k, v, scale=scale,
                                                 bias=jnp.asarray(bias))
        out, vjp = jax.vjp(fn, q, k, v)
        logits = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32),
                            k.astype(jnp.float32)) * scale + bias[:, None,
                                                                 None]
        p = jax.nn.softmax(logits, axis=-1)
        dp = jnp.einsum("bhqd,bhkd->bhqk", do.astype(jnp.float32),
                        v.astype(jnp.float32))
        return out, vjp(do), jnp.sum(dp * p, axis=-1), jnp.sum(
            jnp.exp(logits - logits.max(-1, keepdims=True)), axis=-1)

    jout, jgrads, jdelta, jl = jax_side(jq, jk, jv, jdo)
    atol, grtol = TOLS[dtype]
    tb = torch.from_numpy(bias)
    out = tfa.full_block_attention_plain(q, k, v, scale=scale, bias=tb)
    assert out.dtype == q.dtype
    _close(out, jout, atol)
    for g, w in zip(tfa.full_block_attention_bwd_plain(
            q, k, v, do, scale=scale, bias=tb), jgrads):
        assert g.dtype == q.dtype
        _close_rel(g, w, grtol)
    l = torch.from_numpy(np.array(jl))
    delta, inv_l = tfa.full_block_attention_delta_plain(do, out, l)
    scale_d = (do.float().abs() * out.float().abs()).sum(-1).max().item()
    _close(delta, jdelta, atol * scale_d)
    _close(inv_l, 1.0 / np.asarray(jl), F32_ATOL)


def test_stream_plain_matches_pallas():
    """#4 (the streaming forward: O and the LSE), the streaming delta
    pre-pass, #5 (dQ) and #6 (dK/dV) in fp16 at S 1100 and D 136 (past
    ``_full_block_fits``; the port's 256 tile), the backward fed the JAX
    forward's O and LSE on both sides."""
    s, d = 1100, 136
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_draw((1, 2, s, d), 4, 5),
                                             "float16")
    bias = _bias(1, s, seed=6)
    scale = d ** -0.5

    @jax.jit
    def jax_side(q, k, v, do):
        out, lse = jfa.stream_fwd_lse(q, k, v, jnp.asarray(bias), scale)
        grads = jfa.stream_bwd(q, k, v, jnp.asarray(bias), do, out, lse,
                               scale)
        delta = jnp.sum(do.astype(jnp.float32) * out.astype(jnp.float32),
                        axis=-1)
        return out, lse, grads, delta

    jout, jlse, jgrads, jdelta = jax_side(jq, jk, jv, jdo)
    assert not tattn.full_block_fits(q.shape, k.shape)
    tb = torch.from_numpy(bias)
    out, lse = tfa.stream_attention_plain(q, k, v, scale=scale, bias=tb)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    _close(out, jout, F16_ATOL)
    _close(lse, jlse, F32_ATOL)
    jo = torch.from_numpy(np.array(jout)).half()
    jl = torch.from_numpy(np.array(jlse))
    delta = tfa._delta(do, jo)
    _close(delta, jdelta, F32_ATOL)
    dq = tfa.stream_attention_bwd_dq_plain(q, k, v, do, jl, delta,
                                           scale=scale, bias=tb)
    dk, dv = tfa.stream_attention_bwd_dkv_plain(q, k, v, do, jl, delta,
                                                scale=scale, bias=tb)
    for g, w in zip((dq, dk, dv), jgrads):
        assert g.dtype == torch.float16
        _close_rel(g, w, F16_GRAD_RTOL)


def _norm_params(d, seed):
    rng = np.random.RandomState(seed)
    return [(m + sd * rng.randn(d)).astype(np.float32)
            for m, sd in ((1, .5), (0, .3), (1, .5), (0, .3))]


def test_qknorm_plain_matches_pallas():
    """#3 (the fused qk-norm forward, ``_fwd_kernel_qknorm``) in fp16 at D
    40 (the port's 64 tile), the norms fp32 on both sides."""
    s, d = 272, 40
    (jq, jk, jv), (q, k, v) = _both(_draw((1, 2, s, d), 3, 9), "float16")
    norms = _norm_params(d, 10)
    bias = _bias(1, s, seed=11)
    scale = d ** -0.5
    want = jax.jit(lambda q, k, v: jfa.flash_attention(
        q, k, v, scale=scale, bias=jnp.asarray(bias),
        qk_norm=tuple(map(jnp.asarray, norms))))(jq, jk, jv)
    got = tfa.full_block_attention_qknorm_plain(
        q, k, v, *map(torch.from_numpy, norms), scale=scale,
        bias=torch.from_numpy(bias))
    assert got.dtype == torch.float16
    _close(got, want, F16_ATOL)


# -- the tile plan -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_tile_plan_covers_every_head_dim(dtype):
    """Every D % 8 == 0 from 8 to 640 runs on the smallest tile >= D of its
    kernel, with a gradient and without (the backward kernels share the
    forward's tiles): the full-block tiles to 128, the streaming tiles to
    640; ``kernel_route`` (on ``meta``, which stands in for the card)
    sends a full-block shape there at D <= 128 and to the streaming
    kernels beyond; D 2056 (past the widest streaming tile, 2048), a D not
    a multiple of 8 and fp64 are refused."""
    for d in range(8, 641, 8):
        want_s = min(t for t in tfa.STREAM_TILES if t >= d)
        assert tfa.tile_plan("stream", dtype, d) == want_s
        want_f = min((t for t in tfa.FULL_BLOCK_TILES if t >= d),
                     default=None)
        assert tfa.tile_plan("full_block", dtype, d) == want_f
        x = torch.empty((2, 2, 260, d), device="meta", dtype=dtype)
        for grad in (False, True):
            assert tfa.takes("stream", x, x, x, grad=grad)
            assert tfa.takes("full_block", x, x, x, grad=grad) == (
                want_f is not None)
        assert tattn.kernel_route(x, x, x) == (
            "full_block" if d <= 128 else "stream")
        g = x.requires_grad_()
        assert tattn.kernel_route(g, g, g) == (
            "full_block" if d <= 128 else "stream")
    for kind in ("full_block", "stream"):
        assert tfa.tile_plan(kind, dtype, 2056) is None
        assert tfa.tile_plan(kind, dtype, 12) is None
        assert tfa.tile_plan(kind, torch.float64, 64) is None
    x = torch.empty((2, 2, 260, 2056), device="meta", dtype=dtype)
    assert tattn.kernel_route(x, x, x) == "plain"


# -- the zero-fill ---------------------------------------------------------------


def _pad(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _ln(x, g, b, eps, d):
    """``qk_layernorm`` (flax fast variance) in x's dtype, as the kernels
    form it on a zero-padded tile: the sums over every column (the padded
    ones add zero) divided by the real head dim ``d``, gamma and beta zero
    past ``d``."""
    mean = x.sum(-1, keepdim=True) / d
    var = torch.clamp((x * x).sum(-1, keepdim=True) / d - mean * mean,
                      min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * g) + b


def _delta_tol(do, out):
    """The delta pre-pass's plain version sums in fp32 whatever the inputs'
    dtype: 1e-6 of the largest row's sum of |dO * O|."""
    return 1e-6 * (do.abs() * out.abs()).sum(-1).max().item()


@pytest.mark.parametrize("kind,d", [("full_block", 40), ("full_block", 72),
                                    ("stream", 136), ("stream", 600)])
def test_zero_filled_tiles_are_exact(kind, d):
    """Each plain version on operands zero-padded to the tile width, cut to
    the first d columns, equals the unpadded call: the forward (and the
    streaming LSE), the backward, the delta pre-pass and (full-block) the
    qk-norm forward with zero-padded norms, whose padded columns stay zero.
    fp64, so only the order of sums differs (the delta's plain version sums
    in fp32: ``_delta_tol``)."""
    tile = tfa.tile_plan(kind, torch.float32, d)
    s = 130
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in _draw((1, 2, s, d), 4, d))
    bias = torch.from_numpy(_bias(1, s, seed=d)).double()
    kw = dict(scale=d ** -0.5, bias=bias)
    pq, pk, pv, pdo = (_pad(x, tile) for x in (q, k, v, do))

    def same(padded, plain):
        assert padded.shape[-1] in (tile, 1)
        if padded.shape[-1] == tile:
            assert padded[..., d:].abs().max().item() == 0
            padded = padded[..., :d]
        assert (padded - plain).abs().max().item() <= F64_ATOL

    if kind == "full_block":
        same(tfa.full_block_attention_plain(pq, pk, pv, **kw),
             tfa.full_block_attention_plain(q, k, v, **kw))
        for a, b in zip(tfa.full_block_attention_bwd_plain(pq, pk, pv, pdo,
                                                           **kw),
                        tfa.full_block_attention_bwd_plain(q, k, v, do,
                                                           **kw)):
            same(a, b)
        out = tfa.full_block_attention_plain(q, k, v, **kw)
        l = torch.rand((1, 2, s), dtype=torch.float64) + 1
        for a, b in zip(tfa.full_block_attention_delta_plain(
                pdo, _pad(out, tile), l),
                tfa.full_block_attention_delta_plain(do, out, l)):
            assert (a - b).abs().max().item() <= _delta_tol(do, out)
        norms = [torch.from_numpy(x).double() for x in _norm_params(d, d)]
        pn = [_pad(x, tile) for x in norms]
        eps = 1e-6
        same(tfa.full_block_attention_plain(
            _ln(pq, pn[0], pn[1], eps, d), _ln(pk, pn[2], pn[3], eps, d),
            pv, **kw),
             tfa.full_block_attention_plain(
            _ln(q, norms[0], norms[1], eps, d),
            _ln(k, norms[2], norms[3], eps, d), v, **kw))
    else:
        po, pl = tfa.stream_attention_plain(pq, pk, pv, **kw)
        out, lse = tfa.stream_attention_plain(q, k, v, **kw)
        same(po, out)
        same(pl, lse)
        pdelta, delta = tfa._delta(pdo, po), tfa._delta(do, out)
        assert (pdelta - delta).abs().max().item() <= _delta_tol(do, out)
        same(tfa.stream_attention_bwd_dq_plain(pq, pk, pv, pdo, lse, delta,
                                               **kw),
             tfa.stream_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                               **kw))
        for a, b in zip(tfa.stream_attention_bwd_dkv_plain(
                pq, pk, pv, pdo, lse, delta, **kw),
                tfa.stream_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   **kw)):
            same(a, b)


# -- the slice: a small flagship in fp16 -----------------------------------------


@pytest.fixture(scope="module")
def pallas_everywhere():
    """Both packages' attention set to ``pallas``, so that the small
    flagship's attentions take the kernels' routes at its small size (the
    Pallas kernels in interpret mode, the port's plain versions of its
    kernels), then restored."""
    jattn.set_default_implementation("pallas")
    tattn.set_default_implementation("pallas")
    try:
        yield
    finally:
        jattn.set_default_implementation("auto")
        tattn.set_default_implementation("auto")


@pytest.fixture(scope="module")
def tiny_f16(pallas_everywhere):
    """(flax module computing in fp16, its perturbed fp32 params, the port's
    module with the same weights in fp16)."""
    jmod, params, tmod = common.tiny_amd()
    port = tamd.AMDModelNew(tmod.cfg, device="cpu", dtype=torch.float16)
    port.load_state_dict(flax_to_torch(params), strict=True)
    return jmod.clone(dtype=jnp.float16), params, port.eval()


def test_flagship_sample_in_fp16_matches_jax(tiny_f16, monkeypatch):
    """``sample`` (2 Euler steps) of the small flagship in fp16: every
    attention on the kernels' routes (full-block, D 8 and 16 on the 32
    tile), the JAX draws replayed into the port."""
    jmod, params, port = tiny_f16
    video, ref, grey, gref = common._clip(10)
    with common.recorded_draws(monkeypatch) as draws:
        want = jamd.sample_jit(jmod, params, jax.random.PRNGKey(4),
                               *map(jnp.asarray, (video, ref, grey, gref)),
                               sample_step=2)
    before = tattn.sdpa_plain.launches
    got = tamd.sample(port, *map(common.t, (video, ref, grey, gref)),
                      sample_step=2, generator=tamd.SampleDraws(replay=draws))
    assert tattn.sdpa_plain.launches == before
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close(g, w, 2e-2)


def test_flagship_loss_and_grads_in_fp16_match_jax(tiny_f16):
    """One training loss and its gradient of the small flagship in fp16
    (the JAX module's compute dtype fp16 over fp32 params; the port's
    weights fp16), the draws injected on both sides."""
    jmod, params, port = tiny_f16
    lat = training._latents(1)
    d = training._draws(2)
    (_, jld), jgrads = training._jax_value_and_grad(jmod, False)(
        params, lat, d.jax_model(False))
    port.zero_grad()
    _, _, ld = port(*(torch.from_numpy(x).half() for x in lat),
                    draws=d.port(False))
    ld["loss"].backward()
    np.testing.assert_allclose(ld["loss"].item(), float(jld["loss"]),
                               rtol=1e-3)
    want = flax_to_torch(jax.device_get(jgrads))
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    g = np.concatenate([_f(got[n]).ravel() for n in sorted(got)])
    w = np.concatenate([_f(want[n]).ravel() for n in sorted(got)])
    assert np.isfinite(g).all()
    assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)
    assert g @ w >= 0.9999 * np.linalg.norm(g) * np.linalg.norm(w)
