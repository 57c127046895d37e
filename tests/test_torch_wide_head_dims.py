"""Head dims past 640 on the CPU: the semantics the wide streaming kernels
(csrc/attn_wide.cuh: a cluster of CTAs along D) are held to on the card,
against the JAX package's Pallas kernels in interpret mode; the flag that
gives a row with no key the full-block kernels' gradient where the JAX rule
runs one; the gate and the launch plans that send every multiple of 8 up
to 2048 to the kernels; the zero-fill of a head dim off its tile; and a
port ``AttentionBlock2D`` at 1024 channels against the JAX module. The
CUDA kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.

Inputs are numpy draws from a seed, rounded to the dtype on both sides.
Tolerances: bf16 ``BF16_ATOL`` 1.6e-2 on outputs of unit scale and
``BF16_GRAD_RTOL`` 2e-2 on gradients relative to the largest element
(bf16's unit in the last place at 1 is 7.8e-3; both sides round P and dS
to bf16 from fp32 sums taken in another order); fp32 ``F32_ATOL`` 1e-4 and
``F32_GRAD_RTOL`` 1e-4 (sums over 300 to 1024 keys and 776 to 1024
columns in another order); the LSE and delta are fp32 (1e-4 of the row's
scale). The zero-fill is checked in fp64, where the padded and unpadded
calls differ only by the order of their sums (1e-12). The attention block:
1e-4 relative (fp32 on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivae_tpu.models import conv_blocks as jconv
from hivae_tpu.ops import attention as jattn
from hivae_tpu.ops.pallas import flash_attention as jfa
from hivae_tpu_torch.models import conv_blocks as tconv
from hivae_tpu_torch.ops import attention as tattn
from hivae_tpu_torch.ops.kernels import flash_attention as tfa
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_amd_family_models import random_params

BF16_ATOL, BF16_GRAD_RTOL = 1.6e-2, 2e-2
F32_ATOL, F32_GRAD_RTOL = 1e-4, 1e-4
F64_ATOL = 1e-12
TOLS = {"bfloat16": (BF16_ATOL, BF16_GRAD_RTOL),
        "float32": (F32_ATOL, F32_GRAD_RTOL)}
WIDE_TILES = (768, 1024, 1280, 1536, 1792, 2048)


def _draw(shape, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _bias(b, sk, seed, keyless):
    """A (B, Sk) additive key mask: batch 0 without any key where
    ``keyless``, every other batch attending to key 0 and ~70% of the
    rest."""
    keep = np.random.RandomState(seed).rand(b, sk) > 0.3
    keep[:, 0] = True
    if keyless:
        keep[0] = False
    return np.where(keep, 0.0, -1e30).astype(np.float32)


def _both(xs, dtype):
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


# -- the plain versions against the Pallas kernels ------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,masked", [(1, 300, False), (2, 288, True)])
def test_plain_matches_pallas_full_block_rule(dtype, b, s, masked):
    """At (1, 2, 300, 776) and (2, 2, 288, 776) the JAX rule runs its
    full-block ``_fwd_kernel`` and ``_bwd_kernel`` (``_full_block_fits``),
    the port its wide streaming kernels on the 1024 tile with the
    full-block flag (``sdpa``'s ``stream_full_block``). The streaming plain
    forward's O against the Pallas forward, the delta pre-pass's function
    against rowsum(dO * O) of the Pallas O, and the plain dQ and dK/dV from
    the port's LSE under ``full_block`` against the Pallas backward; the
    masked case with batch 0 keyless, whose gradient is the uniform
    average's. (Sk 288, a multiple of 16: at a padded Sk the Pallas kernel
    masks its padding keys with the same -1e30 as the key mask, so a
    keyless row averages over the padded length, 1/304 a key at 300; the
    port's kernels and plain versions take 1 / Sk.)"""
    shape = (b, 2, s, 776)
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_draw(shape, 4, 21 + b), dtype)
    bias = _bias(b, s, seed=23, keyless=masked) if masked else None
    scale = shape[3] ** -0.5
    assert tattn.full_block_fits(shape, shape)
    assert tattn.stream_full_block(shape, shape)
    assert tfa.tile_plan("stream", getattr(torch, dtype), 776) == 1024

    @jax.jit
    def jax_side(q, k, v, do):
        jb = None if bias is None else jnp.asarray(bias)
        out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
            q, k, v, scale=scale, bias=jb), q, k, v)
        return out, vjp(do)

    jout, jgrads = jax_side(jq, jk, jv, jdo)
    atol, grtol = TOLS[dtype]
    tb = None if bias is None else torch.from_numpy(bias)
    kw = dict(scale=scale, bias=tb)
    out, lse = tfa.stream_attention_plain(q, k, v, **kw)
    assert out.dtype == q.dtype
    _close(out, jout, atol)
    jo = np.array(jout.astype(jnp.float32))
    _close(tfa._delta(do, torch.from_numpy(jo).to(q.dtype)),
           (np.asarray(jdo.astype(jnp.float32)) * jo).sum(-1),
           1e-4 * max(1.0, (np.abs(_f(do)) * np.abs(jo)).sum(-1).max()))
    delta = tfa._delta(do, out)
    dq = tfa.stream_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                           full_block=True, **kw)
    dk, dv = tfa.stream_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                full_block=True, **kw)
    for g, w in zip((dq, dk, dv), jgrads):
        assert g.dtype == q.dtype
        _close_rel(g, w, grtol)
    if masked:   # the keyless rows' q gets a gradient, as the JAX kernel's
        assert np.abs(_f(dq[0])).max() > 0
        assert np.abs(_f(jgrads[0][0])).max() > 0


@pytest.mark.parametrize("b,masked", [(1, False), (2, True)])
def test_plain_matches_pallas_streaming_rule(b, masked):
    """At (b, 1, 1024, 1024) in fp32 the JAX rule streams (past
    ``_full_block_fits``): ``_stream_fwd_kernel`` (O and the LSE) and
    ``stream_bwd``'s ``_stream_dq_kernel`` and ``_stream_dkv_kernel``, fed
    the JAX forward's O and LSE on both sides, against the port's plain
    versions without the full-block flag; masked with batch 0 keyless,
    where both take P = exp(s - lse) = 1 on every key."""
    shape = (b, 1, 1024, 1024)
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_draw(shape, 4, 31 + b),
                                             "float32")
    bias = _bias(b, 1024, seed=33, keyless=masked) if masked else None
    scale = shape[3] ** -0.5
    assert not tattn.full_block_fits(shape, shape)
    assert not tattn.stream_full_block(shape, shape)

    @jax.jit
    def jax_side(q, k, v, do):
        jb = None if bias is None else jnp.asarray(bias)
        out, lse = jfa.stream_fwd_lse(q, k, v, jb, scale)
        return out, lse, jfa.stream_bwd(q, k, v, jb, do, out, lse, scale)

    jout, jlse, jgrads = jax_side(jq, jk, jv, jdo)
    tb = None if bias is None else torch.from_numpy(bias)
    kw = dict(scale=scale, bias=tb)
    out, lse = tfa.stream_attention_plain(q, k, v, **kw)
    _close(out, jout, F32_ATOL)
    _close(lse, np.asarray(jlse).reshape(lse.shape), F32_ATOL)
    jo = torch.from_numpy(np.array(jout))
    jl = torch.from_numpy(np.array(jlse))
    delta = tfa._delta(do, jo)
    _close(delta, (do * jo).sum(-1), F32_ATOL)
    dq = tfa.stream_attention_bwd_dq_plain(q, k, v, do, jl, delta, **kw)
    dk, dv = tfa.stream_attention_bwd_dkv_plain(q, k, v, do, jl, delta, **kw)
    for g, w in zip((dq, dk, dv), jgrads):
        _close_rel(g, w, F32_GRAD_RTOL)


# -- the full-block flag ------------------------------------------------------


def test_full_block_flag_is_set_where_the_jax_rule_runs_full_block():
    """``sdpa`` sets ``stream_attention``'s ``full_block`` on exactly the
    calls it streams where ``full_block_fits`` holds (so D > 128: the JAX
    rule's full-block kernel, past the port's full-block tiles), under
    ``auto`` and ``pallas``, on ``meta`` tensors that stand in for the card;
    on no call past ``full_block_fits``, and a full-block call never
    streams."""
    seen = []

    def spy(name):
        def fn(q, k, v, *, scale, bias=None, full_block=None):
            seen.append((name, tuple(q.shape), full_block))
            out = torch.empty_like(q)
            return out if name == "full" else (out, None)
        return fn

    cases = [(2, 2, 300, 64), (2, 2, 272, 136), (2, 2, 300, 512),
             (2, 2, 300, 776), (1, 2, 300, 2048), (1, 1, 2048, 136),
             (2, 1, 1024, 512), (1, 1, 1024, 1024), (1, 1, 2048, 64),
             (2, 1, 16, 640)]
    mp = pytest.MonkeyPatch()
    mp.setattr(tfa, "full_block_attention", spy("full"))
    mp.setattr(tfa, "stream_attention", spy("stream"))
    try:
        for impl in ("auto", "pallas"):
            for shape in cases:
                for masked in (False, True):
                    x = torch.empty(shape, device="meta",
                                    dtype=torch.bfloat16)
                    mask = torch.empty(shape[:1] + shape[2:3], device="meta",
                                       dtype=torch.bool) if masked else None
                    seen.clear()
                    tattn.sdpa(x, x, x, key_mask=mask, implementation=impl)
                    kind = tattn._kernel_kind(shape, shape, impl)
                    fits = tattn.full_block_fits(shape, shape)
                    if kind is None:
                        assert seen == [], (shape, impl)
                    elif kind == "full_block":
                        assert seen == [("full", shape, None)]
                    else:
                        assert seen == [("stream", shape,
                                         fits and shape[3] > 128)], shape
    finally:
        mp.undo()
    assert tattn.stream_full_block((2, 2, 300, 776), (2, 2, 300, 776))
    assert not tattn.stream_full_block((2, 2, 300, 64), (2, 2, 300, 64))
    assert not tattn.stream_full_block((1, 1, 2048, 136), (1, 1, 2048, 136))
    assert not tattn.stream_full_block((2, 2, 300, 776), (2, 2, 300, 776),
                                       "xla")


def test_keyless_rule_of_the_plain_backward():
    """The plain streaming backward under ``full_block`` is the full-block
    backward, keyless row included (the autograd of the full-block plain
    forward, and ``full_block_attention_bwd_plain``); without it, the
    keyless row takes P = 1 on every key, and every other row is the
    same. fp64."""
    shape = (2, 2, 40, 24)
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in _draw(shape, 4, 41))
    bias = torch.from_numpy(_bias(2, 40, seed=42, keyless=True)).double()
    kw = dict(scale=0.2, bias=bias)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(tfa.full_block_attention_plain(*ref, **kw),
                               ref, do)
    out, lse = tfa.stream_attention_plain(q, k, v, **kw)
    assert bool((lse[0] <= tfa.KEYLESS_LSE).all())
    assert bool((lse[1] > tfa.KEYLESS_LSE).all())
    full = tfa.stream_attention_bwd_plain(q, k, v, do, out, lse,
                                          full_block=True, **kw)
    stream = tfa.stream_attention_bwd_plain(q, k, v, do, out, lse, **kw)
    for a, f, s, w in zip(auto, full, stream,
                          tfa.full_block_attention_bwd_plain(q, k, v, do,
                                                             **kw)):
        assert (a - f).abs().max().item() <= F64_ATOL
        assert (w - f).abs().max().item() <= F64_ATOL
        assert (s[1] - f[1]).abs().max().item() <= F64_ATOL
        assert (s[0] - f[0]).abs().max().item() > 1e-3
    # the keyless row's P is 1 / Sk under the flag, 1 without
    p = torch.exp(tfa._logits(q, k, 0.2, bias) - lse)
    assert torch.equal(p[0], torch.ones_like(p[0]))


# -- the gate and the launch plans ---------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_every_head_dim_to_2048_takes_the_streaming_kernels(dtype):
    """On ``meta`` (which stands in for the card) every D % 8 == 0 from 648
    to 2048 routes to ``stream``, with a gradient and without, on the tile
    256 * ceil(D / 256); D 2056 routes plain and counts in
    ``sdpa_plain``."""
    for d in range(648, 2049, 8):
        assert tfa.tile_plan("stream", dtype, d) == 256 * -(-d // 256)
        x = torch.empty((1, 1, 300, d), device="meta", dtype=dtype)
        assert tattn.kernel_route(x, x, x) == "stream"
        g = x.requires_grad_()
        assert tattn.kernel_route(g, g, g) == "stream"
        assert tfa.takes("stream", g, g, g, grad=True)
    assert tfa.tile_plan("stream", dtype, 2056) is None
    x = torch.empty((1, 1, 300, 2056), device="meta", dtype=dtype)
    assert tattn.kernel_route(x, x, x) == "plain"
    before = tattn.sdpa_plain.launches
    assert tattn.sdpa(x, x, x).shape == x.shape
    assert tattn.sdpa_plain.launches == before + 1


@pytest.mark.parametrize("d", WIDE_TILES)
def test_wide_plans_fit_a_block(d):
    """Each wide tile's plans (forward, dQ and dK/dV; bf16 and fp16 alike,
    fp32) within 232,448 shared bytes a block and a cluster of at most 8
    CTAs (the portable size), d / 256 CTAs of 256 columns, two slots."""
    plans = [tfa._stream_plan(d), tfa._stream_f32_plan(d),
             tfa._stream_bwd_plan(d), tfa._stream_bwd_f32_plan(d).dq,
             tfa._stream_bwd_f32_plan(d).dkv]
    for plan in plans:
        assert isinstance(plan, tfa.WidePlan)
        assert plan.smem <= tfa.SMEM_PER_BLOCK == 232_448
        assert plan.cluster == d // 256 <= 8
        assert (plan.cols, plan.rows, plan.stages) == (256, 64, 2)
    assert [p.tile for p in plans] == [32, 32, 32, 16, 16]
    assert [p.smem for p in plans] == [127_232, 225_536, 187_392, 227_072,
                                       227_072]


def test_off_tile_head_dim_zero_filled_is_exact():
    """A D-648 call zero-padded to its 768 tile, cut to the first 648
    columns, equals the unpadded call: the forward (O and LSE), delta, and
    dQ and dK/dV under both rules, masked with batch 0 keyless. fp64."""
    d, tile, s = 648, 768, 70
    assert tfa.tile_plan("stream", torch.float32, d) == tile
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in _draw((2, 1, s, d), 4, 51))
    pad = [torch.nn.functional.pad(x, (0, tile - d)) for x in (q, k, v, do)]
    bias = torch.from_numpy(_bias(2, s, seed=52, keyless=True)).double()
    kw = dict(scale=d ** -0.5, bias=bias)

    def same(padded, plain):
        if padded.shape[-1] == tile:
            assert padded[..., d:].abs().max().item() == 0
            padded = padded[..., :d]
        assert (padded - plain).abs().max().item() <= F64_ATOL

    po, pl = tfa.stream_attention_plain(*pad[:3], **kw)
    out, lse = tfa.stream_attention_plain(q, k, v, **kw)
    same(po, out)
    same(pl, lse)
    delta = tfa._delta(do, out)
    assert (tfa._delta(pad[3], po) - delta).abs().max().item() <= 1e-6 * (
        do.abs() * out.abs()).sum(-1).max().item()
    for full in (False, True):
        same(tfa.stream_attention_bwd_dq_plain(*pad, lse, delta,
                                               full_block=full, **kw),
             tfa.stream_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                               full_block=full, **kw))
        for a, b in zip(
                tfa.stream_attention_bwd_dkv_plain(*pad, lse, delta,
                                                   full_block=full, **kw),
                tfa.stream_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   full_block=full, **kw)):
            same(a, b)


# -- a model block at 1024 channels -------------------------------------------


def test_attention_block_at_1024_channels_matches_jax():
    """The port's ``AttentionBlock2D`` at 1024 channels (single-head
    attention, D 1024) over a 16 x 16 map, both packages' attention set to
    ``pallas``: the JAX module runs its full-block Pallas kernels in
    interpret mode, the port its streaming route (the plain versions on
    the CPU) with the full-block flag; the output and the gradients of the
    input and of every weight, through the parameter bridge, fp32."""
    c, hw = 1024, 16
    jmod = jconv.AttentionBlock2D(channels=c)
    x = np.random.RandomState(61).randn(1, hw, hw, c).astype(np.float32)
    g = np.random.RandomState(62).randn(1, hw, hw, c).astype(np.float32)
    params = random_params(jmod, x, seed=63)
    tmod = tconv.AttentionBlock2D(c)
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    jattn.set_default_implementation("pallas")
    tattn.set_default_implementation("pallas")
    try:
        assert tattn.kernel_route(torch.empty((1, 1, hw * hw, c),
                                              device="meta"),
                                  torch.empty((1, 1, hw * hw, c),
                                              device="meta")) == "stream"

        @jax.jit
        def jax_side(p, x):
            y, vjp = jax.vjp(lambda p, x: jmod.apply(p, x), p, x)
            return y, vjp(jnp.asarray(g))

        want, (wp, wx) = jax_side(params, x)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        got = tmod(xt)
        got.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    finally:
        jattn.set_default_implementation("auto")
        tattn.set_default_implementation("auto")
    _close_rel(got.detach().permute(0, 2, 3, 1), want, 1e-4)
    _close_rel(xt.grad.permute(0, 2, 3, 1), wx, 1e-4)
    want_p = flax_to_torch(jax.device_get(wp))
    for name, p in tmod.named_parameters():
        if name == "to_k.bias":
            # a shift of every key by one vector moves a row's logits by one
            # constant: the softmax, and this gradient, are 0 but for
            # rounding on both sides
            scale = np.abs(_f(want_p["to_k.weight"])).max()
            assert np.abs(_f(p.grad)).max() <= 1e-4 * scale
            assert np.abs(_f(want_p[name])).max() <= 1e-4 * scale
            continue
        _close_rel(p.grad, want_p[name], 1e-4)
