"""The long tail's ops against the JAX package on the CPU: the Haar
wavelet, the rest of the frequency module, RoPE, the quality metrics, and
the kernels as ``torch.library`` custom ops (each op's fake against its
CPU implementation, the plain version). fp32 throughout: 1e-5 where both
sides do the same arithmetic, 2e-4 where the sums run in another order
over a network (LPIPS, SSIM's blur, RoPE attention), as the model tests
hold them; the FFT split 1e-4, as ``test_torch_ops.py`` holds it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from hivae_tpu.losses import LPIPS as JLPIPS
from hivae_tpu.ops import frequency as jfreq
from hivae_tpu.ops import rope as jrope
from hivae_tpu.ops import wavelet as jwav
from hivae_tpu.utils import metrics as jmetrics
from hivae_tpu_torch.losses.lpips import LPIPS, lpips_state
from hivae_tpu_torch.ops import attention as tattn
from hivae_tpu_torch.ops import frequency as tfreq
from hivae_tpu_torch.ops import rope as trope
from hivae_tpu_torch.ops import wavelet as twav
from hivae_tpu_torch.ops.kernels import flash_attention as tfa
from hivae_tpu_torch.ops.kernels import quant_ffn as tqf
from hivae_tpu_torch.utils import metrics as tmetrics
from hivae_tpu_torch.utils.params import lpips_flax_to_torch

TOL = dict(atol=1e-5, rtol=1e-5)
NET_TOL = dict(atol=2e-4, rtol=2e-4)


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def numpy_tree(shapes, seed):
    """A parameter tree of ``jax.eval_shape``'s shapes filled by numpy."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: (0.2 * rng.randn(*s.shape)).astype(np.float32), shapes)


# -- wavelet -------------------------------------------------------------------


def test_dwt2_and_its_inverse_match_jax():
    x = rand(2, 3, 8, 12)
    want = jwav.dwt2(jnp.asarray(x))
    got = twav.dwt2(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    stacked = np.concatenate([np.asarray(w) for w in want], axis=0)
    np.testing.assert_allclose(twav.iwt2(torch.from_numpy(stacked)).numpy(),
                               np.asarray(jwav.iwt2(jnp.asarray(stacked))),
                               **TOL)
    back = twav.iwt2_from_bands(*got)
    np.testing.assert_allclose(back.numpy(), x, **TOL)


# -- frequency -----------------------------------------------------------------


@pytest.mark.parametrize("d_s,d_t", [(0.25, 0.25), (0.5, 0.3)])
def test_freq_3d_filter_matches_jax(d_s, d_t):
    x = rand(2, 3, 4, 8, 6, seed=1)
    lpf = np.asarray(jfreq.gaussian_low_pass_filter(x.shape, d_s, d_t))
    want = jfreq.freq_3d_filter(jnp.asarray(x), jnp.asarray(lpf))
    mask = tfreq.gaussian_low_pass_filter(x.shape, d_s, d_t)
    np.testing.assert_array_equal(mask.numpy(), lpf)
    got = tfreq.freq_3d_filter(torch.from_numpy(x), mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("length,window,stride", [(16, 16, 4), (40, 16, 4),
                                                  (33, 8, 5)])
def test_views_and_weights_match_jax(length, window, stride):
    assert tfreq.get_views(length, window, stride) == \
        jfreq.get_views(length, window, stride)
    for n in (1, 4, 7):
        assert tfreq.generate_weight_sequence(n) == \
            jfreq.generate_weight_sequence(n)


# -- RoPE ----------------------------------------------------------------------


def test_rope_tables_and_rotation_match_jax():
    cos, sin = trope.precompute_freqs_cis(8, 12)
    jcos, jsin = jrope.precompute_freqs_cis(8, 12)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    q, k = rand(2, 12, 3, 8, seed=2), rand(2, 12, 3, 8, seed=3)
    want = jrope.apply_rotary_emb(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    got = trope.apply_rotary_emb(torch.from_numpy(q), torch.from_numpy(k),
                                 cos, sin)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("s", [12, 300])
def test_rope_attention_matches_jax(s):
    """Below and above 256^2 logits (the port's kernel route on the CPU:
    its plain version)."""
    q, k, v = (rand(1, s, 2, 16, seed=i) for i in (4, 5, 6))
    want = jrope.rope_attention(*(jnp.asarray(x) for x in (q, k, v)))
    got = trope.rope_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)


# -- metrics -------------------------------------------------------------------


def test_psnr_and_ssim_match_jax():
    pred = np.tanh(rand(2, 3, 3, 24, 20, seed=7))
    gt = np.clip(pred + 0.1 * rand(2, 3, 3, 24, 20, seed=8), -1, 1)
    for fn in ("psnr", "ssim"):
        want = float(getattr(jmetrics, fn)(jnp.asarray(pred),
                                           jnp.asarray(gt)))
        got = float(getattr(tmetrics, fn)(torch.from_numpy(pred),
                                          torch.from_numpy(gt)))
        assert abs(got - want) <= 2e-4 * abs(want), (fn, got, want)
    same = torch.from_numpy(pred)
    assert float(tmetrics.ssim(same, same)) == pytest.approx(1.0, abs=1e-5)


def test_lpips_distance_matches_jax():
    """Over the port's ``losses/lpips.py`` with the JAX tree bridged; both
    clip layouts (N, F, C, H, W) and NCHW."""
    pred = np.tanh(rand(1, 2, 3, 32, 32, seed=9))
    gt = np.tanh(rand(1, 2, 3, 32, 32, seed=10))
    model = JLPIPS()
    x = jnp.zeros((1, 3, 32, 32))
    params = numpy_tree(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                       x, x), seed=11)
    want = float(jax.jit(lambda p, a, b: jmetrics.lpips_distance(
        model, p, a, b))(params, jnp.asarray(pred), jnp.asarray(gt)))
    tmod = LPIPS().eval()
    tmod.load_state_dict(lpips_flax_to_torch(params), strict=True)
    with torch.no_grad():
        got = float(tmetrics.lpips_distance(tmod, torch.from_numpy(pred),
                                            torch.from_numpy(gt)))
        flat = float(tmetrics.lpips_distance(
            tmod, torch.from_numpy(pred[0]), torch.from_numpy(gt[0])))
    assert abs(got - want) <= 2e-4 * abs(want), (got, want)
    assert flat == got


def test_lpips_state_maps_torchvision_and_head_names():
    tmod = LPIPS()
    own = tmod.state_dict()
    vgg = {k[len("net."):]: v for k, v in own.items() if k.startswith("net.")}
    vgg["classifier.0.weight"] = torch.zeros(2)
    head = {f"lin{k}.model.1.weight": own[f"lin{k}.weight"]
            for k in range(5)}
    state = lpips_state(vgg, head)
    assert set(own) <= set(state)
    assert set(state) - set(own) == {"net.classifier.0.weight"}


# -- the custom ops ------------------------------------------------------------


def _attention_args(dtype, sq=40, sk=52, d=64, bias=True):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 3, sq, d), generator=g).to(dtype)
    k, v = (torch.randn((2, 3, sk, d), generator=g).to(dtype)
            for _ in range(2))
    b = torch.where(torch.rand((2, sk), generator=g) > 0.2, 0.0,
                    -1e30) if bias else None
    return q, k, v, b


def _norms(d=64):
    g = torch.Generator().manual_seed(1)
    return [1 + 0.1 * torch.randn(d, generator=g) for _ in range(4)]


OP_CASES = {
    "full_block_attention": lambda dtype: (
        *_attention_args(dtype), 0.125),
    "full_block_attention_qknorm": lambda dtype: (
        *_attention_args(dtype)[:3], *_norms(), _attention_args(dtype)[3],
        0.125, 1e-6),
    "stream_attention": lambda dtype: (*_attention_args(dtype), 0.125),
}


def _same_meta(fake, real):
    assert fake.shape == real.shape and fake.dtype == real.dtype
    assert fake.stride() == real.stride()


@pytest.mark.parametrize("name", sorted(OP_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_op_fake_matches_cpu_implementation(name, dtype):
    """The op's CPU implementation is its plain version; its fake gives
    the same shapes, dtypes and strides; ``torch.library.opcheck`` holds
    its schema and fake against the real call."""
    op = getattr(torch.ops.hivae, name)
    args = OP_CASES[name](dtype)
    real = op(*args)
    plain = getattr(tfa, name + "_plain")
    kw = dict(scale=0.125)
    if name == "full_block_attention_qknorm":
        want = plain(*args[:7], bias=args[7], eps=args[9], **kw)
    else:
        want = plain(*args[:3], bias=args[3], **kw)
    for r, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (real, want))):
        assert torch.equal(r, w)
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if torch.is_tensor(a) else a
                 for a in args]
        fake = op(*fargs)
    for f, r in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (fake, real))):
        _same_meta(f, r)
    torch.library.opcheck(op, args, test_utils=("test_schema",
                                                "test_faketensor"))


def test_ffn_op_fake_matches_cpu_implementation():
    g = torch.Generator().manual_seed(2)
    m, k, n = 5, 128, 256
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    sx = torch.rand((m, 1), generator=g) / 100
    w8 = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    ws, bias = torch.rand(n, generator=g) / 100, torch.randn(n, generator=g)
    args = (xq, sx, w8, ws, bias)
    real = torch.ops.hivae.ffn_up_quant(*args)
    want = tqf.fused_ffn_up_quant_plain(*args)
    assert all(torch.equal(r, w) for r, w in zip(real, want))
    with FakeTensorMode() as mode:
        fake = torch.ops.hivae.ffn_up_quant(*(mode.from_tensor(a)
                                               for a in args))
    for f, r in zip(fake, real):
        _same_meta(f, r)
    torch.library.opcheck(torch.ops.hivae.ffn_up_quant, args,
                          test_utils=("test_schema", "test_faketensor"))


def test_fake_gives_the_kernels_layout_on_the_card():
    """On a fake CUDA tensor (what ``torch.export`` traces with on the
    card) each attention op's fake output has the kernels' (B, Sq, H, D)
    storage, as the launch allocates it; no card is needed."""
    from torch._subclasses.fake_tensor import FakeTensor

    mode = FakeTensorMode()
    shape = (2, 3, 40, 64)
    x = FakeTensor(mode, torch.empty(shape, dtype=torch.bfloat16,
                                     device="meta"), torch.device("cuda"))
    want = torch.empty((2, 40, 3, 64)).transpose(1, 2).stride()
    with mode:
        for out in (torch.ops.hivae.full_block_attention(x, x, x, None, 0.1),
                    torch.ops.hivae.stream_attention(x, x, x, None, 0.1)[0]):
            assert out.device.type == "cuda" and out.shape == shape
            assert out.stride() == want


def test_no_grad_calls_go_through_the_ops_and_grad_calls_do_not():
    """Without a gradient the wrappers dispatch the custom op (so
    ``torch.export`` records it); with one on the CPU they run the plain
    version, which autograd differentiates, and give the same values."""
    q, k, v, b = _attention_args(torch.float32, sq=30, sk=30, d=32)

    class M(torch.nn.Module):
        def forward(self, q, k, v):
            return tattn.sdpa(q, k, v, implementation="pallas")

    with torch.no_grad():
        ep = torch.export.export(M(), (q, k, v))
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert "hivae.full_block_attention.default" in ops
    qg = q.clone().requires_grad_()
    out = tfa.full_block_attention(qg, k, v, scale=0.125, bias=b)
    out.sum().backward()
    assert qg.grad is not None
    np.testing.assert_allclose(
        out.detach().numpy(),
        tfa.full_block_attention(q, k, v, scale=0.125, bias=b).numpy(),
        **TOL)


# keys a K or V tile of the fp32 streaming forward at each head dim, as its
# source note (csrc/flash_stream.cu) states them
F32_TILES = {64: 32, 128: 32, 256: 32, 512: 16, 640: 8}


@pytest.mark.parametrize("d", tfa.STREAM_TILES)
def test_stream_f32_plan_fits_a_block(d):
    """The fp32 streaming forward's plan at every streaming head dim: 64
    query rows a CTA and two slots of the K/V tile the source note states
    (rows d + 4 floats apart, each with its bias row), beside the Q tile,
    the exchange of partial scores, P and the rescale factors, within the
    card's shared memory a block; below the 32-key cap, a tile of twice
    the keys would not fit. Past D 640, the wide forward's: a cluster of
    d / 256 CTAs of 256 columns (rows 260 floats apart), 64 query rows,
    two slots of a 32-key K and V tile and its bias row, two buffers of the
    64 x 32 partial scores and the summed tile (rows 36 floats apart)."""
    plan = tfa._stream_f32_plan(d)
    if d > tfa.STREAM_NARROW_MAX:
        assert (plan.cluster, plan.cols, plan.rows, plan.stages,
                plan.tile) == (d // 256, 256, 64, 2, 32)
        assert plan.smem == (64 * 260 + 2 * (2 * 32 * 260 + 32)
                             + 2 * 64 * 32 + 64 * 36) * 4 == 225_536
        assert plan.smem <= tfa.SMEM_PER_BLOCK
        return
    assert (plan.rows, plan.stages, plan.tile) == (64, 2, F32_TILES[d])
    assert plan.smem == (64 * (d + 4) + 2 * plan.tile * (d + 5)
                         + (256 + 64) * plan.tile + 64) * 4
    assert plan.smem <= tfa.SMEM_PER_BLOCK
    if plan.tile < 32:
        assert tfa._stream_f32_smem(d, 2 * plan.tile) > tfa.SMEM_PER_BLOCK


def test_tf32_split_meets_the_fp32_gate():
    """Why the fp32 streaming kernel takes three TF32 products: with its
    split (hi by ``tf32_rna``, the bits of ``cvt.rna.tf32.f32``, ties away
    from zero; lo = x - hi as the tensor core reads it, ``tf32_rz``) in both
    Q.K^T and P.V, attention at D 512 over 1024 keys of N(0, 1) is within
    the fp32 gate (1e-5) of an fp64 reference; with one TF32 product it is
    not."""
    one = 1.0 + 2.0 ** -11   # halfway between two TF32 values
    below = np.nextafter(np.float32(one), np.float32(0))
    x = torch.tensor([one, -one, below, 3.0],
                     dtype=torch.float32)
    assert tfa.tf32_rna(x).tolist() == [1 + 2.0 ** -10, -1 - 2.0 ** -10,
                                        1.0, 3.0]
    assert tfa.tf32_rz(x).tolist() == [1.0, -1.0, 1.0, 3.0]
    rng = np.random.RandomState(61)
    q, k, v = (torch.from_numpy(rng.randn(1024, 512).astype(np.float32))
               for _ in range(3))
    scale = 512 ** -0.5

    def attend(mm, q, k, v):
        s = mm(q, k.T) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return mm(p, v) / p.sum(-1, keepdim=True)

    want = attend(torch.matmul, q.double(), k.double(), v.double())

    def err(products):
        got = attend(lambda a, b: tfa.tf32_matmul(a, b, products), q, k, v)
        return (got.double() - want).abs().max().item()
    assert err(3) <= 1e-5 < err(1)
