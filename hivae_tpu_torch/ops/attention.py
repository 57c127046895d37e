"""Scaled dot-product attention with fp32 logits and softmax (port of
``hivae_tpu/ops/attention.py``).

``sdpa`` takes an ``implementation`` (default: the process-wide one,
``set_default_implementation``; a model config's ``attn_impl`` through
``install_attn_impl``), as the JAX package's ``sdpa`` does:

  * ``auto`` (the default): up to 256^2 logits the plain path (fp32
    logits, softmax, probabilities cast to the compute dtype, fp32
    accumulation) - the JAX package's XLA path; its head packing is an XLA
    layout trick with the same math and is not ported. Above: a
    hand-written kernel (``ops/kernels/flash_attention.py``) - the
    full-block kernel while ``full_block_fits`` holds and the head dim is
    at most 128 (its widest tile), the streaming kernel beyond either -
    where that kernel takes the operands (``kernel_route``): on a CPU
    tensor always (the kernels' plain versions take any dtype), on the card
    in bf16, fp16 or fp32 at every head dim that is a multiple of 8 up to
    2048, with a gradient or without (``fa.tile_plan``: a head dim runs on
    the smallest tile of its kernel >= it, 32/64/96/128 full-block and
    64/128/256/512/640 streaming, then the multiples of 256 to 2048 on the
    wide streaming kernels, a cluster of CTAs along D; zero-filled past
    it). The kernel's wrapper copies an operand whose rows it cannot read
    to a layout it can. A call above 256^2 logits past D 2048 has no
    kernel here, where the TPU kernels take it: it takes the plain path
    through ``sdpa_plain``, which counts it in ``sdpa_plain.launches``;
  * ``xla``: the plain path, always (never counted: the JAX package runs
    XLA there too);
  * ``pallas``: the kernel ``kernel_route`` picks at any size, even at or
    below 256^2 logits, where one takes the call; else as ``auto``
    (``sdpa_plain`` where a kernel of the JAX package would run);
  * ``ring``: sequence-sharded over the ``tensor`` axis of the mesh that
    ``set_ring_context`` installed (``parallel/ring_attention.py``), with
    the (B, Sk) key mask sharded and rotated with K/V. A call the ring
    cannot shard (no mesh, or a sequence that does not divide by the ring
    size) warns once per shape (``_warn_ring_fallback``) and takes
    ``auto``'s route: the math of the JAX package's XLA fallback, with the
    kernels kept where they take the call.

The (B, Sk) key mask enters the kernels as an additive fp32 bias of
``MASK_NEG``, so a fully masked row degrades to uniform attention over its
keys rather than NaN. Its gradient is that of the uniform average where the
JAX rule runs its full-block kernel, the streaming kernels' otherwise
(``fa.stream_attention``'s ``full_block``). The per-head q/k LayerNorm
(flax fast variance) is applied before any kernel or ring, unless
``QKNORM_FUSE`` is True: then, where the full-block kernel takes the call,
q and k go raw with their norm parameters to the fused qk-norm kernel
(``full_block_attention_qknorm``), as the JAX package's ``_QKNORM_FUSE``
does; everywhere else they are normalised first.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import flash_attention as fa
from .kernels.flash_attention import qk_layernorm

KERNEL_MIN_LOGITS = 256 * 256
MASK_NEG = -1e30
IMPLEMENTATIONS = ("auto", "xla", "pallas", "ring")
SEQ_ALIGN = 16
MIN_ALIGN = 8

# When True, sdpa folds the per-head q/k LayerNorm into the full-block
# kernel; False (the default, as in the JAX package) normalises q and k
# outside the kernel.
QKNORM_FUSE = False

# the process-wide implementation and the ring's mesh and axis, set once by
# the trainer or a CLI and read by every sdpa call (as in the JAX package)
_DEFAULT_IMPL = "auto"
_RING_MESH = None
_RING_AXIS = "tensor"


def set_default_implementation(impl: str) -> None:
    global _DEFAULT_IMPL
    if impl not in IMPLEMENTATIONS:
        raise ValueError(f"attention implementation {impl!r}: want one of "
                         f"{IMPLEMENTATIONS}")
    _DEFAULT_IMPL = impl


def set_ring_context(mesh=None, axis: str = "tensor") -> None:
    """Install (or clear, with ``mesh=None``) the mesh whose ``axis`` the
    ``ring`` implementation shards sequences over. Each rank holds its own
    batch rows, so the JAX package's ``batch_axis`` has no counterpart."""
    global _RING_MESH, _RING_AXIS
    _RING_MESH, _RING_AXIS = mesh, axis


def _ring_applicable(q_shape, k_shape) -> bool:
    """True when the installed ring can shard these shapes: a mesh with a
    ring of more than one rank, and both sequence dims dividing by it."""
    if _RING_MESH is None:
        return False
    size = _RING_MESH.shape.get(_RING_AXIS, 1)
    return size > 1 and not (q_shape[2] % size or k_shape[2] % size)


_warned_ring = set()


def _warn_ring_fallback(q_shape, k_shape) -> None:
    """Warn (once per shape) that a ``ring`` call takes ``auto``'s route."""
    key = (tuple(q_shape), tuple(k_shape), _RING_MESH is None)
    if key in _warned_ring:
        return
    _warned_ring.add(key)
    import warnings

    if _RING_MESH is None:
        warnings.warn(
            "attn_impl='ring' requested but no ring mesh is installed "
            "(set_ring_context/install_attn_impl was never called in this "
            "process); this call takes the 'auto' route.")
    else:
        size = _RING_MESH.shape.get(_RING_AXIS, 1)
        warnings.warn(
            f"attn_impl='ring': sequence dims {q_shape[2]}/{k_shape[2]} "
            f"don't divide the '{_RING_AXIS}' axis size {size}; this call "
            "takes the 'auto' route.")


def install_attn_impl(model_cfg, mesh=None) -> None:
    """Install a model config's ``attn_impl`` process-wide, as the JAX
    package's ``install_attn_impl``. For ``ring`` the ring spans ``mesh``'s
    ``tensor`` axis, by default a mesh of every rank on it ((1, 1, world));
    a ring of one rank warns and installs ``auto``."""
    impl = getattr(model_cfg, "attn_impl", "auto")
    if impl != "ring":
        set_default_implementation(impl)
        return
    if mesh is None:
        import torch.distributed as dist

        from ..parallel.mesh import create_mesh

        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = create_mesh((1, 1, world))
    size = mesh.shape.get(_RING_AXIS, 1)
    if size <= 1:
        import warnings

        warnings.warn(
            "attn_impl='ring' configured but the mesh has no "
            f"'{_RING_AXIS}' extent (shape {dict(mesh.shape)}); using "
            "'auto' attention instead.")
        set_default_implementation("auto")
        return
    set_ring_context(mesh, _RING_AXIS)
    set_default_implementation("ring")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def full_block_fits(q_shape, k_shape) -> bool:
    """The JAX package's full-block vs streaming rule: the single-head
    full-block backward working set (3 fp32 (Sq, Sk) buffers plus operand
    blocks) within 14.5 MB. False at d=512 and 1024 tokens (the SD-VAE
    mid-block) and past ~1024 tokens at d=64."""
    sq, d = q_shape[2], q_shape[3]
    sk = k_shape[2]
    sqp, skp = _round_up(sq, SEQ_ALIGN), _round_up(sk, SEQ_ALIGN)
    worst = 3 * sqp * skp * 4 + (2 * sqp * d + 4 * skp * d) * 4
    return worst <= 14_500_000


def _sdpa_plain(q, k, v, scale, key_mask):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], MASK_NEG)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)


def _kernel_kind(q_shape, k_shape, impl: str = "auto") -> Optional[str]:
    """The kernel the JAX package's rule for ``impl`` picks for these
    shapes, as the port serves it, or None for its XLA path: None under
    ``xla``, up to 256^2 logits under ``auto`` or with D not a multiple of
    8, else "full_block" while ``full_block_fits`` holds and D is at most
    the full-block kernels' widest tile (128), and "stream" beyond either.
    (The JAX rule also sends short sequences at D > 128 to its full-block
    kernel, e.g. (1, 2, 300, 512); the port's streaming kernels compute the
    same function there, a row with no key at all included: ``sdpa`` tells
    their backward so, ``stream_full_block``.)"""
    min_logits = 0 if impl == "pallas" else KERNEL_MIN_LOGITS
    if impl == "xla" or not (q_shape[2] * k_shape[2] > min_logits
                             and q_shape[3] % MIN_ALIGN == 0):
        return None
    if full_block_fits(q_shape, k_shape) and \
            q_shape[3] <= fa.FULL_BLOCK_TILES[-1]:
        return "full_block"
    return "stream"


def stream_full_block(q_shape, k_shape, impl: str = "auto") -> bool:
    """True where ``_kernel_kind`` sends a call to the streaming kernels
    only because its head dim is past the full-block kernels' tiles: the
    JAX rule runs its full-block kernel there, whose softmax gives a row
    with no key the uniform P = 1 / Sk, and ``sdpa`` asks the streaming
    backward for the same (``fa.stream_attention(full_block=True)``)."""
    return (_kernel_kind(q_shape, k_shape, impl) == "stream"
            and full_block_fits(q_shape, k_shape))


def _resolve(implementation: Optional[str]) -> str:
    impl = implementation or _DEFAULT_IMPL
    if impl not in IMPLEMENTATIONS:
        raise ValueError(f"attention implementation {impl!r}: want one of "
                         f"{IMPLEMENTATIONS}")
    return impl


def kernel_route(q: torch.Tensor, k: torch.Tensor,
                 v: Optional[torch.Tensor] = None,
                 implementation: Optional[str] = None) -> str:
    """The path ``sdpa`` takes for q (B, H, Sq, D) and k (B, H, Sk, D)
    under ``implementation`` (default: the installed one): "ring",
    "full_block", "stream" or "plain". ``ring`` where the installed ring
    shards the shapes, else ``auto``'s route. The kernel ``_kernel_kind``
    picks (full-block at D <= 128 while ``full_block_fits``, else
    streaming), on a CPU tensor always (its plain version takes any dtype)
    and elsewhere where that kernel takes the operands (``fa.takes``:
    bf16, fp16 or fp32, with a gradient or without, D a multiple of 8 up to
    2048 on the streaming kernels' tiles 64/128/256/512/640 and the
    multiples of 256 from 768, and up to 128 on the full-block ones'
    32/64/96/128; any layout, which the kernel's wrapper copies where the
    kernel cannot read it), else "plain": past D 2048, or a dtype no kernel
    takes (fp64). ``v`` defaults to ``k``'s shape."""
    impl = _resolve(implementation)
    if impl == "ring":
        if _ring_applicable(q.shape, k.shape):
            return "ring"
        impl = "auto"
    kind = _kernel_kind(q.shape, k.shape, impl)
    if kind is None:
        return "plain"
    if q.device.type == "cpu" or fa.takes(kind, q, k, k if v is None else v):
        return kind
    return "plain"


def sdpa_plain(q, k, v, scale, key_mask):
    """The plain path for a call above 256^2 logits that no kernel takes on
    its device (a head dim past 2048, the streaming kernels' widest tile,
    or a dtype other than bf16, fp16 and fp32; every multiple of 8 up to
    2048 in those three takes a kernel), where the JAX package runs a
    Pallas kernel: counted in ``sdpa_plain.launches`` as the kernel
    wrappers count their launches, so a run sees attention that left the
    kernels."""
    sdpa_plain.launches += 1
    return _sdpa_plain(q, k, v, scale, key_mask)


sdpa_plain.launches = 0


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         scale: Optional[float] = None,
         key_mask: Optional[torch.Tensor] = None,
         implementation: Optional[str] = None,
         qk_norm: Optional[tuple] = None,
         qk_norm_eps: float = 1e-6) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,H,Sk,D) -> (B,H,Sq,D). ``key_mask`` (B, Sk)
    bool, True = attend. ``implementation``: "auto", "xla", "pallas" or
    "ring" (default: the installed one). ``qk_norm`` = (gamma_q, beta_q,
    gamma_k, beta_k), each (D,), applied to the raw q and k."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    impl = _resolve(implementation)
    route = kernel_route(q, k, v, impl)
    if impl == "ring" and route != "ring":
        _warn_ring_fallback(q.shape, k.shape)
        impl = "auto"
    bias = None
    if route in ("full_block", "stream"):
        if key_mask is not None:
            bias = torch.zeros(key_mask.shape, dtype=torch.float32,
                               device=key_mask.device)
            bias = bias.masked_fill(~key_mask, MASK_NEG)
    if qk_norm is not None:
        if route == "full_block" and QKNORM_FUSE:
            return fa.full_block_attention_qknorm(
                q, k, v, *qk_norm, scale=scale, eps=qk_norm_eps, bias=bias)
        gq, bq, gk, bk = qk_norm
        q = qk_layernorm(q, gq, bq, qk_norm_eps)
        k = qk_layernorm(k, gk, bk, qk_norm_eps)
    if route == "ring":
        from ..parallel.ring_attention import sequence_sharded_sdpa

        return sequence_sharded_sdpa(q, k, v, _RING_MESH, _RING_AXIS,
                                     scale=scale, key_mask=key_mask)
    if route == "full_block":
        return fa.full_block_attention(q, k, v, scale=scale, bias=bias)
    if route == "stream":
        return fa.stream_attention(
            q, k, v, scale=scale, bias=bias,
            full_block=stream_full_block(q.shape, k.shape, impl))[0]
    if _kernel_kind(q.shape, k.shape, impl) is not None:  # no kernel takes it
        return sdpa_plain(q, k, v, scale, key_mask)
    return _sdpa_plain(q, k, v, scale, key_mask)
