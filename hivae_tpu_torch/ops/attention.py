"""Scaled dot-product attention with fp32 logits and softmax (port of
``hivae_tpu/ops/attention.py``, ``auto`` mode).

Dispatch on (B, H, S, D) arrays, the same rule as the JAX package:

  * up to 256^2 logits: the plain path (fp32 logits, softmax, probabilities
    cast to the compute dtype, fp32 accumulation) - the JAX package's XLA
    path; its head packing is an XLA layout trick with the same math and is
    not ported;
  * above: a hand-written kernel (``ops/kernels/flash_attention.py``) - the
    full-block kernel while ``full_block_fits`` holds, the streaming kernel
    beyond it - where that kernel takes the operands (``kernel_route``): on
    a CPU tensor always (the kernels' plain versions take any dtype), on
    the card only in bf16 at the kernel's head dims (an operand whose rows
    the kernel cannot read is copied to a layout it can). Any other call
    above 256^2 logits (fp32, fp16, another head dim) has no kernel here,
    where the TPU kernels take it: it takes the plain path through
    ``sdpa_plain``, which counts it in ``sdpa_plain.launches``.

The (B, Sk) key mask enters the kernels as an additive fp32 bias of
``MASK_NEG``, so a fully masked row degrades to uniform attention over its
keys rather than NaN. The per-head q/k LayerNorm (flax fast variance) is
applied before any kernel, unless ``QKNORM_FUSE`` is True: then, where the
full-block kernel takes the call, q and k go raw with their norm parameters
to the fused qk-norm kernel (``full_block_attention_qknorm``), as the JAX
package's ``_QKNORM_FUSE`` does; everywhere else they are normalised first.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import flash_attention as fa
from .kernels.flash_attention import qk_layernorm

KERNEL_MIN_LOGITS = 256 * 256
MASK_NEG = -1e30
SEQ_ALIGN = 16
MIN_ALIGN = 8

# When True, sdpa folds the per-head q/k LayerNorm into the full-block
# kernel; False (the default, as in the JAX package) normalises q and k
# outside the kernel.
QKNORM_FUSE = False


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


def _kernel_kind(q_shape, k_shape) -> Optional[str]:
    """The kernel the JAX package's rule picks for these shapes, or None
    for its XLA path: None up to 256^2 logits or with D not a multiple of
    8, else "full_block" while ``full_block_fits`` holds and "stream"
    beyond it."""
    if not (q_shape[2] * k_shape[2] > KERNEL_MIN_LOGITS
            and q_shape[3] % MIN_ALIGN == 0):
        return None
    return "full_block" if full_block_fits(q_shape, k_shape) else "stream"


def kernel_route(q: torch.Tensor, k: torch.Tensor,
                 v: Optional[torch.Tensor] = None) -> str:
    """The path ``sdpa`` takes for q (B, H, Sq, D) and k (B, H, Sk, D):
    "full_block", "stream" or "plain". The kernel ``_kernel_kind`` picks,
    on a CPU tensor always (its plain version takes any dtype) and
    elsewhere only where that kernel takes the operands (``fa.takes``:
    dtype and head dim; any layout, which ``sdpa`` copies where the kernel
    cannot read it), else "plain". ``v`` defaults to ``k``'s shape."""
    kind = _kernel_kind(q.shape, k.shape)
    if kind is None:
        return "plain"
    if q.device.type == "cpu" or fa.takes(kind, q, k, k if v is None else v):
        return kind
    return "plain"


def sdpa_plain(q, k, v, scale, key_mask):
    """The plain path for a call above 256^2 logits that no kernel takes on
    its device (fp32, fp16, a head dim off the kernels' lists), where the
    JAX package runs a Pallas kernel: counted in ``sdpa_plain.launches`` as
    the kernel wrappers count their launches, so a run sees attention that
    left the kernels."""
    sdpa_plain.launches += 1
    return _sdpa_plain(q, k, v, scale, key_mask)


sdpa_plain.launches = 0


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         scale: Optional[float] = None,
         key_mask: Optional[torch.Tensor] = None,
         qk_norm: Optional[tuple] = None,
         qk_norm_eps: float = 1e-6) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,H,Sk,D) -> (B,H,Sq,D). ``key_mask`` (B, Sk)
    bool, True = attend. ``qk_norm`` = (gamma_q, beta_q, gamma_k, beta_k),
    each (D,), applied to the raw q and k."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    route = kernel_route(q, k, v)
    bias = None
    if route != "plain":
        q, k, v = (fa.kernel_layout(x) for x in (q, k, v))
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
    if route == "full_block":
        return fa.full_block_attention(q, k, v, scale=scale, bias=bias)
    if route == "stream":
        return fa.stream_attention(q, k, v, scale=scale, bias=bias)[0]
    if _kernel_kind(q.shape, k.shape) is not None:  # no kernel takes it
        return sdpa_plain(q, k, v, scale, key_mask)
    return _sdpa_plain(q, k, v, scale, key_mask)
