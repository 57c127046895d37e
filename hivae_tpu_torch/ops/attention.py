"""Scaled dot-product attention with fp32 logits and softmax (port of
``hivae_tpu/ops/attention.py``, ``auto`` mode).

Dispatch on (B, H, S, D) arrays, the same rule as the JAX package:

  * up to 256^2 logits: the plain path (fp32 logits, softmax, probabilities
    cast to the compute dtype, fp32 accumulation) - the JAX package's XLA
    path; its head packing is an XLA layout trick with the same math and is
    not ported;
  * above: a hand-written kernel (``ops/kernels/flash_attention.py``) - the
    full-block kernel while ``full_block_fits`` holds, the streaming kernel
    beyond it.

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
    kernel = (q.shape[2] * k.shape[2] > KERNEL_MIN_LOGITS
              and q.shape[3] % MIN_ALIGN == 0)
    bias = None
    if kernel and key_mask is not None:
        bias = torch.zeros(key_mask.shape, dtype=torch.float32,
                           device=key_mask.device)
        bias = bias.masked_fill(~key_mask, MASK_NEG)
    fits = kernel and full_block_fits(q.shape, k.shape)
    if qk_norm is not None:
        if fits and QKNORM_FUSE:
            return fa.full_block_attention_qknorm(
                q, k, v, *qk_norm, scale=scale, eps=qk_norm_eps, bias=bias)
        gq, bq, gk, bk = qk_norm
        q = qk_layernorm(q, gq, bq, qk_norm_eps)
        k = qk_layernorm(k, gk, bk, qk_norm_eps)
    if fits:
        return fa.full_block_attention(q, k, v, scale=scale, bias=bias)
    if kernel:
        return fa.stream_attention(q, k, v, scale=scale, bias=bias)[0]
    return _sdpa_plain(q, k, v, scale, key_mask)
