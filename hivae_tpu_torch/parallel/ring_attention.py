"""Ring attention: exact SDPA with the sequence sharded over a mesh axis
(port of ``hivae_tpu/parallel/ring_attention.py``).

Each rank of the ring holds one block of queries and one block of keys and
values; the K/V blocks (with their key bias) travel around the ring, one
rotation a hop, and each rank merges its per-hop partial results online.
The whole per-rank computation is one ``torch.autograd.Function``:

* **Forward**: ``n - 1`` rotations of K, V and the bias (the next block is
  posted before the hop runs), each hop giving (out_j, lse_j), merged by
  log-sum-exp weights into an fp32 accumulator that starts at LSE -inf. A
  hop whose block is fully masked has lse_j ~ -1e30 and gets merge weight
  0 (exp(-1e30 - m)).
* **Backward**: re-rotates K, V and the bias from the saved local block
  and computes each hop's exact partial gradients from the *global* LSE
  and delta (the FlashAttention-2 split): dQ accumulates locally in fp32;
  fp32 dK/dV accumulators travel with their block and are home after a
  full cycle of ``n`` rotations (the last one moves dK/dV only).

Hops: the plain hop (``_hop_fwd_plain`` / ``_hop_bwd_plain``: fp32 logits,
softmax and products, the JAX package's einsum hop) and the **kernel hop**
on the port's streaming kernels (``ops/kernels/flash_attention.py``): the
forward is ``stream_attention`` (kernel #4, which returns the LSE), the
backward ``stream_attention_bwd_dq`` / ``stream_attention_bwd_dkv``
(kernels #5, #6) fed the global LSE and a delta computed **once** per ring
backward by ``stream_attention_delta`` from the global output. ``auto``
takes the kernel hop once the local block has ``_FLASH_MIN_LOCAL`` (1024)
tokens, the JAX package's rule, and the kernel takes the operands (on a
CPU tensor always: the kernel hop then runs the kernels' plain versions,
as the JAX tests run the Pallas hop in interpret mode); a call of that size
that the kernel refuses on the card takes the plain hop and counts in
``sdpa_plain.launches`` (``_kernel_hop``). The math runs with autocast
off, as written.

Transport: ``parallel/comm.py``'s ``Ring``, ``batch_isend_irecv`` on the
ring's process group (to rank + 1, from rank - 1): device tensors on NCCL,
pinned host copies on gloo (which cannot send device memory; several
ranks sharing one card run gloo).

``sequence_sharded_sdpa`` is called with the whole q, k, v on every rank
of the ring: outside attention the ranks of a ``tensor`` group compute the
same activations. It takes this rank's chunk of each (whose backward
all-gathers the chunk gradients) and all-gathers the output (whose backward
takes this rank's chunk of the output gradient), so every rank's gradients
come out whole and identical. (``torch.distributed.nn.functional.
all_gather`` is not used: its backward sums over ranks, which would scale
the gradients by the ring size.)
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import sdpa_plain
from ..ops.kernels import flash_attention as fa
from . import comm

NEG_INF = -1e30

# local tokens from which a hop runs the streaming kernels: the JAX
# package's boundary (measured on its TPU), kept for routing parity
_FLASH_MIN_LOCAL = 1024


# -- hops ---------------------------------------------------------------------


def _logits(q, kk, bb, scale):
    s = torch.matmul(q.float(), kk.float().transpose(-1, -2)) * scale
    return s if bb is None else s + bb[:, None, None, :]


def _hop_fwd_plain(q, kk, vv, bb, scale):
    """One plain hop -> (out_j fp32 normalised, lse_j fp32 (B, H, Sq, 1))."""
    s = _logits(q, kk, bb, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vv.float()) / l, m + torch.log(l)


def _hop_bwd_plain(q, kk, vv, bb, g, lse, delta, scale):
    """Exact partial gradients of one visiting block from the global lse
    and delta (B, H, Sq, 1) (summed over the hops they give the full
    gradients)."""
    gf, qf = g.float(), q.float()
    p = torch.exp(_logits(q, kk, bb, scale) - lse)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vv.float().transpose(-1, -2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kk.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq, dk, dv


def _hop_fwd_kernel(q, kk, vv, bb, scale):
    out, lse = fa.stream_attention(q, kk, vv, scale=scale, bias=bb)
    return out.float(), lse


def _hop_bwd_kernel(q, kk, vv, bb, g, lse, delta, scale):
    """The dQ and dK/dV kernels (their plain versions on a CPU tensor,
    where the wrappers raise)."""
    kw = dict(scale=scale, bias=bb)
    cpu = q.device.type == "cpu"
    dq = (fa.stream_attention_bwd_dq_plain if cpu else
          fa.stream_attention_bwd_dq)(q, kk, vv, g, lse, delta, **kw)
    dk, dv = (fa.stream_attention_bwd_dkv_plain if cpu else
              fa.stream_attention_bwd_dkv)(q, kk, vv, g, lse, delta, **kw)
    return dq, dk, dv


def _merge(o_acc, lse_acc, o_j, lse_j):
    m = torch.maximum(lse_acc, lse_j)
    w1 = torch.exp(lse_acc - m)              # 0 at the -inf start
    w2 = torch.exp(lse_j - m)
    denom = w1 + w2
    return (o_acc * w1 + o_j * w2) / denom, m + torch.log(denom)


# -- the ring -----------------------------------------------------------------


def _blocks(k, v, bias):
    """The tensors that travel: K, V and, with a key mask, the bias."""
    return [k, v] if bias is None else [k, v, bias]


def _kvb(blocks):
    """(k, v, bias or None) of a list ``_blocks`` made."""
    return (blocks + [None])[:3]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, ring, use_kernel):
        hop = _hop_fwd_kernel if use_kernel else _hop_fwd_plain
        with torch.autocast(q.device.type, enabled=False):
            b, h, sq, d = q.shape
            o_acc = torch.zeros((b, h, sq, d), dtype=torch.float32,
                                device=q.device)
            lse_acc = torch.full((b, h, sq, 1), float("-inf"),
                                 dtype=torch.float32, device=q.device)
            blocks = _blocks(k, v, bias)
            for i in range(ring.size):
                pending = ring.start(blocks) if i < ring.size - 1 else None
                o_j, lse_j = hop(q, *_kvb(blocks), scale)
                o_acc, lse_acc = _merge(o_acc, lse_acc, o_j, lse_j)
                if pending is not None:
                    blocks = ring.finish(pending)
            out = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, bias, out, lse_acc)
        ctx.scale, ctx.ring, ctx.use_kernel = scale, ring, use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        ring, scale = ctx.ring, ctx.scale
        with torch.autocast(q.device.type, enabled=False):
            g = g.contiguous()
            if ctx.use_kernel:
                hop = _hop_bwd_kernel
                delta = fa.stream_attention_delta(g, out)
            else:
                hop = _hop_bwd_plain
                delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
            dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            dv = torch.zeros_like(dk)
            blocks = _blocks(k, v, bias)
            for i in range(ring.size):
                dq_j, dk_j, dv_j = hop(q, *_kvb(blocks), g, lse, delta,
                                       scale)
                dq += dq_j.float()
                dk += dk_j.float()
                dv += dv_j.float()
                if ring.size == 1:
                    break
                if i < ring.size - 1:
                    *blocks, dk, dv = ring.rotate(blocks + [dk, dv])
                else:   # home again: only dK/dV move on the last rotation
                    dk, dv = ring.rotate([dk, dv])
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


class _Chunk(torch.autograd.Function):
    """Forward: this rank's chunk of ``x`` along ``dim``; backward: the
    all-gather of the ring's chunk gradients."""

    @staticmethod
    def forward(ctx, x, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        n = x.shape[dim] // ring.size
        return x.narrow(dim, ring.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.ring.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Forward: the all-gather of the ring's chunks along ``dim``;
    backward: this rank's chunk of the gradient."""

    @staticmethod
    def forward(ctx, x, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        return comm.all_gather(x, ring.group, dim)

    @staticmethod
    def backward(ctx, g):
        ring, dim = ctx.ring, ctx.dim
        n = g.shape[dim] // ring.size
        return g.narrow(dim, ring.index * n, n).contiguous(), None, None


def _kernel_hop(q_l, k_l, v_l, impl: str) -> bool:
    """True when the ring's hops on these local blocks run the streaming
    kernels: always under "flash", never under "xla"; under "auto" from
    ``_FLASH_MIN_LOCAL`` local tokens where the kernel takes the operands
    (on a CPU tensor always; on the card bf16, fp16 or fp32 at any head
    dim that is a multiple of 8 up to 640, with a gradient or without: an
    fp32 hop takes the fp32 streaming forward, delta, dQ and dK/dV kernels,
    an fp16 hop their fp16 forms, on ``fa.tile_plan``'s tile). An "auto"
    call of that size whose operands the kernel refuses on its device (a
    head dim past 640), where the JAX package runs its Pallas hop, takes
    the plain hop and is counted in ``sdpa_plain.launches``, as ``sdpa``
    counts the calls that no kernel takes."""
    if impl != "auto":
        return impl == "flash"
    if q_l.shape[2] < _FLASH_MIN_LOCAL:
        return False
    if q_l.device.type == "cpu" or fa.takes("stream", q_l, k_l, v_l):
        return True
    sdpa_plain.launches += 1
    return False


class _LocalRing:
    """The ring of one rank: no process group, nothing moves."""

    size, index, group = 1, 0, None

    def start(self, tensors):
        raise AssertionError("a ring of one rank never rotates")


def sequence_sharded_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mesh, axis: str = "tensor",
                          scale: Optional[float] = None,
                          key_mask: Optional[torch.Tensor] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Exact SDPA of q (B, H, Sq, D), k/v (B, H, Sk, D) with both sequence
    dims sharded over ``mesh[axis]``; every rank of the ring passes the
    whole tensors and gets the whole (B, H, Sq, D) output. ``key_mask``:
    optional (B, Sk) bool (True = attend), sharded and rotated with K/V as
    an fp32 bias of -1e30. ``impl``: "flash" (the streaming kernels on
    every hop), "xla" (the plain hop) or "auto" (kernel hops from
    ``_FLASH_MIN_LOCAL`` local tokens where the kernel takes the
    operands). Counts the call in ``sequence_sharded_sdpa.calls`` by hop
    kind."""
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(f"ring impl {impl!r}")
    n = mesh.shape[axis]
    group = mesh.group(axis)
    ring = _LocalRing() if group is None else comm.Ring(group)
    if ring.size != n:
        raise ValueError(f"ring over '{axis}': the process group has "
                         f"{ring.size} ranks, the mesh axis {n}")
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"sequence dims {q.shape[2]}/{k.shape[2]} do not "
                         f"divide the '{axis}' extent {n}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias = None
    if key_mask is not None:
        bias = torch.zeros(key_mask.shape, dtype=torch.float32,
                           device=key_mask.device)
        bias = bias.masked_fill(~key_mask, NEG_INF)
    q_l, k_l, v_l = (_Chunk.apply(x, ring, 2) if n > 1 else x
                     for x in (q, k, v))
    if bias is not None and n > 1:
        bias = _Chunk.apply(bias, ring, 1)
    use_kernel = _kernel_hop(q_l, k_l, v_l, impl)
    sequence_sharded_sdpa.calls["kernel" if use_kernel else "plain"] += 1
    out = _RingAttention.apply(q_l, k_l, v_l, bias, scale, ring, use_kernel)
    return _Gather.apply(out, ring, 2) if n > 1 else out


sequence_sharded_sdpa.calls = {"kernel": 0, "plain": 0}
