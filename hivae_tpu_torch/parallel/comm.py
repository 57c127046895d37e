"""The collectives the port makes itself (the ring's rotations, its
sequence all-gathers, the gradient and metric all-reduces, weight tensor
parallelism's sums, checkpoint gathers), on one process group each.

What moves follows the group's backend: NCCL takes device tensors as they
are; gloo cannot send device memory, so on a gloo group a CUDA tensor goes
through a pinned host copy (as when several ranks share one card, which
NCCL refuses). The choice is made from the backend, never from an error.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist


def _staged(group, x: torch.Tensor) -> bool:
    """True when ``x`` must cross ``group`` through host memory: a CUDA
    tensor on a gloo group."""
    return x.device.type == "cuda" and \
        dist.get_backend(group) == dist.Backend.GLOO


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


# elements of one flat all-reduce buffer (256 MB of fp32)
BUCKET = 1 << 26


def all_reduce_(tensors: Sequence[torch.Tensor], group,
                op=dist.ReduceOp.SUM) -> None:
    """In-place all-reduce of ``tensors`` (one dtype) over ``group``, in
    flat buckets of up to ``BUCKET`` elements (a larger tensor is a bucket
    of its own)."""
    bucket, size = [], 0
    for t in list(tensors) + [None]:
        if bucket and (t is None or size + t.numel() > BUCKET):
            flat = torch.cat([b.reshape(-1) for b in bucket])
            buf = _to_host(flat) if _staged(group, flat) else flat
            dist.all_reduce(buf, op=op, group=group)
            if buf is not flat:
                flat.copy_(buf)
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
            bucket, size = [], 0
        if t is not None:
            bucket.append(t)
            size += t.numel()


def average_(tensors: Sequence[torch.Tensor], group) -> None:
    """In-place mean of ``tensors`` over ``group``: ``all_reduce_``, then
    a division by the group's size."""
    all_reduce_(tensors, group)
    n = dist.get_world_size(group)
    for t in tensors:
        t.div_(n)


def average_metrics(metrics: Dict[str, torch.Tensor], group
                    ) -> Dict[str, torch.Tensor]:
    """Each 0-d metric's mean over ``group`` (None: one rank, the metrics
    as they are), in one all-reduce."""
    if group is None:
        return metrics
    keys = sorted(metrics)
    vals = torch.stack([metrics[k] for k in keys])
    average_([vals], group)
    return dict(zip(keys, vals.unbind()))


def all_reduce_fp32(tensors: Sequence[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """The sums of ``tensors`` (any float dtypes) over ``group``, added in
    fp32 in one flat buffer and returned in each tensor's dtype (new
    tensors; the inputs are left as they are)."""
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    all_reduce_([flat], group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ``group``'s chunks of ``x``, concatenated along ``dim`` in rank
    order."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    src = _to_host(x) if _staged(group, x) else x
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def gather(x: torch.Tensor, group, dst: int, dim: int):
    """The ``group``'s chunks of ``x`` (one shape on every rank),
    concatenated along ``dim`` in rank order on the global rank ``dst``;
    None on the others, which allocate nothing."""
    x = x.contiguous()
    src = _to_host(x) if _staged(group, x) else x
    parts = None
    if dist.get_rank() == dst:
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
    dist.gather(src, parts, dst=dst, group=group)
    return None if parts is None else torch.cat(parts, dim=dim)


class Ring:
    """The ring of a process group: this rank sends to the next rank of
    the group and receives from the previous one."""

    def __init__(self, group):
        self.group = group
        ranks = dist.get_process_group_ranks(group)
        self.size = len(ranks)
        me = ranks.index(dist.get_rank())
        self.index = me
        self.next = ranks[(me + 1) % self.size]
        self.prev = ranks[(me - 1) % self.size]

    def start(self, tensors: Sequence[torch.Tensor]):
        """Post one rotation of ``tensors`` (each contiguous) -> a handle
        for ``finish``, which returns the previous rank's tensors."""
        staged = _staged(self.group, tensors[0])
        sends = [_to_host(t) if staged else t for t in tensors]
        recvs = [torch.empty_like(s) for s in sends]
        ops = []
        for i, (s, r) in enumerate(zip(sends, recvs)):
            ops.append(dist.P2POp(dist.isend, s, self.next, self.group,
                                  tag=i))
            ops.append(dist.P2POp(dist.irecv, r, self.prev, self.group,
                                  tag=i))
        reqs = dist.batch_isend_irecv(ops)
        return reqs, sends, recvs, tensors[0].device

    @staticmethod
    def finish(handle) -> List[torch.Tensor]:
        reqs, _, recvs, device = handle
        for r in reqs:
            r.wait()
        return [r.to(device, non_blocking=False) for r in recvs]

    def rotate(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self.finish(self.start(tensors))
