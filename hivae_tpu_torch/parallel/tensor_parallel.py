"""Weight tensor parallelism over the mesh's ``tensor`` axis (the port of
the JAX package's ``_TP_RULES`` sharding, ``hivae_tpu/parallel/
sharding.py``, which GSPMD turns into collectives there).

Megatron's pairs, on the blocks that hold the weights the rules name:

  * column parallel: ``to_q``, ``to_k``, ``to_v`` of an ``Attention``,
    ``net.0.proj`` of a ``FeedForward`` and ``fc1`` of an ``Mlp``: each
    rank holds a slice of the output features (whole heads of an
    attention, a slice of the hidden width of an MLP);
  * row parallel: ``to_out.0``, ``net.2`` and ``fc2``: each rank holds the
    matching slice of the input features; the partial products are summed
    over the group in fp32 (``parallel/comm.py::all_reduce_fp32``) and the
    bias, kept whole, is added once after the sum.

So a block costs one sum of its output in the forward and one of its
input's gradient in the backward (``enter``: identity forward, sum
backward). Everything else stays replicated: each rank of a ``tensor``
group holds the same rows and computes the rest of the model alike. A
replicated parameter that a rank applies to its slice only (a column
layer's bias, an attention's per-head q/k LayerNorm) goes through
``enter`` with the block's input, so its gradient is summed over the
group too. The collectives are host-staged on a gloo group
(``parallel/comm.py``) and run inside ``torch.autograd.Function``s, so a
remat recompute runs the forward sum again, on every rank in the same
order.

The sharded weights are DTensors made by ``DTensor.from_local`` (no
collective) on the mesh's ``tensor`` sub-mesh with one ``Shard`` placement,
so ``sharding.gather_to_first``, ``part_of``, ``local`` and FSDP2 take them
as they take FSDP's shards; the blocks compute on ``local(weight)``. An
attention whose head count the extent does not divide (or an MLP whose
width it does not divide) keeps its weights replicated, which is the same
math (``tensor_plan`` lists them).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import comm
from .sharding import infer_param_sharding, local


class _Enter(torch.autograd.Function):
    """Identity forward; backward: the gradients summed over the group
    (in fp32, one buffer)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        live = [i for i, g in enumerate(grads) if g is not None]
        out = list(grads)
        for i, s in zip(live, [] if not live else comm.all_reduce_fp32(
                [grads[i] for i in live], ctx.group)):
            out[i] = s
        return (None,) + tuple(out)


class _Sum(torch.autograd.Function):
    """The sum over the group of each rank's partial product, in fp32;
    backward: identity (each rank's partial took the whole output's
    gradient)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.dtype = x.dtype
        y = x.detach().to(torch.float32, copy=True)
        comm.all_reduce_([y], group)
        return y

    @staticmethod
    def backward(ctx, g):
        return None, g.to(ctx.dtype)


class TensorParallel:
    """This rank's place on one ``tensor`` group: the blocks whose weights
    are split over it hold it as ``.tp`` (None elsewhere)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_group_rank(group, dist.get_rank())

    def enter(self, *xs: Optional[torch.Tensor]):
        """``xs`` as they are (None kept); their gradients are summed over
        the group in the backward."""
        live = [x for x in xs if x is not None]
        it = iter(_Enter.apply(self.group, *live) if live else ())
        return tuple(None if x is None else next(it) for x in xs)

    def part(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's slice of a replicated tensor's dim 0."""
        if t is None:
            return None
        n = t.shape[0] // self.size
        return t[self.rank * n:(self.rank + 1) * n]

    @staticmethod
    def column(lin: nn.Linear, x: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
        """A column-parallel layer: this rank's output features of ``x``
        (``bias`` the entered whole bias, sliced here)."""
        return F.linear(x, local(lin.weight), bias)

    def row(self, lin: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer on this rank's input features ``h``: the
        partial products summed in fp32, the bias added once, in ``h``'s
        dtype."""
        y = _Sum.apply(self.group, F.linear(h, local(lin.weight)))
        if lin.bias is not None:
            y = y + lin.bias.float()
        return y.to(h.dtype)


def _block_layers(mod) -> Optional[Tuple[Tuple[str, ...], str, int]]:
    """(column layer paths, row layer path, the count the extent must
    divide) of a block that weight tensor parallelism splits, else None."""
    from ..models.blocks import Attention, FeedForward, Mlp

    if isinstance(mod, Attention):
        return ("to_q", "to_k", "to_v"), "to_out.0", mod.heads
    if isinstance(mod, FeedForward):
        return ("net.0.proj",), "net.2", mod.net[0].proj.out_features
    if isinstance(mod, Mlp):
        return ("fc1",), "fc2", mod.fc1.out_features
    return None


def tensor_plan(model: nn.Module, size: int
                ) -> Tuple[Dict[str, int], List[str]]:
    """({parameter name: the torch dim it shards on ``tensor``}, [the
    blocks kept replicated because ``size`` does not divide their head
    count or width]) of ``model`` over a ``tensor`` extent ``size``: the
    weights ``infer_param_sharding`` shards on ``tensor``, block by
    block."""
    shards, kept = {}, []
    ext = {"tensor": size}
    for name, mod in model.named_modules():
        layers = _block_layers(mod)
        if layers is None:
            continue
        cols, row, count = layers
        if count % size:
            kept.append(name)
            continue
        for path in cols + (row,):
            pname = f"{name}.{path}.weight" if name else f"{path}.weight"
            w = mod.get_submodule(path).weight
            spec = infer_param_sharding(pname, tuple(w.shape), ext)
            shards[pname] = spec.index("tensor")
    return shards, kept


def shard_tensor(model: nn.Module, mesh) -> List[str]:
    """Split ``model``'s block weights over ``mesh``'s ``tensor`` axis (in
    place: each named weight becomes a DTensor of this rank's slice, and
    each split block gets ``.tp``). Returns the blocks kept replicated."""
    from torch.distributed.tensor import DTensor, Shard

    size = mesh.shape["tensor"]
    shards, kept = tensor_plan(model, size)
    tp = TensorParallel(mesh.group("tensor"))
    tmesh = mesh.submesh(("tensor",))
    for pname, dim in shards.items():
        owner, attr = pname.rsplit(".", 1)
        lin = model.get_submodule(owner)
        whole = getattr(lin, attr)
        part = whole.detach().chunk(size, dim)[tp.rank].contiguous()
        setattr(lin, attr, nn.Parameter(
            DTensor.from_local(part, tmesh, [Shard(dim)], run_check=False),
            requires_grad=whole.requires_grad))
    for name, mod in model.named_modules():
        if _block_layers(mod) is not None and name not in kept:
            mod.tp = tp
    return kept

