"""Parameter and batch sharding over the (data, fsdp, tensor) mesh (port of
``hivae_tpu/parallel/sharding.py``).

``infer_param_sharding`` is the JAX package's rule, read on the port's
parameter names and torch layouts: a dense weight is (out, in) here where
the flax kernel is (in, out), a convolution (O, I, kh, kw) where flax has
(kh, kw, I, O), so each rule's dim is mapped through the layout and the
rule runs on the flax shape (the largest-dim choice breaks ties in flax's
dim order, as the JAX rule does).

  * ``tensor`` (with ``mesh["tensor"] > 1``): the Megatron pairs
    ``_TP_RULES`` (q/k/v and FFN-in column parallel, attention-out and
    FFN-out row parallel);
  * ``fsdp`` (with ``mesh["fsdp"] > 1``): the largest still unsharded dim
    that divides, for a parameter of at least ``min_fsdp_size`` elements.

``shard_model`` applies the ``tensor`` part first, where the mesh has
``tensor > 1`` and the model's ``attn_impl`` is not ``ring``:
``parallel/tensor_parallel.py::shard_tensor`` splits the weights the
``_TP_RULES`` name into Megatron column and row parallel layers. Under
``ring`` the ``tensor`` axis carries the ring's sequence instead and the
weights stay replicated over it, the same math as the JAX package's.
Then the ``fsdp`` part, with FSDP2's
``fully_shard`` over the (data, fsdp) sub-mesh (HSDP: replicated on
``data``, sharded on ``fsdp``), one unit each module the model's
``fsdp_units()`` yields (the AMD model: every DiT and motion-encoder
block) and the root; the rule's dim is the shard dim where it picks one,
FSDP2's default (dim 0) elsewhere; a weight already split over ``tensor``
is sharded over (data, fsdp) on top (FSDP2 with tensor parallelism). With
``fsdp == 1`` the parameters stay replicated over (data, fsdp) and the
trainer all-reduces the gradients.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

# (regex over the port's parameter name, flax kernel dim to shard on
# 'tensor'): -1 = output / column parallel, 0 = input / row parallel
_TP_RULES = [
    (r"\bto_q\.weight$", -1),
    (r"\bto_k\.weight$", -1),
    (r"\bto_v\.weight$", -1),
    (r"\bto_out\.0\.weight$", 0),
    (r"\bnet\.0\.proj\.weight$", -1),
    (r"\bnet\.2\.weight$", 0),
    (r"\bfc1\.weight$", -1),
    (r"\bfc2\.weight$", 0),
]

# flax dim of each torch dim, for a dense weight and a convolution's
_FLAX_DIM = {2: (1, 0), 4: (3, 2, 0, 1)}

Spec = Tuple[Optional[str], ...]


def _flax_dims(name: str, ndim: int) -> Tuple[int, ...]:
    """torch dim -> flax dim of the parameter ``name``: a ``.weight`` of 2
    or 4 dims is a flax kernel in another layout, any other parameter has
    the same layout on both sides."""
    if name.endswith(".weight") and ndim in _FLAX_DIM:
        return _FLAX_DIM[ndim]
    return tuple(range(ndim))


def _extents(mesh) -> Mapping[str, int]:
    return getattr(mesh, "shape", mesh)


def infer_param_sharding(name: str, shape: Sequence[int], mesh,
                         min_fsdp_size: int = 2 ** 16) -> Spec:
    """The mesh axis each dim of the parameter ``name`` (torch layout
    ``shape``) shards on, or None: the JAX package's ``infer_param_sharding``
    on the flax layout. ``mesh``: a ``Mesh`` or its axis extents."""
    ext = _extents(mesh)
    tensor_n, fsdp_n = ext.get("tensor", 1), ext.get("fsdp", 1)
    ndim = len(shape)
    to_flax = _flax_dims(name, ndim)
    fshape = [0] * ndim
    for d, fd in enumerate(to_flax):
        fshape[fd] = shape[d]
    spec = [None] * ndim          # over the flax dims

    if tensor_n > 1 and ndim >= 1:
        for pat, dim in _TP_RULES:
            if re.search(pat, name):
                d = dim % ndim
                if fshape[d] % tensor_n == 0:
                    spec[d] = "tensor"
                break

    numel = 1
    for s in shape:
        numel *= s
    if fsdp_n > 1 and numel >= min_fsdp_size:
        for d in sorted(range(ndim), key=lambda d: -fshape[d]):
            if spec[d] is None and fshape[d] % fsdp_n == 0:
                spec[d] = "fsdp"
                break
    return tuple(spec[to_flax[d]] for d in range(ndim))


def batch_rows(mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` over (data, fsdp), the
    counterpart of ``batch_sharding``: ranks of one ``tensor`` group get
    the same rows."""
    dp = mesh.dp_size
    if n % dp:
        raise ValueError(
            f"batch size {n} must be divisible by the data-parallel extent "
            f"{dp} (mesh {dict(mesh.shape)})")
    per = n // dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """FSDP2 over the (data, fsdp) sub-mesh where ``mesh["fsdp"] > 1``
    (in place; returns ``model``), else ``model`` unchanged. The model
    declares its structure: ``model.fsdp_units()`` yields the modules
    sharded as units of their own before the model itself, and
    ``model.fsdp_forward_methods`` names the methods called in place of
    ``forward``, which gather the root's parameters as a forward does.
    First, with ``mesh["tensor"] > 1`` and a model config's ``attn_impl``
    other than ``ring``, the weights are split over ``tensor``
    (``tensor_parallel.shard_tensor``)."""
    impl = getattr(getattr(model, "cfg", None), "attn_impl", "auto")
    if mesh.shape["tensor"] > 1 and impl != "ring":
        from .tensor_parallel import shard_tensor

        shard_tensor(model, mesh)
    if mesh.shape["fsdp"] == 1:
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    names = {id(p): n for n, p in model.named_parameters()}

    def placement(p):
        # the rule on the mesh the weight lives on: a weight split over
        # 'tensor' keeps that dim, a replicated one sees no 'tensor' axis
        split = hasattr(p, "device_mesh")
        ext = dict(mesh.shape, tensor=mesh.shape["tensor"] if split else 1)
        spec = infer_param_sharding(names[id(p)], tuple(p.shape), ext)
        if "fsdp" in spec:
            return Shard(spec.index("fsdp"))
        if split:   # below the rule's size: the dim 'tensor' leaves whole
            return Shard(spec.index(None))
        return None

    dp_mesh = mesh.submesh(("data", "fsdp"))
    for unit in list(model.fsdp_units()) + [model]:
        fully_shard(unit, mesh=dp_mesh, shard_placement_fn=placement)
    from torch.distributed.fsdp import register_fsdp_forward_method

    for name in model.fsdp_forward_methods:
        register_fsdp_forward_method(model, name)
    return model


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t``: a DTensor's local shard (a view, so an
    in-place update changes the DTensor), a plain tensor itself."""
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


def _shards(like):
    """(mesh dim, tensor dim) of each ``Shard`` placement of the DTensor
    ``like``, in mesh-dim order."""
    return [(m, pl.dim) for m, pl in enumerate(like.placements)
            if pl.is_shard()]


def gather_to_first(part: torch.Tensor, like: torch.Tensor
                    ) -> Optional[torch.Tensor]:
    """The whole tensor of which ``part`` is this rank's part in ``like``'s
    layout, on global rank 0 and in host memory where ``like`` is a
    DTensor; None on every other rank. ``like`` plain (replicated):
    ``part`` itself on rank 0 (or a lone process). A ``Shard(d)`` splits
    dim d as ``torch.chunk`` does (every rank ceil(size / n) rows, the last
    ones fewer or none); each shard group gathers to its member on rank
    0's line (``parallel/comm.py``, which follows the group's backend), so
    no other rank ever holds more than its part. Every rank of ``like``'s
    mesh must call it."""
    import torch.distributed as dist

    first = not dist.is_initialized() or dist.get_rank() == 0
    mesh = getattr(like, "device_mesh", None)
    if mesh is None:
        return part if first else None
    coord0 = (mesh.mesh == 0).nonzero()
    if len(coord0) == 0:            # rank 0's line holds another replica
        return None
    coord0, me = coord0[0].tolist(), mesh.get_coordinate()
    shards = _shards(like)
    sharded = {m for m, _ in shards}
    if any(me[m] != coord0[m] for m in range(mesh.ndim) if m not in sharded):
        return None                 # a replica of what rank 0's line holds
    from . import comm

    out = part
    for m, d in reversed(shards):
        group = mesh.get_group(m)
        dst = dist.get_process_group_ranks(group)[coord0[m]]
        n, size = mesh.size(m), like.shape[d]
        chunk = -(-size // n)
        pad = [0, 0] * (out.dim() - d - 1) + [0, chunk - out.shape[d]]
        out = comm.gather(torch.nn.functional.pad(out, pad), group, dst, d)
        if out is None:
            return None
        out = out.narrow(d, 0, size)
    return out.cpu()


def part_of(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``whole`` in ``like``'s layout (the inverse of
    ``gather_to_first``), with no communication: every rank holds
    ``whole``."""
    mesh = getattr(like, "device_mesh", None)
    if mesh is None:
        return whole
    out = whole
    for m, d in _shards(like):
        n, size = mesh.size(m), whole.shape[d]
        chunk = -(-size // n)
        start = min(mesh.get_local_rank(m) * chunk, size)
        out = out.narrow(d, start, min(chunk, size - start))
    return out.contiguous()
