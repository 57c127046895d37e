"""The (data, fsdp, tensor) mesh of ranks (port of
``hivae_tpu/parallel/mesh.py``).

The JAX package puts every parallelism axis on one ``jax.sharding.Mesh``
over all chips and lets GSPMD emit the collectives. Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one rank a card, with the same three axes:

  * ``data``: batch rows (data parallelism);
  * ``fsdp``: batch rows too, and the parameters and optimizer state
    sharded over it (FSDP2; ``parallel/sharding.py``);
  * ``tensor``: the sequence of ring attention
    (``parallel/ring_attention.py``); the ranks of one ``tensor`` group
    hold the same rows and the same weights.

Ranks are laid out row-major, as ``init_device_mesh`` lays them: rank =
(d * fsdp + f) * tensor + t, so a ``tensor`` group is consecutive ranks.

``init_distributed`` starts the process group from the launcher's
environment: ``HIVAE_MULTIHOST=1`` with ``HIVAE_COORDINATOR`` (host:port),
``HIVAE_NUM_PROCESSES`` and ``HIVAE_PROCESS_ID`` (the JAX CLI's variables),
or ``torchrun``'s ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` with
``MASTER_ADDR``/``MASTER_PORT``. The backend is the caller's: NCCL on CUDA
and gloo on the CPU by default, never switched on a failure.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "tensor")


def launched() -> bool:
    """True when the environment describes a multi-process launch
    (``HIVAE_MULTIHOST=1``, or ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE``)."""
    return (os.environ.get("HIVAE_MULTIHOST") == "1" or
            ("RANK" in os.environ and "WORLD_SIZE" in os.environ))


def init_distributed(backend: Optional[str] = None,
                     device: Optional[str] = None
                     ) -> Tuple[int, int, torch.device]:
    """Start the default process group from the launch environment ->
    (rank, world size, this rank's device). ``device`` is ``"cuda"`` (the
    default: ``cuda:LOCAL_RANK``, made current) or ``"cpu"``; ``backend``
    defaults to NCCL on CUDA and gloo on the CPU. With ``HIVAE_MULTIHOST=1``
    and ``HIVAE_COORDINATOR`` unset, ``torchrun``'s variables are read."""
    dev_type = torch.device(device or "cuda").type
    if dev_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: CUDA asked for and no GPU is "
                           "available; pass device='cpu' to run on the CPU")
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    env = os.environ
    if env.get("HIVAE_MULTIHOST") == "1" and env.get("HIVAE_COORDINATOR"):
        init = f"tcp://{env['HIVAE_COORDINATOR']}"
        world = int(env["HIVAE_NUM_PROCESSES"])
        rank = int(env["HIVAE_PROCESS_ID"])
    elif "RANK" in env and "WORLD_SIZE" in env:
        init, rank, world = "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        raise RuntimeError(
            "init_distributed: no launch found: set HIVAE_MULTIHOST=1 with "
            "HIVAE_COORDINATOR, HIVAE_NUM_PROCESSES and HIVAE_PROCESS_ID, or "
            "start the processes with torchrun")
    local_rank = int(env.get("LOCAL_RANK", 0))
    dev = torch.device(dev_type, local_rank) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return rank, world, dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, fsdp, tensor) mesh of ranks: ``shape`` maps each axis to
    its extent (as ``dict(jax_mesh.shape)``), ``device_mesh`` is the
    ``DeviceMesh`` over the process group (None for a one-rank mesh with
    no process group), ``dp_group`` the group of the ranks that share this
    rank's ``tensor`` index (the (data, fsdp) ranks that reduce
    gradients; None with one such rank)."""

    shape: Dict[str, int]
    device_mesh: Optional[object] = None
    dp_group: Optional[object] = None

    @property
    def size(self) -> int:
        n = 1
        for a in AXES:
            n *= self.shape[a]
        return n

    @property
    def dp_size(self) -> int:
        """Ranks that hold distinct batch rows: data * fsdp."""
        return self.shape["data"] * self.shape["fsdp"]

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    @property
    def dp_index(self) -> int:
        """This rank's index among the ``dp_size`` row shards (data-major,
        as ``batch_sharding`` lays the batch over ("data", "fsdp"))."""
        return self.coordinate("data") * self.shape["fsdp"] + \
            self.coordinate("fsdp")

    def group(self, axis: str):
        """The process group of this rank's ``axis`` line (None on a
        one-rank mesh)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def submesh(self, axes: Sequence[str]):
        """The ``DeviceMesh`` over ``axes`` that holds this rank."""
        return self.device_mesh[tuple(axes)]

    @property
    def is_first(self) -> bool:
        """True on the rank that writes files: global rank 0, or the one
        rank of a mesh without a process group."""
        return self.device_mesh is None or dist.get_rank() == 0


def _device_type() -> str:
    """The device type the process group's ranks compute on: CUDA when a
    card is current in this process, else the CPU."""
    return "cuda" if torch.cuda.is_available() and \
        torch.cuda.is_initialized() else "cpu"


def create_mesh(shape: Optional[Tuple[int, int, int]] = None,
                device_type: Optional[str] = None) -> Mesh:
    """The mesh over every rank of the process group. ``shape=None``: all
    ranks on ``data`` (pure data parallelism, the JAX package's default).
    A shape must multiply to the world size; without a process group the
    world is one rank (``local_mesh``). ``device_type`` ("cuda" or "cpu")
    defaults to CUDA when this process has a current card."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world, 1, 1)
    shape = tuple(int(x) for x in shape)
    if len(shape) != len(AXES) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape}: want three positive extents "
                         f"for {AXES}")
    n = shape[0] * shape[1] * shape[2]
    if n != world:
        raise ValueError(f"mesh {shape} has {n} ranks; the process group has "
                         f"{world}")
    if world == 1:
        return local_mesh()
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type or _device_type(), shape,
                          mesh_dim_names=AXES)
    dp_group = None
    if shape[0] * shape[1] > 1:
        # one (data, fsdp) group a tensor index; every rank creates every
        # group, in the same order, as new_group requires
        t = shape[2]
        for ti in range(t):
            ranks = list(range(ti, world, t))
            g = dist.new_group(ranks)
            if dist.get_rank() % t == ti:
                dp_group = g
    return Mesh(dict(zip(AXES, shape)), dm, dp_group)


def local_mesh() -> Mesh:
    """The one-rank mesh: no process group, every extent 1."""
    return Mesh(dict.fromkeys(AXES, 1))
