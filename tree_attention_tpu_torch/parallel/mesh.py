"""Process group and mesh: one process per rank, SPMD.

Counterpart of ``tree_attention_tpu/parallel/mesh.py``. The JAX package runs
one controller over a named device mesh and lets XLA place the collectives;
the port runs one process per rank (``torchrun``, or any launcher that sets
the environment below), every rank runs the same program on its own shard,
and the collectives are ``torch.distributed`` calls on one process group per
mesh axis.

Only the ``seq`` axis may be larger than 1 here: sharding over ``data`` and
``model`` is a later item of the port (ROADMAP queue A; slice 4b shards the
sequence only). So the ``seq`` group is the whole world.

Environment (read by :func:`initialize_distributed`):

- ``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
- the JAX package's contract: ``TA_COORDINATOR`` (``host:port`` of rank
  0), ``TA_NUM_PROCESSES`` (world size) and ``JAX_PROCESS_INDEX`` (rank).

Device rule: under NCCL rank ``r`` takes ``cuda:LOCAL_RANK`` and a host with
fewer cards than local ranks is an error. Only an explicit gloo backend
lets ranks share a card (``cuda:LOCAL_RANK % device_count``). Nothing falls
back from NCCL to gloo, or from the card to the CPU, on its own.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """This process's place in the job: rank, world size, and its rank and
    the rank count on its own host."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    init_method: Optional[str]  # None: one process, no process group


def dist_info() -> DistInfo:
    """Read the job's shape from the environment (torchrun's variables
    first, then ``TA_COORDINATOR``/``TA_NUM_PROCESSES``/
    ``JAX_PROCESS_INDEX``); a process with neither is rank 0 of 1."""
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        return DistInfo(rank, world, local, local_world,
                        "env://" if world > 1 else None)
    coord = env.get("TA_COORDINATOR")
    if coord is not None:
        missing = [n for n in ("TA_NUM_PROCESSES", "JAX_PROCESS_INDEX")
                   if n not in env]
        if missing:
            raise RuntimeError(
                "TA_COORDINATOR is set but the rest of the contract is "
                f"missing: {missing} (a launcher exports the world size and "
                "this process's rank beside the coordinator address)")
        world = int(env["TA_NUM_PROCESSES"])
        rank = int(env["JAX_PROCESS_INDEX"])
        return DistInfo(rank, world, rank, world,
                        f"tcp://{coord}" if world > 1 else None)
    return DistInfo(0, 1, 0, 1, None)


def rank_device(device: str, backend: str, info: DistInfo) -> torch.device:
    """The device this rank runs on: the CPU, or under NCCL
    ``cuda:LOCAL_RANK`` (a host with fewer cards than local ranks raises),
    or under an explicit gloo backend ``cuda:LOCAL_RANK % device_count``
    (ranks may share a card). Raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; use "
                             "--dist-backend gloo with --device cpu")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: tree_attention_tpu_torch runs on "
            "an NVIDIA GPU by default; pass --device cpu to run the "
            "kernels' plain versions on the CPU")
    n = torch.cuda.device_count()
    if backend == "nccl" and info.local_world_size > n:
        raise RuntimeError(
            f"nccl needs one card per rank: {info.local_world_size} ranks on "
            f"this host, {n} card(s); pass --dist-backend gloo to let ranks "
            "share a card")
    return torch.device("cuda", info.local_rank % n)


def initialize_distributed(backend: str, device: str = "cuda"
                           ) -> tuple[torch.device, bool]:
    """Join the job's process group (a no-op for one process) and pick
    this rank's device by :func:`rank_device`, checked before the group
    forms so that every rank of a bad launch fails alike. Returns
    ``(device, created)``: ``created`` is False when the group already
    existed or the job has one process; the caller that created the group
    destroys it (``dist.destroy_process_group``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    info = dist_info()
    dev = rank_device(device, backend, info)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"a {dist.get_backend()} process group exists; asked for "
                f"{backend}")
        return dev, False
    if info.init_method is None:
        return dev, False
    dist.init_process_group(backend, init_method=info.init_method,
                            rank=info.rank, world_size=info.world_size)
    return dev, True


@dataclasses.dataclass
class Mesh:
    """A named mesh over the job's ranks: ``shape`` maps each axis to its
    size (major to minor), ``coords`` this rank's index on each axis, and
    ``groups`` each axis's process group (None for an axis of size 1,
    which needs no collective)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    rank: int = 0

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis is not None else 1

    def axis_index(self, axis: Optional[str]) -> int:
        return self.coords.get(axis, 0) if axis is not None else 0

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups.get(axis)


def make_mesh(axes: Optional[Mapping[str, int]] = None) -> Mesh:
    """The mesh over this job's ranks; default: every rank on one ``seq``
    axis. ``axes`` maps axis name to size, major to minor; a size of -1
    absorbs the ranks left over. The sizes must multiply to the world size
    (of a formed process group, else 1). Only ``seq`` may exceed 1."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if axes is None:
        axes = {AXIS_SEQ: world}
    names = list(axes)
    sizes = list(axes.values())
    fixed = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if world % fixed:
            raise ValueError(f"{world} ranks do not divide by the fixed "
                             f"axes {dict(axes)}")
        sizes = [world // fixed if s == -1 else s for s in sizes]
    shape = dict(zip(names, sizes))
    total = math.prod(sizes)
    if total != world:
        raise ValueError(
            f"mesh axes {shape} need {total} ranks, the job has {world} "
            f"(launch with torchrun --nproc-per-node {total})")
    wide = [n for n, s in shape.items() if s > 1 and n != AXIS_SEQ]
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} > 1: data and model sharding are a later "
            "item of the port (ROADMAP queue A; slice 4b shards the "
            "sequence axis only)")
    coords, rem = {}, rank
    for name in reversed(names):
        coords[name] = rem % shape[name]
        rem //= shape[name]
    coords = {n: coords[n] for n in names}
    groups = {n: (dist.group.WORLD if shape[n] > 1 else None)
              for n in names}
    return Mesh(shape=shape, coords=coords, groups=groups, rank=rank)


def seq_sharded(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` shards the sequence (its ``seq`` axis exceeds 1)."""
    return mesh is not None and mesh.axis_size(AXIS_SEQ) > 1


def prune_axes(mesh: Optional[Mesh], axes: Mapping[str, Optional[str]]
               ) -> dict:
    """Drop axis names the mesh does not carry (name -> None); with no mesh
    the axes pass through unchanged."""
    if mesh is None:
        return dict(axes)
    return {k: (a if a is not None and a in mesh.shape else None)
            for k, a in axes.items()}


def shard_along(mesh: Mesh, x: torch.Tensor, axis_name: str,
                dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` when ``dim`` is sharded
    over ``axis_name`` (a view; the size must divide)."""
    n = mesh.axis_size(axis_name)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide "
                         f"over {n} '{axis_name}' shards")
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis_name) * step, step)


def check_ranks_agree(digest: int, mesh: Mesh, what: str,
                      axis: str = AXIS_SEQ) -> None:
    """Raise unless every rank on ``axis`` passed the same ``digest``
    (``0 <= digest < 2^63``): one MAX all-reduce of the digest and its
    negation (on the card under NCCL, else on the CPU)."""
    if mesh.axis_size(axis) < 2:
        return
    on = (torch.device("cuda", torch.cuda.current_device())
          if dist.get_backend(mesh.group(axis)) == "nccl"
          else torch.device("cpu"))
    both = torch.tensor([digest, -digest], dtype=torch.int64, device=on)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    if int(both[0]) != digest or int(-both[1]) != digest:
        raise RuntimeError(
            f"rank {mesh.rank}: the ranks hold different {what} (digest "
            f"{digest}, max {int(both[0])}, min {int(-both[1])})")
