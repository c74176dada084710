"""The (data, model) device mesh and the rows of a batch each rank holds.

Counterpart of ``multimodal_timesfm_tpu/parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` named ``("data", "model")`` over
the initialised process group (``parallel/distributed.py``), one rank per
device:

  * ``data``: batches split over it (each rank a contiguous chunk of dim 0,
    as JAX's ``P("data")`` splits it), gradients summed over it;
  * ``model``: tensor parallelism over the large matmuls
    (``parallel/sharding.py``); model groups are adjacent ranks, as JAX
    reshapes its devices to (dp, mp).

Every rank builds the full host arrays and keeps its own rows
(:func:`local_rows`), so JAX's ``put_global`` has no counterpart. A mesh
without a model axis of its own (``model_parallel=1``) and without a data
axis (``data_parallel=1``) still runs its collectives, over groups of one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh geometry. ``data_parallel=-1`` means "all remaining ranks"."""

    data_parallel: int = -1
    model_parallel: int = 1


def mesh_shape(config: MeshConfig | None, n: int) -> tuple[int, int]:
    """(dp, mp) of ``config`` over ``n`` ranks, with JAX's errors."""
    config = config or MeshConfig()
    mp = config.model_parallel
    if mp < 1:
        raise ValueError(f"model_parallel must be >= 1, got {mp}")
    dp = config.data_parallel if config.data_parallel > 0 else n // mp
    if dp < 1 or dp * mp != n:
        raise ValueError(f"mesh ({dp} data x {mp} model) does not match {n} devices")
    return dp, mp


def require_process_group(what: str) -> None:
    """Raise unless a default process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialised process group: call "
            "parallel.initialize_multihost() (or torch.distributed.init_process_group) first"
        )


def make_mesh(config: MeshConfig | None = None, world_size: int | None = None) -> Any:
    """A 2-D (data, model) ``DeviceMesh`` over the process group's ranks.

    Rank ``r`` sits at (r // mp, r % mp): the ranks of a model group are
    adjacent. ``world_size`` defaults to the group's; another value raises.
    """
    from torch.distributed.device_mesh import init_device_mesh

    require_process_group("make_mesh")
    n = dist.get_world_size()
    if world_size is not None and world_size != n:
        raise ValueError(f"world_size {world_size} does not match the process group's {n} ranks")
    dp, mp = mesh_shape(config, n)
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (dp, mp), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def check_mesh(mesh: Any, what: str) -> None:
    """Raise unless ``mesh`` is None or a (data, model) mesh over an initialised group."""
    if mesh is None:
        return
    require_process_group(f"{what} with a mesh")
    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"{what}: mesh must be a DeviceMesh named ({DATA_AXIS!r}, {MODEL_AXIS!r}) (make_mesh)")


def axis_size(mesh: Any, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_rank(mesh: Any, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def axis_group(mesh: Any, axis: str) -> Any:
    """The process group of this rank's line along ``axis`` (None without a mesh)."""
    return None if mesh is None else mesh.get_group(axis)


def graphs_capture_collectives(mesh: Any) -> bool:
    """Whether a CUDA graph can capture the mesh's collectives on CUDA tensors: NCCL can,
    gloo cannot. True without a mesh (nothing to capture)."""
    if mesh is None:
        return True
    backend = str(dist.get_backend(axis_group(mesh, DATA_AXIS)))
    return backend == "nccl" or "cuda:nccl" in backend


def is_main_rank() -> bool:
    """Rank 0 of the process group, or the only process when there is none: the one that
    writes files."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (nothing without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def pad_to_multiple(n: int, m: int) -> int:
    """Round ``n`` up to a multiple of ``m`` (for batch padding before sharding)."""
    return int(math.ceil(n / m) * m)


def local_rows(x: Any, mesh: Any, axis: str = DATA_AXIS, dim: int = 0) -> Any:
    """The contiguous chunk of dim ``dim`` of ``x`` (an array or tensor) that this rank
    holds along ``axis``; the whole of ``x`` without a mesh. The dim must divide evenly."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n != 0:
        raise ValueError(f"dim {dim} of size {size} does not divide over the {axis} axis of {n} ranks")
    chunk = size // n
    start = axis_rank(mesh, axis) * chunk
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, start, chunk)
    return np.take(x, np.arange(start, start + chunk), axis=dim)


def all_reduce_sum(tensors: list[torch.Tensor], group: Any) -> list[torch.Tensor]:
    """The sums over ``group`` of ``tensors``, as one fp32 all-reduce of their
    concatenation; each comes back in its own dtype and shape."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at : at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_gather_rows(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along dim 0, in rank order."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)
