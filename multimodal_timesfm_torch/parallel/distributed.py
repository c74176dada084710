"""Joining the process group: one process per device, on one host or many.

Counterpart of ``multimodal_timesfm_tpu/parallel/distributed.py``. Where JAX
calls ``jax.distributed.initialize`` once per host, the port calls
``torch.distributed.init_process_group`` once per rank (one rank per
device), then ``parallel.make_mesh`` spans the group. Every rank builds the
full dataset and keeps its own rows (``parallel/mesh.py``).

The arguments come from the caller, else from JAX's environment variables
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
else from ``torch.distributed.run``'s (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). On CUDA the default backend is
``"cpu:gloo,cuda:nccl"``: collectives on CUDA tensors ride NCCL and those on
host tensors gloo. NCCL refuses two ranks on one device, so where
``torch.distributed.run`` starts more ranks on a host (``LOCAL_WORLD_SIZE``)
than it has devices the default is ``"gloo"``, which also carries CUDA
tensors (through the host); other such ranks pass ``backend="gloo"``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from multimodal_timesfm_torch.utils.logging import get_logger

_logger = get_logger()


def _env_int(*names: str) -> int | None:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Initialise the default process group for this rank.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous. On CUDA
    the rank's device is ``cuda:{LOCAL_RANK % device_count}`` (LOCAL_RANK
    defaults to the process id), set before anything else touches the card.
    Raises ``ValueError`` when an argument is neither given nor in the
    environment.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if coordinator_address is None and "MASTER_ADDR" in os.environ:
            coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    missing = [name for name, value in (("coordinator_address", coordinator_address),
                                        ("num_processes", num_processes),
                                        ("process_id", process_id)) if value is None]
    if missing:
        raise ValueError(
            f"initialize_multihost: {', '.join(missing)} neither given nor in the environment "
            "(JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID, or torch.distributed.run's "
            "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK)"
        )
    if torch.cuda.is_available():
        local_rank = _env_int("LOCAL_RANK")
        device = (process_id if local_rank is None else local_rank) % torch.cuda.device_count()
        torch.cuda.set_device(device)
        torch.cuda.init()
        shared = (_env_int("LOCAL_WORLD_SIZE") or 0) > torch.cuda.device_count()
        backend = backend or ("gloo" if shared else "cpu:gloo,cuda:nccl")
    else:
        backend = backend or "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id
    )
    _logger.info(
        "torch.distributed initialized (%s): process %d/%d, %d local device(s)",
        backend, dist.get_rank(), dist.get_world_size(),
        torch.cuda.device_count() if torch.cuda.is_available() else 0,
    )
