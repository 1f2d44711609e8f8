"""Multi-process initialization and meshes over processes (port of the
JAX package's ``parallel/multihost.py``).

One process drives the devices of its host (``parallel/mesh.py``).
Beyond one process, ``torch.distributed`` stitches processes
together: every process calls :func:`initialize` (the coordinator's
address, the process count and this process's rank, given or from the
environment), then builds meshes whose entries name their owning
process (``mesh.RankDevice``). The corpus-sharded engine runs over such
a mesh unchanged (``parallel/serving.py``): each process places and
scans only its own shards, and the shards' small results meet on every
process through :func:`exchange`, so every process merges the same
blocks and returns the same rows.

The backend is the caller's choice, never guessed: ``"nccl"`` for CUDA
ranks on distinct cards, ``"gloo"`` on the CPU or for ranks that share
one card (NCCL refuses two ranks on one card). A gloo exchange of CUDA
tensors stages them through pinned host memory.

Layout guidance, as in the JAX package: keep a process's corpus shards
on its own cards, and put the replica (data-parallel) axis across
processes; ``dcn_training_mesh`` encodes that split.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from classmate_rag_tpu_torch.device import DeviceLike, resolve_device
from classmate_rag_tpu_torch.parallel import mesh as _mesh
from classmate_rag_tpu_torch.parallel.mesh import RankDevice

BACKENDS = ("nccl", "gloo")
# Every collective fails after this long instead of hanging, e.g. when
# one process skips a collective the others entered.
DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group: a no-op when one exists, and the process
    stays local when no coordinator is configured.

    ``coordinator_address`` is ``tcp://host:port`` (or ``host:port``) or
    ``file:///path`` (a rendezvous file every process can reach; the
    tests use one); None: ``tcp://$MASTER_ADDR:$MASTER_PORT``.
    ``num_processes`` and ``process_id`` default to ``$WORLD_SIZE`` and
    ``$RANK``. ``backend`` must be named when a group is formed (see the
    module docstring); with ``"nccl"`` set this process's card first
    (``torch.cuda.set_device``)."""
    if dist.is_initialized():
        return
    address = coordinator_address
    if address is None:
        host = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if host and port:
            address = f"tcp://{host}:{port}"
    elif "://" not in address:
        address = f"tcp://{address}"
    world = (num_processes if num_processes is not None
             else _env_int("WORLD_SIZE"))
    rank = process_id if process_id is not None else _env_int("RANK")
    if address is None or world is None or rank is None:
        return  # single process / no coordinator configured: stay local
    if backend not in BACKENDS:
        raise ValueError(
            f"initialize needs backend='nccl' (CUDA ranks on distinct "
            f"cards) or 'gloo' (CPU, or ranks sharing a card), got "
            f"{backend!r}"
        )
    dist.init_process_group(
        backend, init_method=address, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def process_count() -> int:
    """Processes in the group (1 when local)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 when local)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_allgather(x) -> np.ndarray:
    """Every process's ``x`` in rank order, stacked on a new leading axis
    ([P, ...]), as the JAX package's ``multihost_utils.process_allgather``
    gives it. A collective."""
    parts = [np.asarray(x)]
    if dist.is_initialized():
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, np.asarray(x))
    return np.stack(parts)


def _devices_of_every_process(
        devices: Optional[Sequence[DeviceLike]]) -> List[List[torch.device]]:
    """Each process's local devices (default: its CUDA cards), in rank
    order. A collective: every process calls it."""
    local = ([torch.device(d) for d in devices] if devices is not None
             else _mesh.local_devices(resolve_device(None)))
    if not local:
        raise ValueError("a process needs at least one local device")
    if not dist.is_initialized():
        return [local]
    names: List = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in local])
    return [[torch.device(n) for n in row] for row in names]


def process_corpus_mesh(
        devices: Optional[Sequence[DeviceLike]] = None) -> List[RankDevice]:
    """The shard axis over every process: each process's ``devices``
    (default: its CUDA cards), in rank order, one shard each. A
    collective. Hand it to ``ShardedHybridIndex`` on every process."""
    return [RankDevice(r, i, d)
            for r, row in enumerate(_devices_of_every_process(devices))
            for i, d in enumerate(row)]


class ProcessMesh:
    """A ("replica", "data", "model") grid: ``devices[r][d][m]`` is the
    ``RankDevice`` at replica r, data row d, model rank m. Replica r is
    process r's local devices. ``shape`` reads as JAX's ``Mesh.shape``."""

    def __init__(self, devices: List[List[List[RankDevice]]]) -> None:
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return {"replica": len(self.devices),
                "data": len(self.devices[0]),
                "model": len(self.devices[0][0])}

    def entries(self) -> List[RankDevice]:
        return [x for rep in self.devices for row in rep for x in row]

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, {self.devices})"


def dcn_training_mesh(
        local_devices: Optional[Sequence[DeviceLike]] = None) -> ProcessMesh:
    """("replica", "data", "model") mesh: the replica axis across
    processes, data × model over each process's local devices (default:
    its CUDA cards) by ``mesh._factor_2d``. A collective; every process
    must bring as many devices."""
    rows = _devices_of_every_process(local_devices)
    if len({len(r) for r in rows}) != 1:
        raise ValueError(
            f"processes bring unequal device counts {[len(r) for r in rows]}"
        )
    data, model = _mesh._factor_2d(len(rows[0]))
    return ProcessMesh([
        [[RankDevice(r, d * model + m, row[d * model + m])
          for m in range(model)] for d in range(data)]
        for r, row in enumerate(rows)
    ])


def exchange(block: torch.Tensor) -> torch.Tensor:
    """``all_gather`` of this process's ``block`` [S_local, ...]: every
    process's blocks (each the same shape) concatenated in rank order,
    on ``block``'s device. nccl gathers on the card; gloo gathers host
    tensors, so a CUDA block is staged through pinned host memory and
    the result copied back."""
    world = dist.get_world_size()
    backend = dist.get_backend()
    if backend == "nccl":
        out = [torch.empty_like(block) for _ in range(world)]
        dist.all_gather(out, block.contiguous())
        return torch.cat(out)
    if backend != "gloo":
        raise ValueError(f"no exchange over backend {backend!r}")
    if block.is_cuda:
        host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
        host.copy_(block)
    else:
        host = block.contiguous()
    out = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(out, host)
    return torch.cat(out).to(block.device)


__all__ = [
    "BACKENDS",
    "ProcessMesh",
    "dcn_training_mesh",
    "exchange",
    "initialize",
    "process_allgather",
    "process_corpus_mesh",
    "process_count",
    "process_index",
]
