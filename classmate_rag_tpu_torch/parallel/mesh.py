"""Device meshes (port of the JAX package's ``parallel/mesh.py``).

The JAX package builds its meshes of local chips and drives them from
one process. Here a mesh is plain ``torch.device``s, driven from one
process as well:

- the corpus mesh, a list of devices, one per shard of the sharded
  serving engine: shard-local work runs on each shard's device, and the
  small per-shard results meet on the first one;
- the training mesh, a ``DeviceMesh``: a ``[data][model]`` grid for the
  encoder's dp×tp train step and the decoder's dp×tp decode (batch over
  "data", heads and FFN over "model").

Repeats are allowed: four logical shards (or ranks) on ``cuda:0`` run
the same code as one on each of four cards, with local copies in place
of peer copies.

A mesh may also span processes (``parallel/multihost.py``): its entries
are then ``RankDevice``s, each naming the process that owns it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from classmate_rag_tpu_torch.device import DeviceLike, resolve_device


class RankDevice(NamedTuple):
    """One device of a mesh over processes: slot ``local`` of process
    ``rank``'s local devices, which is ``device`` on that process."""

    rank: int
    local: int
    device: torch.device


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """The local devices of ``device``'s kind (default CUDA), one per
    card: every CUDA card for a CUDA device, else ``[cpu]``. (Tests
    replace it with ``[cpu] * n`` to stand for n cards.)"""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def corpus_mesh(n_devices: int = 0,
                devices: Optional[Sequence[Union[DeviceLike, RankDevice]]]
                = None,
                ) -> List[Union[torch.device, RankDevice]]:
    """The shard axis: ``devices`` (default: the CUDA cards; raises
    without CUDA), cut to the first ``n_devices`` when that is set.
    ``RankDevice`` entries (a mesh over processes) stay as they are."""
    devs = (list(devices) if devices is not None
            else local_devices(resolve_device(None)))
    if n_devices:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a corpus mesh needs at least one device")
    return [d if isinstance(d, RankDevice) else torch.device(d)
            for d in devs]


class DeviceMesh:
    """A ("data", "model") grid of devices: ``devices[d][m]`` is rank m
    of data row d. ``shape`` reads as JAX's ``Mesh.shape``; ``mesh[d]``
    is row d."""

    def __init__(self, devices: Sequence[Sequence[DeviceLike]]) -> None:
        rows = [[torch.device(x) for x in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh needs equal, non-empty rows of "
                             "devices")
        self.devices: List[List[torch.device]] = rows

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def __getitem__(self, d: int) -> List[torch.device]:
        return self.devices[d]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {self.devices})"


def _factor_2d(n: int) -> Tuple[int, int]:
    """Split n into (data, model) with model as large a power of 2 <= 4
    as divides n: a small tp degree suits encoder-sized models."""
    for model in (4, 2, 1):
        if n % model == 0:
            return n // model, model
    return n, 1


def training_mesh(n_devices: int = 0,
                  devices: Optional[Sequence[DeviceLike]] = None,
                  ) -> DeviceMesh:
    """The 2-D ("data", "model") mesh over ``devices`` (default: the
    CUDA cards; raises without CUDA), cut to the first ``n_devices``
    when that is set."""
    devs = (list(devices) if devices is not None
            else local_devices(resolve_device(None)))
    if n_devices:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a training mesh needs at least one device")
    data, model = _factor_2d(len(devs))
    return DeviceMesh([devs[d * model:(d + 1) * model]
                       for d in range(data)])
