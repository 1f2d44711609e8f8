"""Device lists for the corpus-sharded serving engine (port of the JAX
package's ``parallel/mesh.py``, its corpus half).

The JAX package builds a 1-D ``("shard",)`` mesh of local chips and
drives it from one process through ``shard_map``. Here the mesh is a
plain list of ``torch.device``s, one per shard, driven from one process
as well: shard-local work runs on each shard's device, and the small
per-shard results meet on the first one. Repeats are allowed: four
logical shards on ``cuda:0`` run the same code as one shard on each of
four cards, with local copies in place of peer copies.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from classmate_rag_tpu_torch.device import DeviceLike, resolve_device


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
                devices: Optional[Sequence[DeviceLike]] = None,
                ) -> List[torch.device]:
    """The shard axis: ``devices`` (default: the CUDA cards; raises
    without CUDA), cut to the first ``n_devices`` when that is set."""
    devs = (list(devices) if devices is not None
            else local_devices(resolve_device(None)))
    if n_devices:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a corpus mesh needs at least one device")
    return [torch.device(d) for d in devs]
