"""Tensor parallelism over a single-controller ``DeviceMesh`` (the port's
own; the JAX package declares shardings and lets XLA GSPMD place the
collectives).

- A leaf is split along the mesh's "model" axis by its spec, a tuple in
  the form of JAX's ``PartitionSpec`` (``(None, None, "model")`` splits
  the last axis of an [L, in, out] stack). ``torch.tensor_split`` cuts
  an axis that tp does not divide into pieces one apart in size, the
  first ones the larger: GSPMD pads that case instead, and the pieces
  gathered in rank order are the same values.
- JAX's ``psum`` over "model" is ``reduce_sum``: the ranks' partials
  added in rank order on the first rank's device (the data row's first
  device), where the caller keeps the row's replicated activations;
  each rank reads them from there at its next use.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[Optional[str], ...]


def model_dim(spec: Spec) -> Optional[int]:
    """The axis ``spec`` splits over "model" (None: replicated)."""
    return spec.index("model") if "model" in spec else None


def shard(x, spec: Spec, tp: int, rank: int):
    """Rank ``rank``'s piece of ``x`` (a view; ``x`` itself when the spec
    replicates it). Works on tensors and numpy arrays."""
    dim = model_dim(spec)
    if dim is None:
        return x
    if isinstance(x, torch.Tensor):
        return torch.tensor_split(x, tp, dim=dim)[rank]
    return np.array_split(x, tp, axis=dim)[rank]


def reduce_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """psum over "model": the ranks' partials summed in rank order on
    the first one's device. One part is returned as it is."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def gather(pieces: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The pieces concatenated along ``dim`` in rank order, on the first
    one's device (all_gather onto one device)."""
    if len(pieces) == 1:
        return pieces[0]
    dev = pieces[0].device
    return torch.cat([p.to(dev) for p in pieces], dim=dim)


def gather_tree(rank_trees: Sequence[Dict[str, Any]],
                specs: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """One data row's rank trees (``rank_trees[m]``, laid out by
    ``specs``) gathered to the full tree of host f32 arrays."""
    out: Dict[str, Any] = {}
    for key, spec in specs.items():
        if isinstance(spec, dict):
            out[key] = gather_tree([t[key] for t in rank_trees], spec)
            continue
        dim = model_dim(spec)
        leaves = [rank_trees[0][key]] if dim is None else [
            t[key] for t in rank_trees]
        out[key] = np.concatenate(
            [x.detach().float().cpu().numpy() for x in leaves],
            axis=dim or 0)
    return out


def split_rows(n: int, parts: int) -> List[slice]:
    """``parts`` equal slices of ``n`` rows (the batch over "data");
    raises when ``parts`` does not divide ``n``, as a dp-sharded batch
    must divide over JAX's data axis."""
    if n % parts:
        raise ValueError(f"batch {n} does not divide over {parts} data "
                         f"rows")
    b = n // parts
    return [slice(d * b, (d + 1) * b) for d in range(parts)]
