"""Training-state checkpoints (port of the JAX package's
``training/checkpoint.py``), in torch's own format.

A checkpoint is a directory ``<root>/step_N/`` holding one file,
``train_state.pt``: ``torch.save`` of a flat dict of tensors, read back
with ``weights_only=True``. Keys name the JAX tree's paths:

- ``params/word_emb``, ``params/layers/q_w`` (layers stacked [L, ...],
  f32), ...;
- the optimizer state under ``opt_state/``: ``count``, ``mu/...``,
  ``nu/...`` (and with accumulation ``mini_step``, ``gradient_step``,
  ``acc/...`` and the inner state under ``inner/``), counters as 0-d
  int64 tensors;
- ``step``.

A state trained on a mesh is saved with its split leaves gathered, in
the single-device format, and restores onto a mesh (split again) or
onto one device alike.

``encoder_config.json`` in the root describes the architecture, as in
the JAX package, so ``get_embedder(checkpoint=...)`` (or
``ENCODER_CHECKPOINT``) can serve the fine-tune. The JAX package's
checkpoints are orbax directories, which need JAX to read: the port
refuses them with an error that says so. ``_params_digest`` reproduces
the JAX package's digest byte for byte, so the same parameters key the
embedding cache alike in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from hashlib import blake2b
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from classmate_rag_tpu_torch.embeddings.model import EncoderConfig, Params
from classmate_rag_tpu_torch.training.contrastive import (
    TrainState,
    full_leaves,
    leaf_layout,
    param_leaves,
)

_CONFIG_FILE = "encoder_config.json"
_STATE_FILE = "train_state.pt"


def _flatten(prefix: str, obj, model, out: Dict[str, torch.Tensor]):
    if isinstance(obj, bool) or not isinstance(obj, (int, dict, list)):
        raise TypeError(f"{prefix}: cannot checkpoint {type(obj).__name__}")
    if isinstance(obj, int):
        out[prefix] = torch.tensor(obj, dtype=torch.int64)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}/{k}", v, model, out)
    else:   # leaves in optimizer order: whole leaves (a split one's
        # pieces gathered), each layer key's layers stacked
        groups: Dict[str, List[torch.Tensor]] = {}
        for (path, _i), leaf in full_leaves(model, obj):
            groups.setdefault(path, []).append(leaf)
        for path, ts in groups.items():
            out[f"{prefix}/{path}"] = (torch.stack(ts)
                                       if path.startswith("layers/")
                                       else ts[0])


def _load_into(prefix: str, template, flat: Dict[str, torch.Tensor],
               layout, tp: int):
    """``template``'s structure with the values of ``flat``; tensors are
    copied into the template's own (on their devices; a split leaf's
    piece into each rank's)."""
    if isinstance(template, int):
        return int(flat[prefix])
    if isinstance(template, dict):
        return {k: _load_into(f"{prefix}/{k}", v, flat, layout, tp)
                for k, v in template.items()}
    with torch.no_grad():
        for (path, i, dim, m), leaf in zip(layout, template, strict=True):
            src = flat[f"{prefix}/{path}"]
            src = src[i] if i is not None else src
            if dim is not None:
                src = torch.tensor_split(src, tp, dim=dim)[m]
            leaf.copy_(src)
    return template


def _state_file(ckpt: Path) -> Path:
    path = ckpt / _STATE_FILE
    if not path.exists():
        raise ValueError(
            f"{ckpt} holds no {_STATE_FILE}: it is not a checkpoint of the "
            f"PyTorch port (an orbax checkpoint of the JAX package needs "
            f"JAX to read, which the port never imports)")
    return path


def _write_config(directory: Path, config: EncoderConfig) -> None:
    d = dataclasses.asdict(config)
    d["compute_dtype"] = str(config.compute_dtype).replace("torch.", "")
    (directory / _CONFIG_FILE).write_text(json.dumps(d, indent=1),
                                          encoding="utf-8")


def _read_config(directory: Path) -> Optional[EncoderConfig]:
    """EncoderConfig from encoder_config.json in ``directory`` (or its
    parent, for a step_N path); None when absent."""
    for cand in (directory / _CONFIG_FILE, directory.parent / _CONFIG_FILE):
        if cand.exists():
            d = json.loads(cand.read_text(encoding="utf-8"))
            d["compute_dtype"] = getattr(torch,
                                         d.get("compute_dtype", "bfloat16"))
            known = {f.name for f in dataclasses.fields(EncoderConfig)}
            return EncoderConfig(**{k: v for k, v in d.items() if k in known})
    return None


def save_train_state(state: TrainState, directory: str | Path,
                     config: Optional[EncoderConfig] = None) -> str:
    """Write ``<directory>/step_<step>/``; returns its path. With
    ``config`` the EncoderConfig is written beside it
    (encoder_config.json), which makes the checkpoint self-describing."""
    root = Path(directory).resolve()
    path = root / f"step_{int(state.step)}"
    path.mkdir(parents=True, exist_ok=True)
    flat: Dict[str, torch.Tensor] = {}
    _flatten("params", param_leaves(state.params), state.params, flat)
    _flatten("opt_state", state.opt_state, state.params, flat)
    flat["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    tmp = path / f".{_STATE_FILE}.tmp"
    torch.save(flat, tmp)
    os.replace(tmp, path / _STATE_FILE)
    if config is not None:
        _write_config(root, config)
    return str(path)


def latest_checkpoint(directory: str | Path) -> Optional[Path]:
    root = Path(directory)
    if not root.exists():
        return None
    steps = []
    for child in root.iterdir():
        if child.is_dir() and child.name.startswith("step_"):
            try:
                steps.append((int(child.name.split("_", 1)[1]), child))
            except ValueError:
                continue
    return max(steps)[1] if steps else None


def restore_train_state(directory: str | Path,
                        template: TrainState) -> Optional[TrainState]:
    """Restore the latest checkpoint into ``template`` (a freshly
    initialised state of the same configuration: its tensors receive
    the values, on their device). None when there is no checkpoint."""
    path = latest_checkpoint(directory)
    if path is None:
        return None
    flat = torch.load(_state_file(path), map_location="cpu",
                      weights_only=True, mmap=True)
    layout, tp = leaf_layout(template.params), template.params.tp
    _load_into("params", param_leaves(template.params), flat, layout, tp)
    opt_state = _load_into("opt_state", template.opt_state, flat, layout,
                           tp)
    return TrainState(template.params, opt_state, int(flat["step"]))


def load_encoder_checkpoint(path: str | Path
                            ) -> Tuple[Params, EncoderConfig, str]:
    """Fine-tuned encoder parameters for the product embedder.

    ``path`` is a training checkpoint root (latest ``step_N`` picked) or
    a ``step_N`` directory written by ``save_train_state`` with a
    config. Returns ``(params as a numpy tree, EncoderConfig, tag)``;
    ``tag`` (``ckpt-step_N-<digest>``) keys the embedding cache, so
    vectors of different fine-tunes never share cache entries."""
    root = Path(path).expanduser().resolve()
    if root.name.startswith("step_") and root.is_dir():
        ckpt = root
    else:
        ckpt = latest_checkpoint(root)
        if ckpt is None:
            raise FileNotFoundError(
                f"no step_N checkpoint under {root} (train with "
                f"python -m classmate_rag_tpu_torch.training.train_encoder "
                f"--checkpoint-dir)")
    config = _read_config(ckpt)
    if config is None:
        raise ValueError(
            f"{ckpt} has no {_CONFIG_FILE}; re-save the checkpoint with "
            f"save_train_state(..., config=...) so it is self-describing")
    flat = torch.load(_state_file(ckpt), map_location="cpu",
                      weights_only=True, mmap=True)
    params: Params = {"layers": {}}
    for key, t in flat.items():
        if key.startswith("params/layers/"):
            params["layers"][key[len("params/layers/"):]] = t.numpy()
        elif key.startswith("params/"):
            params[key[len("params/"):]] = t.numpy()
    return params, config, f"ckpt-{ckpt.name}-{_params_digest(params)}"


def _digest_leaves(tree, path: str = ""):
    """(JAX ``keystr`` path, leaf) in ``jax.tree_util`` order: dict keys
    sorted, depth first."""
    for key in sorted(tree):
        sub = f"{path}[{key!r}]"
        if isinstance(tree[key], dict):
            yield from _digest_leaves(tree[key], sub)
        else:
            yield sub, tree[key]


def _params_digest(params: Params, digest_size: int = 6) -> str:
    """Content digest of a params tree: leaf paths, shapes, dtypes and
    raw bytes, exactly as the JAX package computes it
    (classmate_rag_tpu/training/checkpoint.py:169-185)."""
    h = blake2b(digest_size=digest_size)
    for keystr, leaf in _digest_leaves(params):
        arr = np.asarray(leaf)
        h.update(keystr.encode("utf-8"))
        h.update(str(arr.shape).encode("utf-8"))
        h.update(str(arr.dtype).encode("utf-8"))
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()
