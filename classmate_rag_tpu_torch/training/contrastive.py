"""Contrastive fine-tuning of the E5 encoder (InfoNCE, in-batch
negatives): port of the JAX package's ``training/contrastive.py``.

The step is the JAX one: encode the queries, then the passages, f32
logits q·pᵀ / temperature, the symmetric softmax cross-entropy with the
diagonal as labels, the gradient, and the optimizer of ``optim.py``
(global-norm clip, AdamW on a schedule, optional accumulation).

It runs on one device (CUDA unless the caller asks for the CPU), or
dp×tp over a ("data", "model") ``DeviceMesh`` as the JAX step runs SPMD
over its mesh: the batch split over "data", heads and FFN over "model"
by ``encoder_param_specs`` (``embeddings.model.MeshE5Model``). The q
and p vectors of every data row meet on ``mesh[0][0]`` for the global
[B, B] logits, so the in-batch negatives are the whole batch; autograd
sums the rows' gradients into each leaf. A 1×1 mesh runs the
single-device step.

Parameters live in the trainable encoder (``E5Model(trainable=True)``
or ``MeshE5Model``: f32 leaves, cast to the compute dtype at each use)
and are updated in place, where the JAX step donates its state and
returns new arrays. ``TrainState.params`` is that module.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from classmate_rag_tpu_torch.device import (
    DeviceLike,
    pin_fp32_matmul,
    resolve_device,
)
from classmate_rag_tpu_torch.embeddings.model import (
    E5Model,
    EncoderConfig,
    MeshE5Model,
    Params,
    _LAYER_KEYS,
    _TOP_KEYS,
    params_from_numpy,
)
from classmate_rag_tpu_torch.parallel.mesh import DeviceMesh, training_mesh
from classmate_rag_tpu_torch.training.optim import (
    apply_updates,
    make_optimizer,
)


def encoder_param_specs(config: EncoderConfig) -> Dict[str, Any]:
    """The JAX package's PartitionSpecs of the encoder tree on a
    ("data", "model") mesh, as tuples.

    Megatron-style: QKV and FFN-in are column-parallel (output features
    on "model"), attention-out and FFN-out are row-parallel (input
    features on "model"); embeddings and norms replicate.
    """
    col = (None, None, "model")   # [L, in, out] split on out
    row = (None, "model", None)   # [L, in, out] split on in
    vec_col = (None, "model")     # [L, features]
    rep2 = (None, None)
    rep1 = (None,)
    return {
        "word_emb": rep2,
        "pos_emb": rep2,
        "type_emb": rep2,
        "emb_ln_g": rep1,
        "emb_ln_b": rep1,
        "layers": {
            "q_w": col, "q_b": vec_col,
            "k_w": col, "k_b": vec_col,
            "v_w": col, "v_b": vec_col,
            "o_w": row, "o_b": rep2,
            "attn_ln_g": rep2, "attn_ln_b": rep2,
            "ff_in_w": col, "ff_in_b": vec_col,
            "ff_out_w": row, "ff_out_b": rep2,
            "ff_ln_g": rep2, "ff_ln_b": rep2,
        },
    }


class TrainState(NamedTuple):
    params: E5Model       # trainable form (or MeshE5Model); its leaves
    opt_state: Dict[str, Any]
    step: int


def param_names() -> List[Tuple[str, ...]]:
    """The order of the leaves the optimizer walks: JAX's sorted-key
    order of the tree, layer leaves one per layer (``("layers", key,
    i)`` stands for row i of the stacked leaf)."""
    names: List[Tuple[str, ...]] = []
    for key in sorted(_TOP_KEYS + ("layers",)):
        if key == "layers":
            names.extend(("layers", k) for k in sorted(_LAYER_KEYS))
        else:
            names.append((key,))
    return names


def param_leaves(model: E5Model) -> List[torch.Tensor]:
    """The model's parameters in ``param_names`` order, each layer key's
    layers in turn (a split leaf's pieces in rank order)."""
    out: List[torch.Tensor] = []
    for name in param_names():
        if name[0] == "layers":
            out.extend(getattr(model, name[1]))
        else:
            out.append(getattr(model, name[0]))
    return out


def leaf_layout(model: E5Model
                ) -> List[Tuple[str, Optional[int], Optional[int], int]]:
    """(tree path, layer, split axis, rank) of each of
    ``param_leaves(model)``: layer None for a top leaf, axis None for a
    leaf held whole. A split leaf's pieces are consecutive, in rank
    order."""
    out: List[Tuple[str, Optional[int], Optional[int], int]] = []
    for name in param_names():
        if name[0] != "layers":
            out.append((name[0], None, None, 0))
            continue
        dim = model.shard_dims.get(name[1])
        ranks = range(model.tp if dim is not None else 1)
        out.extend((f"layers/{name[1]}", i, dim, m)
                   for i in range(model.config.layers) for m in ranks)
    return out


def full_leaves(model: E5Model, leaves: List[torch.Tensor]
                ) -> List[Tuple[Tuple[str, Optional[int]], torch.Tensor]]:
    """``leaves`` laid out as ``param_leaves(model)`` (the parameters,
    their gradients or moments) as the single-device leaves: ((tree
    path, layer), f32 host tensor), each split leaf's pieces
    concatenated in rank order."""
    groups: Dict[Tuple[str, Optional[int]],
                 Tuple[Optional[int], List[torch.Tensor]]] = {}
    for (path, i, dim, _m), x in zip(leaf_layout(model), leaves,
                                     strict=True):
        groups.setdefault((path, i), (dim, []))[1].append(
            x.detach().float().cpu())
    return [(key, ps[0] if dim is None else torch.cat(ps, dim))
            for key, (dim, ps) in groups.items()]


def train_mesh(device) -> DeviceMesh:
    """What the step runs on: ``device`` a ``DeviceMesh``, a count n of
    local CUDA cards (``training_mesh(n)``, which must find n), or one
    device (None: CUDA) as a 1×1 mesh."""
    if isinstance(device, DeviceMesh):
        return device
    if isinstance(device, int) and not isinstance(device, bool):
        mesh = training_mesh(device)
        if mesh.size != device:
            raise ValueError(f"asked to train on {device} cards; "
                             f"{mesh.size} found")
        return mesh
    return DeviceMesh([[resolve_device(device)]])


def _init_model(params: Params, config: EncoderConfig,
                mesh: DeviceMesh) -> E5Model:
    if mesh.size == 1:
        return params_from_numpy(params, config, mesh[0][0], trainable=True)
    if any(d.type == "cuda" for row in mesh.devices for d in row):
        pin_fp32_matmul()
    return MeshE5Model(params, config, mesh,
                       encoder_param_specs(config)).eval()


def _batch(device, *arrays) -> List[torch.Tensor]:
    return [torch.as_tensor(a).to(device) for a in arrays]


def info_nce(model: E5Model, temperature: float, q_ids, q_mask, p_ids,
             p_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, logits): the symmetric InfoNCE loss of one batch of
    (query, passage) pairs and its f32 [B, B] logits q·pᵀ /
    temperature, the diagonal holding each query's own passage."""
    q = model(q_ids, q_mask)                       # [B, D], L2'd
    p = model(p_ids, p_mask)
    logits = (q @ p.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))
    return loss, logits


def make_train_step(
    config: EncoderConfig,
    device: Union[DeviceLike, int, DeviceMesh] = None,
    learning_rate: float = 2e-5,
    temperature: float = 0.05,
    weight_decay: float = 1e-4,
    max_grad_norm: float = 1.0,
    warmup_steps: int = 0,
    total_steps: int = 0,
    accum_steps: int = 1,
):
    """Returns (init_state_fn, train_step) on ``device``: one device
    (None: CUDA), a count of local cards or a ``DeviceMesh`` (dp×tp; the
    batch must divide over "data").

    ``init_state(params)`` takes the JAX tree as numpy.
    ``train_step(state, q_ids, q_mask, p_ids, p_mask) → (state, loss)``
    (loss a 0-d f32 tensor on the device); the state's parameters and
    optimizer moments change in place.

    Optimizer: AdamW behind global-norm gradient clipping; with
    ``total_steps`` the learning rate follows linear warm-up + cosine
    decay (``warmup_steps`` alone gives linear warm-up to a constant);
    ``accum_steps`` > 1 averages that many micro-steps' gradients into
    one update.
    """
    mesh = train_mesh(device)
    dev = mesh[0][0]
    tx = make_optimizer(learning_rate, weight_decay, max_grad_norm,
                        warmup_steps, total_steps, accum_steps)

    def init_state(params: Params) -> TrainState:
        model = _init_model(params, config, mesh)
        return TrainState(model, tx.init(param_leaves(model)), 0)

    def train_step(state: TrainState, q_ids, q_mask, p_ids, p_mask):
        model = state.params
        leaves = param_leaves(model)
        with torch.enable_grad():
            loss, _ = info_nce(model, temperature,
                               *_batch(dev, q_ids, q_mask, p_ids, p_mask))
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            updates, opt_state = tx.update(list(grads), state.opt_state,
                                           leaves)
            apply_updates(leaves, updates)
        return TrainState(model, opt_state, state.step + 1), loss.detach()

    return init_state, train_step


def make_eval_step(
    config: EncoderConfig,
    device: Union[DeviceLike, int, DeviceMesh] = None,
    temperature: float = 0.05,
):
    """eval_step(params, q_ids, q_mask, p_ids, p_mask) → (loss,
    in_batch_accuracy): the InfoNCE objective plus the fraction of
    queries whose own passage wins the in-batch ranking. ``params`` is
    ``TrainState.params``; ``device`` as for ``make_train_step``."""
    dev = train_mesh(device)[0][0]

    def eval_step(params: E5Model, q_ids, q_mask, p_ids, p_mask):
        with torch.no_grad():
            loss, logits = info_nce(params, temperature,
                                    *_batch(dev, q_ids, q_mask, p_ids,
                                            p_mask))
            labels = torch.arange(logits.shape[0], device=logits.device)
            return loss, (logits.argmax(dim=1) == labels).float().mean()

    return eval_step
