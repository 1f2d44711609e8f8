"""Contrastive fine-tuning of the E5 encoder (InfoNCE, in-batch
negatives): port of the JAX package's ``training/contrastive.py``.

The step is the JAX one: encode the queries, then the passages, f32
logits q·pᵀ / temperature, the symmetric softmax cross-entropy with the
diagonal as labels, the gradient, and the optimizer of ``optim.py``
(global-norm clip, AdamW on a schedule, optional accumulation). The
JAX step runs SPMD over a ("data", "model") mesh; this one runs on one
device (CUDA unless the caller asks for the CPU). A mesh or more than
one card raises ``NotImplementedError`` until multi-GPU training is
ported (ROADMAP §1, multi-GPU), and with it ``encoder_param_specs``.

Parameters live in the trainable encoder (``E5Model(trainable=True)``:
f32 leaves, cast to the compute dtype at each use) and are updated in
place, where the JAX step donates its state and returns new arrays.
``TrainState.params`` is that module.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from classmate_rag_tpu_torch.device import DeviceLike, resolve_device
from classmate_rag_tpu_torch.embeddings.model import (
    E5Model,
    EncoderConfig,
    Params,
    _LAYER_KEYS,
    _TOP_KEYS,
    params_from_numpy,
)
from classmate_rag_tpu_torch.training.optim import (
    apply_updates,
    make_optimizer,
)


class TrainState(NamedTuple):
    params: E5Model       # trainable form; its parameters are the leaves
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
    layers in turn."""
    out: List[torch.Tensor] = []
    for name in param_names():
        if name[0] == "layers":
            out.extend(getattr(model, name[1]))
        else:
            out.append(getattr(model, name[0]))
    return out


def train_device(device: DeviceLike) -> torch.device:
    """One device: a mesh or a count of more than one card raises."""
    if isinstance(device, int) and not isinstance(device, bool):
        if device > 1:
            raise NotImplementedError(
                f"training on {device} cards is not ported yet (ROADMAP "
                f"§1, multi-GPU); train on one")
        device = None
    elif device is not None and not isinstance(device, (str, torch.device)):
        raise NotImplementedError(
            f"a device mesh ({type(device).__name__}) is not ported yet "
            f"(ROADMAP §1, multi-GPU); pass one device")
    return resolve_device(device)


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
    device: DeviceLike = None,
    learning_rate: float = 2e-5,
    temperature: float = 0.05,
    weight_decay: float = 1e-4,
    max_grad_norm: float = 1.0,
    warmup_steps: int = 0,
    total_steps: int = 0,
    accum_steps: int = 1,
):
    """Returns (init_state_fn, train_step) on ``device``.

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
    dev = train_device(device)
    tx = make_optimizer(learning_rate, weight_decay, max_grad_norm,
                        warmup_steps, total_steps, accum_steps)

    def init_state(params: Params) -> TrainState:
        model = params_from_numpy(params, config, dev, trainable=True)
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
    device: DeviceLike = None,
    temperature: float = 0.05,
):
    """eval_step(params, q_ids, q_mask, p_ids, p_mask) → (loss,
    in_batch_accuracy): the InfoNCE objective plus the fraction of
    queries whose own passage wins the in-batch ranking. ``params`` is
    ``TrainState.params``."""
    dev = train_device(device)

    def eval_step(params: E5Model, q_ids, q_mask, p_ids, p_mask):
        with torch.no_grad():
            loss, logits = info_nce(params, temperature,
                                    *_batch(dev, q_ids, q_mask, p_ids,
                                            p_mask))
            labels = torch.arange(logits.shape[0], device=logits.device)
            return loss, (logits.argmax(dim=1) == labels).float().mean()

    return eval_step
