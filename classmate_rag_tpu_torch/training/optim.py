"""The encoder's optimizer: the optax chain of the JAX package's
``training/contrastive.py`` (:82-105), written in torch.

    MultiSteps(                        # only when accum_steps > 1
        chain(clip_by_global_norm(max_grad_norm),
              adamw(schedule, weight_decay)),
        every_k_schedule=accum_steps)

Each piece follows optax 0.2's arithmetic, in its order:

- schedules: ``linear_schedule``, ``warmup_cosine_decay_schedule`` and
  a constant rate; ``lr_schedule`` picks one as the JAX package does,
  with its ``warmup_eff`` clamp. The rate of update t is schedule(t),
  t counted from 0 over applied updates.
- ``clip_by_global_norm``: g if ‖g‖ < max, else (g / ‖g‖) · max (no
  epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).
- ``AdamW``: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction by 1 − b^t, decay on every leaf, scaled by −rate.
- ``MultiSteps``: a running mean acc + (g − acc) / (n + 1) of the micro
  gradients; clip and Adam run only on the k-th micro step, every other
  step's update is zero.

Leaves are lists of tensors in one fixed order (the trainer's parameter
order), on one device or on a mesh's (each moment beside its leaf). The
updates are applied in place (``apply_updates``), where the JAX package
returns new arrays.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]
Leaves = List[torch.Tensor]


def _f32(x) -> float:
    """A value as optax computes it in f32."""
    return float(np.float32(x))


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: init → end over ``transition_steps``."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = np.float32(1) - np.float32(c) / np.float32(transition_steps)
        return _f32(np.float32(init_value - end_value) * frac
                    + np.float32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps),
            dtype=np.float32))
        decayed = np.float32(1 - alpha) * cosine + np.float32(alpha)
        return _f32(np.float32(init_value) * decayed)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warm-up to the peak,
    then cosine decay to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)
    return lambda count: (warmup(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def lr_schedule(learning_rate: float, warmup_steps: int = 0,
                total_steps: int = 0) -> Schedule:
    """The JAX package's choice (contrastive.py:82-100): warm-up + cosine
    with ``total_steps``, linear warm-up to a constant with
    ``warmup_steps`` alone, else a constant rate."""
    if total_steps:
        # optax needs decay_steps > warmup_steps; short runs may ask for
        # fewer total steps than warm-up.
        warmup_eff = min(max(warmup_steps, 1), max(total_steps - 1, 1))
        return warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_eff,
            max(total_steps, warmup_eff + 1))
    if warmup_steps:
        return linear_schedule(0.0, learning_rate, warmup_steps)
    return constant_schedule(learning_rate)


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares: each
    sum on its leaf's device, added in leaf order on the first leaf's.
    The pieces of a leaf split over a mesh are leaves here, so each
    logical leaf counts once."""
    sums = [torch.sum(x * x) for x in leaves]
    total = sums[0]
    for sq in sums[1:]:
        total = total + sq.to(total.device)
    return torch.sqrt(total)


def clip_by_global_norm(grads: Leaves, max_norm: float) -> Leaves:
    """optax.clip_by_global_norm: ``grads`` as they are when their
    global norm is below ``max_norm``, else each (g / norm) · max_norm
    (the norm copied to each device the leaves are on)."""
    norm = global_norm(grads)
    if bool(norm < max_norm):
        return list(grads)
    scaled = list(grads)
    by_device: Dict[torch.device, List[int]] = {}
    for i, g in enumerate(grads):
        by_device.setdefault(g.device, []).append(i)
    for dev, idx in by_device.items():
        out = torch._foreach_div([grads[i] for i in idx], norm.to(dev))
        torch._foreach_mul_(out, max_norm)
        for i, g in zip(idx, out):
            scaled[i] = g
    return scaled


class AdamW:
    """optax.adamw(schedule, b1, b2, eps, weight_decay) as init/update on
    lists of leaves. State: ``{"count": int, "mu": Leaves, "nu": Leaves}``
    (``count`` counts applied updates; the schedule reads it before the
    increment)."""

    def __init__(self, schedule: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4) -> None:
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Leaves) -> Dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, grads: Leaves, state: Dict, params: Leaves):
        """(updates, new state); the moments are updated in place."""
        b1, b2 = self.b1, self.b2
        mu, nu = state["mu"], state["nu"]
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        count = state["count"] + 1
        bc1 = _f32(1 - np.power(np.float32(b1), np.float32(count),
                                dtype=np.float32))
        bc2 = _f32(1 - np.power(np.float32(b2), np.float32(count),
                                dtype=np.float32))
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(updates, torch._foreach_mul(
            list(params), self.weight_decay))
        torch._foreach_mul_(updates, -self.schedule(state["count"]))
        return updates, {"count": count, "mu": mu, "nu": nu}


class ClipAdamW:
    """chain(clip_by_global_norm(max_norm), adamw(...))."""

    def __init__(self, adamw: AdamW, max_norm: float) -> None:
        self.adamw, self.max_norm = adamw, max_norm

    def init(self, params: Leaves) -> Dict:
        return self.adamw.init(params)

    def update(self, grads: Leaves, state: Dict, params: Leaves):
        return self.adamw.update(
            clip_by_global_norm(grads, self.max_norm), state, params)


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k) with the gradient
    mean. State: ``{"mini_step", "gradient_step", "inner", "acc"}``."""

    def __init__(self, inner, every_k: int) -> None:
        self.inner, self.k = inner, every_k

    def init(self, params: Leaves) -> Dict:
        return {"mini_step": 0, "gradient_step": 0,
                "inner": self.inner.init(params),
                "acc": [torch.zeros_like(p) for p in params]}

    def update(self, grads: Leaves, state: Dict, params: Leaves):
        """(updates, new state): zeros until the k-th micro step, then
        the inner update of the micro gradients' mean."""
        n = state["mini_step"]
        acc = state["acc"]
        # acc + (g - acc) / (n + 1)
        torch._foreach_add_(acc, torch._foreach_div(
            torch._foreach_sub(grads, acc), n + 1))
        if n < self.k - 1:
            return None, {**state, "mini_step": n + 1, "acc": acc}
        updates, inner = self.inner.update(acc, state["inner"], params)
        for a in acc:
            a.zero_()
        return updates, {"mini_step": 0,
                         "gradient_step": state["gradient_step"] + 1,
                         "inner": inner, "acc": acc}


def apply_updates(params: Leaves, updates) -> None:
    """params += updates, in place (``None``: a zero update)."""
    if updates is not None:
        with torch.no_grad():
            torch._foreach_add_(list(params), updates)


def make_optimizer(learning_rate: float, weight_decay: float,
                   max_grad_norm: float, warmup_steps: int = 0,
                   total_steps: int = 0, accum_steps: int = 1):
    """The JAX package's optimizer for ``make_train_step``."""
    tx = ClipAdamW(AdamW(lr_schedule(learning_rate, warmup_steps,
                                     total_steps),
                         weight_decay=weight_decay), max_grad_norm)
    return MultiSteps(tx, accum_steps) if accum_steps > 1 else tx
