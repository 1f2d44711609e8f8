"""Sparse experts (DeepSeek-V2's ``DeepseekV2MoE``): a softmax router,
greedy top-k routing, SwiGLU experts computed as grouped products, and
shared experts.

- The router runs in f32 on the f32-normed hidden, as HF's ``MoEGate``:
  softmax over the experts, the top-k scores by value, not renormalised
  (``norm_topk_prob`` false), times ``routed_scale``.
- The routed experts are two grouped products over the (token, expert)
  pairs sorted by expert (``torch._grouped_mm``: one launch for every
  expert's gate and up, one for every expert's down). The sort, the
  group offsets and the inverse permutation stay on the device, so a
  decode step reads nothing back. Each pair's output goes back to its
  (token, choice) slot and the k outputs of a token sum in f32, weighted
  by their scores: no atomics, the same sums in every run.
- The shared experts are one SwiGLU of width ``n_shared * expert_ffn``.

Expert weights are stacked [E, out, in] (the HF layout), and the grouped
products take them transposed, as ``F.linear`` takes a weight.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from classmate_rag_tpu_torch.models.decoder import _mm, _rms_norm
from classmate_rag_tpu_torch.utils.metrics import metrics


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    expert_ffn: int
    n_shared: int
    first_dense: int = 0          # leading dense layers
    routed_scale: float = 1.0

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_dense


def swiglu(x: torch.Tensor, gate_up_w, down_w, cdtype) -> torch.Tensor:
    """f32 [M, out] of the SwiGLU x [M, in] (``cdtype``) with gate and up
    as one [in, 2F] product."""
    gu = _mm(x, gate_up_w, cdtype)
    f = gu.shape[-1] // 2
    return _mm((F.silu(gu[..., :f]) * gu[..., f:]).to(cdtype), down_w, cdtype)


def route(normed: torch.Tensor, router_w: torch.Tensor, k: int):
    """(scores [M, k] f32, experts [M, k]) of f32 rows ``normed`` [M, h]:
    the top-k of the softmax over the experts."""
    probs = torch.softmax(normed @ router_w, dim=-1)
    return torch.topk(probs, k, dim=-1)


def moe_ffn(lp, hidden: torch.Tensor, config, moe_index: int) -> torch.Tensor:
    """A MoE layer's FFN block before the residual add: f32 [B, T, h].
    ``moe_index`` counts the MoE layers from 0 (for the per-expert
    tally that tracing keeps)."""
    cdtype = config.compute_dtype
    moe = config.moe
    B, T, h = hidden.shape
    E, k, f = moe.n_experts, moe.experts_per_token, moe.expert_ffn
    x = _rms_norm(hidden, lp["ffn_norm"], config.norm_eps).reshape(-1, h)
    M = x.shape[0]
    with metrics.span("moe.route", tokens=M):
        scores, experts = route(x, lp["router_w"], k)
        if moe.routed_scale != 1.0:
            scores = scores * moe.routed_scale
        sorted_e, order = torch.sort(experts.reshape(-1), stable=True)
        bounds = torch.arange(1, E + 1, device=x.device)
        offs = torch.searchsorted(sorted_e, bounds, out_int32=True)
        tally = metrics.tally("moe.expert_tokens",
                              (config.layers - moe.first_dense, E), x.device)
        if tally is not None:
            tally[moe_index] += torch.diff(offs, prepend=offs.new_zeros(1))
    xb = x.to(cdtype)
    with metrics.span("moe.experts", routed_pairs=M * k):
        xs = xb.index_select(0, order // k)
        gu = torch._grouped_mm(xs, lp["experts_gate_up"].transpose(1, 2),
                               offs=offs)                   # [M k, 2F]
        act = F.silu(gu[:, :f]) * gu[:, f:]
        ys = torch._grouped_mm(act, lp["experts_down"].transpose(1, 2),
                               offs=offs)                   # [M k, h]
        y = torch.empty_like(ys).index_copy_(0, order, ys).view(M, k, h)
        routed = (y.float() * scores[..., None]).sum(dim=1)
    with metrics.span("moe.shared", tokens=M):
        shared = swiglu(xb, lp["shared_gate_up_w"], lp["shared_down_w"],
                        cdtype)
    return (routed + shared).view(B, T, h)
