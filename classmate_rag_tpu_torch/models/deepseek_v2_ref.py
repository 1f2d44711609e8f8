"""DeepSeek-V2's forward in float32 plain ``torch``: the plain reference the
port's decoder (``decoder.py``, ``mla.py``, ``moe.py``) is held to.

It follows HF's ``modeling_deepseek.py`` (``DeepseekV2Attention``
without a query LoRA, ``DeepseekV2YarnRotaryEmbedding``, ``MoEGate``
with greedy top-k and softmax scoring, ``DeepseekV2MoE``,
``DeepseekV2MLP``, ``DeepseekV2RMSNorm``) and reads the HF config.json
keys and HF tensor names. One sequence at a time, every position from the
first: no cache, no padding, no batching, no absorbed products, the
experts one by one. It imports nothing of the port.

Departures from HF's module, none of which changes the mathematics:

- everything is float32 (HF runs in the checkpoint's bf16), and TF32 is
  off for the matmuls (``torch.backends.*.allow_tf32 = False``);
- RoPE's cos and sin are computed at the positions given, not cached;
- the attention mask is the causal one of a single unpadded sequence;
- ``layer`` returns each position's router choices beside the hidden
  state (for a count of choices that differ; HF keeps them internal).

``get(name)`` gives a weight by its HF name (any dtype, any device): a
state dict's ``__getitem__``, or a function that loads or draws one layer
at a time.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Getter = Callable[[str], torch.Tensor]


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def config(raw: Dict) -> SimpleNamespace:
    """The HF config.json values the forward reads."""
    return SimpleNamespace(**raw)


def _w(get: Getter, name: str) -> torch.Tensor:
    return get(name).float()


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.pow(2).mean(-1, keepdim=True)
    return g * (x * torch.rsqrt(var + eps))


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _find_correction_dim(num_rotations, dim, base, max_position):
    return (dim * math.log(max_position / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def rope_cos_sin(cfg, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [T, qk_rope_head_dim] at ``positions`` [T], YaRN's when
    ``rope_scaling`` is set (HF's DeepseekV2YarnRotaryEmbedding)."""
    dim, base = cfg.qk_rope_head_dim, float(cfg.rope_theta)
    dev = positions.device
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim
    rs = getattr(cfg, "rope_scaling", None)
    mscale = 1.0
    if rs:
        factor = rs["factor"]
        freq_extra = 1.0 / (base ** ar)
        freq_inter = 1.0 / (factor * base ** ar)
        orig = rs["original_max_position_embeddings"]
        low = max(math.floor(_find_correction_dim(
            rs.get("beta_fast", 32), dim, base, orig)), 0)
        high = min(math.ceil(_find_correction_dim(
            rs.get("beta_slow", 1), dim, base, orig)), dim - 1)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=dev)
                 - low) / (high - low)).clamp(0, 1)
        inv_freq_mask = 1.0 - ramp
        inv_freq = freq_inter * (1 - inv_freq_mask) + \
            freq_extra * inv_freq_mask
        mscale = (yarn_get_mscale(factor, rs.get("mscale", 1))
                  / yarn_get_mscale(factor, rs.get("mscale_all_dim", 0)))
    else:
        inv_freq = 1.0 / (base ** ar)
    freqs = torch.outer(positions.float(), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def softmax_scale(cfg) -> float:
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    rs = getattr(cfg, "rope_scaling", None)
    if rs and rs.get("mscale_all_dim", 0):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [T, heads, R]: HF de-interleaves the rope dims, then rotates
    half-split."""
    t, h, d = x.shape
    x = x.view(t, h, d // 2, 2).transpose(-1, -2).reshape(t, h, d)
    return x * cos[:, None, :] + _rotate_half(x) * sin[:, None, :]


def attention(get: Getter, cfg, i: int, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Layer i's attention block (after its input norm), [T, hidden]."""
    p = f"model.layers.{i}.self_attn."
    T = x.shape[0]
    H, N, R = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
               cfg.qk_rope_head_dim)
    C, V = cfg.kv_lora_rank, cfg.v_head_dim
    q = (x @ _w(get, p + "q_proj.weight").T).view(T, H, N + R)
    q_nope, q_pe = q[..., :N], q[..., N:]
    ckv = x @ _w(get, p + "kv_a_proj_with_mqa.weight").T
    c, k_pe = ckv[:, :C], ckv[:, C:].view(T, 1, R)
    c = rms_norm(c, _w(get, p + "kv_a_layernorm.weight"), cfg.rms_norm_eps)
    kv = (c @ _w(get, p + "kv_b_proj.weight").T).view(T, H, N + V)
    k_nope, v = kv[..., :N], kv[..., N:]
    cos, sin = rope_cos_sin(cfg, positions)
    q_pe, k_pe = _apply_rope(q_pe, cos, sin), _apply_rope(k_pe, cos, sin)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(T, H, R)], dim=-1)
    scores = torch.einsum("thd,shd->hts", q, k) * softmax_scale(cfg)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("hts,shd->thd", probs, v).reshape(T, H * V)
    return ctx @ _w(get, p + "o_proj.weight").T


def mlp(get: Getter, prefix: str, x: torch.Tensor) -> torch.Tensor:
    g = x @ _w(get, prefix + "gate_proj.weight").T
    u = x @ _w(get, prefix + "up_proj.weight").T
    return (F.silu(g) * u) @ _w(get, prefix + "down_proj.weight").T


def moe(get: Getter, cfg, i: int, x: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer i's sparse experts: (output [T, hidden], choices [T, k])."""
    p = f"model.layers.{i}.mlp."
    logits = x @ _w(get, p + "gate.weight").T
    scores = logits.softmax(dim=-1)
    weight, idx = torch.topk(scores, k=cfg.num_experts_per_tok, dim=-1)
    if getattr(cfg, "norm_topk_prob", False):
        weight = weight / weight.sum(dim=-1, keepdim=True)
    weight = weight * getattr(cfg, "routed_scaling_factor", 1.0)
    y = torch.zeros_like(x)
    for e in range(cfg.n_routed_experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            out = mlp(get, f"{p}experts.{e}.", x[rows])
            y.index_add_(0, rows, out * weight[rows, slot, None])
    if getattr(cfg, "n_shared_experts", None):
        y = y + mlp(get, p + "shared_experts.", x)
    return y, idx


def is_moe_layer(cfg, i: int) -> bool:
    return (getattr(cfg, "n_routed_experts", None) is not None
            and i >= cfg.first_k_dense_replace
            and i % getattr(cfg, "moe_layer_freq", 1) == 0)


def embed(get: Getter, ids: torch.Tensor) -> torch.Tensor:
    return _w(get, "model.embed_tokens.weight")[ids]


def layer(get: Getter, cfg, i: int, x: torch.Tensor,
          positions: torch.Tensor
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Decoder layer i over one sequence: (hidden [T, hidden], the
    router's choices [T, k], or None in a dense layer)."""
    _no_tf32()
    p = f"model.layers.{i}."
    eps = cfg.rms_norm_eps
    x = x + attention(get, cfg, i, rms_norm(
        x, _w(get, p + "input_layernorm.weight"), eps), positions)
    h = rms_norm(x, _w(get, p + "post_attention_layernorm.weight"), eps)
    if is_moe_layer(cfg, i):
        out, choices = moe(get, cfg, i, h)
        return x + out, choices
    return x + mlp(get, p + "mlp.", h), None


def head(get: Getter, cfg, x: torch.Tensor) -> torch.Tensor:
    """Logits [T, vocab] of the last layer's hidden [T, hidden]."""
    _no_tf32()
    x = rms_norm(x, _w(get, "model.norm.weight"), cfg.rms_norm_eps)
    return x @ _w(get, "lm_head.weight").T


def forward(get: Getter, cfg, ids: torch.Tensor) -> torch.Tensor:
    """Logits [T, vocab] f32 of one sequence ``ids`` [T]."""
    _no_tf32()
    positions = torch.arange(ids.shape[0], device=ids.device)
    x = embed(get, ids)
    for i in range(cfg.num_hidden_layers):
        x, _ = layer(get, cfg, i, x, positions)
    return head(get, cfg, x)
