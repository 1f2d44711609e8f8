"""Multi-head latent attention (DeepSeek-V2's MLA) over a latent cache,
with YaRN RoPE on a slice of each head.

Following HF's ``modeling_deepseek.py`` (``DeepseekV2Attention``,
``DeepseekV2YarnRotaryEmbedding``), without a query LoRA:

- q = x·W_q, per head [nope | rope]; x·W_kv_a = [c | k_rope], and
  c ← RMSNorm(c). One k_rope (``qk_rope_dim`` wide) serves every head.
- RoPE with YaRN's blended frequencies on q_rope and k_rope; the softmax
  scale is (nope + rope)^-½ · mscale(factor, mscale_all_dim)².
- The cache holds [c ‖ roped k_rope] in ``compute_dtype``, one
  [B, S, kv_lora_rank + qk_rope_dim] matrix a layer, written in place.
- Prefill (more than one new position) decompresses K and V from the
  cache's slots with W_kv_b and attends as plain multi-head attention.
  Decode (one position) absorbs W_kv_b's K half into the query and its
  V half after the context, and attends over the latent cache as it
  lies: one product a row against [S, 576], every head at once.

HF rotates the rope dims interleaved: it de-interleaves q_rope and k_rope
([x0, x2, ..., x1, x3, ...]) before its half-split ``rotate_half``. The
converter (``hf_state.params_from_hf_state``) permutes W_q's and W_kv_a's
rope output columns into that order at load, so the program rotates
half-split (``decoder._rope``) and caches k_rope de-interleaved; q·k
is the same sum over the same pairs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from classmate_rag_tpu_torch.models.decoder import (
    _mm,
    _rms_norm,
    _rope,
    bmm_f32,
)
from classmate_rag_tpu_torch.utils.metrics import metrics


@dataclasses.dataclass(frozen=True)
class Yarn:
    """HF's ``rope_scaling`` of type ``yarn``."""
    factor: float
    original_max_seq: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    yarn: Optional[Yarn] = None

    @property
    def latent_width(self) -> int:
        """One cached position of one layer: [c ‖ k_rope]."""
        return self.kv_lora_rank + self.qk_rope_dim


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float,
                    max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (
        2 * math.log(base))


def rope_inv_freq(dim: int, base: float, yarn: Optional[Yarn],
                  device=None) -> torch.Tensor:
    """f32 [dim / 2] inverse frequencies: plain RoPE's, or YaRN's blend of
    the extrapolated and the interpolated ones (HF's ramp between the
    correction dims of beta_fast and beta_slow)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    if yarn is None:
        return extra
    inter = 1.0 / (yarn.factor * base ** exps)
    low = max(math.floor(_correction_dim(yarn.beta_fast, dim, base,
                                         yarn.original_max_seq)), 0)
    high = min(math.ceil(_correction_dim(yarn.beta_slow, dim, base,
                                         yarn.original_max_seq)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_tables(positions: torch.Tensor, mla: MLAConfig,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """[cos, cos] and [-sin, sin], [B, T, 1, rope], for ``decoder._rope``,
    scaled by YaRN's mscale(factor, mscale) / mscale(factor,
    mscale_all_dim) as HF scales its cached cos and sin."""
    inv = rope_inv_freq(mla.qk_rope_dim, theta, mla.yarn, positions.device)
    angles = positions[:, :, None].float() * inv[None, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    y = mla.yarn
    if y is not None:
        m = yarn_mscale(y.factor, y.mscale) / yarn_mscale(y.factor,
                                                          y.mscale_all_dim)
        if m != 1.0:
            cos, sin = cos * m, sin * m
    return (torch.cat([cos, cos], dim=-1)[:, :, None, :],
            torch.cat([-sin, sin], dim=-1)[:, :, None, :])


def softmax_scale(mla: MLAConfig) -> float:
    scale = (mla.qk_nope_dim + mla.qk_rope_dim) ** -0.5
    y = mla.yarn
    if y is not None and y.mscale_all_dim:
        m = yarn_mscale(y.factor, y.mscale_all_dim)
        scale *= m * m
    return scale


# Prefill attention in row chunks: each chunk's f32 scores stay under
# this many elements (2^27: 512 MB).
_SCORE_ELEMS = 1 << 27


def mla_attention(lp, hidden: torch.Tensor, cos, sin, cache: torch.Tensor,
                  offset: int, attn_mask: torch.Tensor,
                  config) -> torch.Tensor:
    """A layer's MLA block up to its o_proj product, before the residual
    add: f32 [B, T, hidden]. Writes [c ‖ k_rope] of the T new positions
    into the layer's cache [B, S, C + R] at slots [offset, offset + T) and
    attends over slots [0, offset + T) under ``attn_mask`` [B, T, S]; an
    ``offset`` on the device ([1] long, T = 1) writes its slot and attends
    over all S slots."""
    m = config.mla
    cdtype = config.compute_dtype
    B, T, _ = hidden.shape
    H, N, R, C, V = (config.heads, m.qk_nope_dim, m.qk_rope_dim,
                     m.kv_lora_rank, m.v_head_dim)
    span = cache.shape[1] if isinstance(offset, torch.Tensor) else offset + T

    normed = _rms_norm(hidden, lp["attn_norm"], config.norm_eps).to(cdtype)
    qa = _mm(normed, lp["q_kv_a_w"], cdtype)         # [B, T, H(N+R) + C+R]
    q = qa[..., :H * (N + R)].view(B, T, H, N + R)
    c = _rms_norm(qa[..., H * (N + R):H * (N + R) + C], lp["kv_a_norm"],
                  config.norm_eps)
    k_rope = _rope(qa[..., None, H * (N + R) + C:], cos, sin)  # [B,T,1,R]
    if isinstance(offset, torch.Tensor):
        # One position at a slot on the device: written in place, and
        # every slot attended under the mask (static shapes).
        cache.index_copy_(1, offset, torch.cat([c, k_rope[:, :, 0]],
                                               dim=-1).to(cache.dtype))
        lat, mask = cache, attn_mask
    else:
        cache[:, offset:span, :C] = c
        cache[:, offset:span, C:] = k_rope[:, :, 0]
        lat = cache[:, :span]                        # [B, span, C + R]
        mask = attn_mask[:, :, :span]
    q_rope = _rope(q[..., N:], cos, sin)             # [B, T, H, R]
    scale = softmax_scale(m)

    if T == 1:
        with metrics.span("mla.decode", rows=B, slots=span):
            # Absorbed: q_nope·(c W_uk)ᵀ = (q_nope W_ukᵀ)·cᵀ, one latent
            # query [C + R] a head, scored against the cache as it lies.
            q_lat = bmm_f32(q[..., :N].to(cdtype).reshape(B, H, N)
                            .transpose(0, 1), lp["w_uk"])   # [H, B, C]
            qf = torch.cat([q_lat.transpose(0, 1), q_rope[:, 0]],
                           dim=-1).to(cdtype)               # [B, H, C+R]
            scores = bmm_f32(qf, lat.transpose(1, 2))       # [B, H, span]
            scores.mul_(scale).add_(mask)
            probs = torch.softmax(scores, dim=-1).to(cdtype)
            ctx = bmm_f32(probs, lat[..., :C])              # [B, H, C]
            out = bmm_f32(ctx.to(cdtype).transpose(0, 1), lp["w_uv"])
            ctx = out.transpose(0, 1).reshape(B, 1, H * V)  # [B, 1, H V]
    else:
        with metrics.span("mla.prefill", rows=B, tokens=B * T, slots=span):
            kv = _mm(lat[..., :C], lp["w_kv_b"], cdtype).view(
                B, span, H, N + V)
            k = torch.cat([kv[..., :N], lat[:, :, None, C:].expand(
                B, span, H, R).float()], dim=-1).to(cdtype)
            k = k.permute(0, 2, 3, 1)                       # [B, H, N+R, span]
            v = kv[..., N:].to(cdtype).transpose(1, 2)     # [B, H, span, V]
            del kv
            qf = torch.cat([q[..., :N], q_rope], dim=-1).to(cdtype)
            qf = qf.transpose(1, 2)                         # [B, H, T, N+R]
            ctx = torch.empty(B, T, H, V, dtype=torch.float32,
                              device=hidden.device)
            rows = max(1, _SCORE_ELEMS // (H * T * span))
            for s in range(0, B, rows):
                e = min(B, s + rows)
                b = e - s
                sc = bmm_f32(qf[s:e].reshape(b * H, T, N + R),
                             k[s:e].reshape(b * H, N + R, span))
                sc = sc.view(b, H, T, span)
                sc.mul_(scale).add_(mask[s:e, None])
                p = torch.softmax(sc, dim=-1).to(cdtype)
                del sc
                o = bmm_f32(p.view(b * H, T, span),
                            v[s:e].reshape(b * H, span, V))
                ctx[s:e] = o.view(b, H, T, V).transpose(1, 2)
            ctx = ctx.reshape(B, T, H * V)
    return _mm(ctx.to(cdtype), lp["o_w"], cdtype)
