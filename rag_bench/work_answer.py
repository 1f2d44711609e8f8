"""The yardstick of the ``answer`` kind: operations and bytes that a
DeepSeek-V2 answer batch needs, whatever implements it, from the HF
config.json values (``cfg``, attribute access) and the batch's real
prompt lengths. Peaks and the least-time rule are ``work.py``'s.

- Weights are bf16 (2 bytes a value); every weight but the embedding is
  read once a forward, the embedding's rows of the forward's tokens.
- Prefill counts the real prompt tokens of each row (not its padding):
  every projection and expert product of each token (its k routed
  experts), K and V decompressed from the latent, causal attention over
  the row's own tokens, the latent cache written, the head on each row's
  last token.
- A decode step counts one token a row: the projections, the absorbed
  attention (the query through W_uk, scores and context over the row's
  latent cache up to its slot, W_uv), the k routed experts, the head, and
  the latent cache read up to the slot and written at it.
"""

from __future__ import annotations

from typing import Sequence

from rag_bench import work

BF16 = 2.0


def _moe(cfg, i: int) -> bool:
    return (getattr(cfg, "n_routed_experts", None) is not None
            and i >= cfg.first_k_dense_replace
            and i % getattr(cfg, "moe_layer_freq", 1) == 0)


def n_moe_layers(cfg) -> int:
    return sum(_moe(cfg, i) for i in range(cfg.num_hidden_layers))


def latent_width(cfg) -> int:
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def _attn_params(cfg) -> int:
    h, H = cfg.hidden_size, cfg.num_attention_heads
    N, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    C, V = cfg.kv_lora_rank, cfg.v_head_dim
    return (h * H * (N + R) + h * (C + R) + C + C * H * (N + V)
            + H * V * h + 2 * h)


def expert_params(cfg) -> int:
    """One routed expert's three matrices."""
    return 3 * cfg.hidden_size * cfg.moe_intermediate_size


def _ffn_params(cfg, i: int) -> int:
    h = cfg.hidden_size
    if not _moe(cfg, i):
        return 3 * h * cfg.intermediate_size
    shared = 3 * h * cfg.moe_intermediate_size * (cfg.n_shared_experts or 0)
    return h * cfg.n_routed_experts + cfg.n_routed_experts * \
        expert_params(cfg) + shared


def weight_bytes(cfg) -> float:
    """Every weight but the embedding table, bf16."""
    n = sum(_attn_params(cfg) + _ffn_params(cfg, i)
            for i in range(cfg.num_hidden_layers))
    n += cfg.hidden_size + cfg.vocab_size * cfg.hidden_size
    return BF16 * n


def expert_bytes(cfg) -> float:
    """Every routed expert of every layer, bf16: what a forward over more
    tokens than experts reads of them."""
    return BF16 * n_moe_layers(cfg) * cfg.n_routed_experts * \
        expert_params(cfg)


def expert_pair_flops(cfg) -> float:
    """One (token, routed expert) pair: gate, up and down."""
    return 2.0 * expert_params(cfg)


def _token_flops(cfg, absorbed: bool) -> float:
    """A token's projections and FFNs over all layers (no attention
    scores or context), without the head."""
    h, H = cfg.hidden_size, cfg.num_attention_heads
    N, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    C, V = cfg.kv_lora_rank, cfg.v_head_dim
    # q and kv_a, then W_kv_b (decompressed) or W_uk and W_uv (absorbed),
    # then o_proj.
    per_layer = h * H * (N + R) + h * (C + R) + H * V * h
    per_layer += H * (N * C + C * V) if absorbed else C * H * (N + V)
    total = 0.0
    for i in range(cfg.num_hidden_layers):
        f = per_layer
        if _moe(cfg, i):
            f += h * cfg.n_routed_experts
            f += cfg.num_experts_per_tok * expert_params(cfg)
            f += 3 * h * cfg.moe_intermediate_size * \
                (cfg.n_shared_experts or 0)
        else:
            f += 3 * h * cfg.intermediate_size
        total += 2.0 * f
    return total


def prefill_flops(cfg, lens: Sequence[int]) -> float:
    H, L = cfg.num_attention_heads, cfg.num_hidden_layers
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    tok = _token_flops(cfg, absorbed=False)
    head = 2.0 * cfg.hidden_size * cfg.vocab_size
    total = 0.0
    for n in lens:
        pairs = n * (n + 1) / 2.0
        total += n * tok + head
        total += L * 2.0 * H * (qk + cfg.v_head_dim) * pairs
    return total


def prefill_bytes(cfg, lens: Sequence[int]) -> float:
    tokens = float(sum(lens))
    return (weight_bytes(cfg) + tokens * cfg.hidden_size * BF16
            + tokens * cfg.num_hidden_layers * latent_width(cfg) * BF16)


def decode_flops(cfg, ctx: Sequence[int]) -> float:
    """One decode step; ``ctx`` is each row's cached positions after the
    step's write (its real prompt, the tokens so far, the new one)."""
    H, L = cfg.num_attention_heads, cfg.num_hidden_layers
    C, R = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    per_row = _token_flops(cfg, absorbed=True) + \
        2.0 * cfg.hidden_size * cfg.vocab_size
    return len(ctx) * per_row + sum(
        L * 2.0 * H * ((C + R) + C) * n for n in ctx)


def decode_bytes(cfg, ctx: Sequence[int]) -> float:
    lw = cfg.num_hidden_layers * latent_width(cfg) * BF16
    return (weight_bytes(cfg) + len(ctx) * cfg.hidden_size * BF16
            + sum(ctx) * lw + len(ctx) * lw)


def batch_least_s(cfg, lens: Sequence[int], max_new: int, peak) -> float:
    """A whole answer batch: its prefill and its ``max_new - 1`` decode
    forwards (the last token's forward is never run), each at the larger
    of its two bounds."""
    least = work.least_s(prefill_flops(cfg, lens), prefill_bytes(cfg, lens),
                         peak)
    for i in range(max_new - 1):
        ctx = [n + i + 1 for n in lens]
        least += work.least_s(decode_flops(cfg, ctx), decode_bytes(cfg, ctx),
                              peak)
    return least


def experts_least_s(cfg, routed_pairs: int, peak) -> float:
    """One forward's routed experts: its (token, expert) pairs' products,
    and every expert's three matrices read once."""
    return work.least_s(routed_pairs * expert_pair_flops(cfg),
                        expert_bytes(cfg), peak)
