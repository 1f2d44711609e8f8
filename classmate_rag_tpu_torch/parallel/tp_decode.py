"""Tensor-parallel (dp×tp) decode for the generation models (port of the
JAX package's ``parallel/tp_decode.py``).

An 8B route model at bf16 needs ~16 GB for its weights alone; dp×tp
decode splits it over a ("data", "model") mesh, Megatron-style and
head-aligned, as the JAX package does:

- Q/K/V and gate/up column-split over "model": each rank owns
  ``heads/tp`` query heads and ``kv_heads/tp`` KV heads (the model axis
  divides kv_heads), so GQA runs rank-local;
- o_proj and down_proj row-split: each rank returns its partial sums,
  which ``tensor.reduce_sum`` adds in rank order before the residual
  add (the psum XLA inserts);
- the KV cache split over its kv-head axis, one [L, B/dp, KH/tp, S, D]
  pair a rank;
- the batch split over "data";
- lm_head split over the vocabulary; the ranks' logits are concatenated
  in rank order before sampling, so an argmax tie still resolves to the
  lowest id;
- norms replicated on every rank; the token embedding and the final
  norm on each data row's first rank, where the row's residual stream
  lives.

The JAX package declares shardings and XLA GSPMD runs the forward once
over the mesh. Here one process drives the ranks in turn, each through
the single-device layer code (``decoder._attention``, ``decoder._mlp``)
at the rank's head counts. Greedy tokens equal ``make_generate_fn``'s
(up to near-ties: the partial sums add in another order); nucleus
sampling draws from one ``torch.Generator`` on the mesh's first device,
over the logits of every data row.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from classmate_rag_tpu_torch.device import (
    DeviceLike,
    pin_fp32_matmul,
    resolve_device,
)
from classmate_rag_tpu_torch.models import decoder as D
from classmate_rag_tpu_torch.models.decoder import DecoderConfig, Params
from classmate_rag_tpu_torch.parallel.mesh import DeviceMesh, local_devices
from classmate_rag_tpu_torch.parallel.tensor import (
    gather,
    reduce_sum,
    shard,
    split_rows,
)

logger = logging.getLogger(__name__)

# rank_shards[d][m]: rank m of data row d's tree (``shard_decoder_params``).
RankShards = List[List[Params]]
# Only each data row's first rank embeds and applies the final norm.
FIRST_RANK_KEYS = ("tok_emb", "final_norm")


def decoder_param_specs(config: DecoderConfig) -> Dict[str, Any]:
    """The JAX package's PartitionSpecs of the stacked decoder tree, as
    tuples, on a ("data", "model") mesh."""
    layers = {
        "attn_norm": (None, None),
        "q_w": (None, None, "model"),
        "k_w": (None, None, "model"),
        "v_w": (None, None, "model"),
        "o_w": (None, "model", None),
        "ffn_norm": (None, None),
        "gate_w": (None, None, "model"),
        "up_w": (None, None, "model"),
        "down_w": (None, "model", None),
    }
    if config.qkv_bias:
        layers["q_b"] = (None, "model")
        layers["k_b"] = (None, "model")
        layers["v_b"] = (None, "model")
    if config.qk_norm:
        # Per-head norms are [L, head_dim]: within a head, replicated.
        layers["q_norm"] = (None, None)
        layers["k_norm"] = (None, None)
    return {
        "tok_emb": (None, None),
        "final_norm": (None,),
        "lm_head": (None, "model"),
        "layers": layers,
    }


def check_tp_divisibility(config: DecoderConfig, mesh: DeviceMesh) -> None:
    """TP splits must be head-aligned: the model axis has to divide
    kv_heads (each rank owns whole KV heads, GQA stays local) and the
    FFN width."""
    tp = mesh.shape["model"]
    if config.kv_heads % tp:
        raise ValueError(
            f"tensor-parallel degree {tp} must divide kv_heads="
            f"{config.kv_heads} (head-aligned sharding)"
        )
    if config.ffn % tp:
        raise ValueError(
            f"tensor-parallel degree {tp} must divide ffn={config.ffn}"
        )


def auto_mesh_for(config: DecoderConfig,
                  devices: Optional[Sequence[DeviceLike]] = None
                  ) -> DeviceMesh:
    """A ("data", "model") mesh whose tp degree divides this model's
    kv_heads and FFN width: the largest divisor of the device count, up
    to 8, that does (the training mesh picks the largest tp <= 4 whatever
    the head count). ``devices`` default: the CUDA cards."""
    devs = (list(devices) if devices is not None
            else local_devices(resolve_device(None)))
    n = len(devs)
    tp = 1
    # Any divisor of the device count works as a tp degree as long as it
    # also divides kv_heads and ffn (tp 3 or 6 on 6 devices with
    # kv_heads 6; powers of two alone would fall to tp 1).
    for cand in sorted(
        (c for c in range(2, min(n, 8) + 1) if n % c == 0), reverse=True
    ):
        if config.kv_heads % cand == 0 and config.ffn % cand == 0:
            tp = cand
            break
    if tp == 1 and n > 1:
        # Replicated defeats the memory purpose of tp; say so, so that an
        # out-of-memory on a multi-card mesh is attributable.
        logger.warning(
            "auto_mesh_for: no tp degree dividing %d devices also divides "
            "kv_heads=%d and ffn=%d — model will be REPLICATED (tp=1)",
            n, config.kv_heads, config.ffn,
        )
    return DeviceMesh([devs[d * tp:(d + 1) * tp] for d in range(n // tp)])


def rank_config(config: DecoderConfig, tp: int) -> DecoderConfig:
    """The config a rank runs the single-device layer code at: its share
    of the heads, KV heads and FFN width, the model's head_dim."""
    return dataclasses.replace(
        config, heads=config.heads // tp, kv_heads=config.kv_heads // tp,
        ffn=config.ffn // tp, head_dim_override=config.head_dim)


def shard_decoder_params(params: Params, config: DecoderConfig,
                         mesh: DeviceMesh) -> RankShards:
    """The decoder tree (numpy or tensors, unquantized) placed on the
    mesh in the tp layout: ``out[d][m]`` is rank m of data row d's tree,
    each split leaf a contiguous copy of its piece, matmul weights in
    the compute dtype and every other leaf in f32 (as
    ``decoder.params_from_numpy`` places them). Data rows share a
    device's tensors where their ranks share a device."""
    check_tp_divisibility(config, mesh)
    specs = decoder_param_specs(config)
    tp = mesh.shape["model"]
    if any(D._is_qtensor(v)
           for v in (*params.values(), *params["layers"].values())):
        raise ValueError("a quantized tree does not shard: dp×tp decode "
                         "runs bf16 weights")
    if any(d.type == "cuda" for row in mesh.devices for d in row):
        pin_fp32_matmul()

    def put(key, leaf, spec, m, dev):
        dtype = (config.compute_dtype if key in D._MATMUL_KEYS
                 else torch.float32)
        piece = shard(leaf, spec, tp, m)
        if isinstance(piece, torch.Tensor):
            return piece.to(dev, dtype, copy=True).contiguous()
        return torch.tensor(np.asarray(piece, np.float32),
                            device=dev).to(dtype)

    def rank_tree(m, dev):
        tree = {k: put(k, params[k], specs[k], m, dev)
                for k in ("tok_emb", "final_norm", "lm_head")
                if m == 0 or k not in FIRST_RANK_KEYS}
        tree["layers"] = {k: put(k, v, specs["layers"][k], m, dev)
                          for k, v in params["layers"].items()}
        return tree

    first = [rank_tree(m, dev) for m, dev in enumerate(mesh[0])]
    out = [first]
    for row in mesh.devices[1:]:
        out.append([_to(first[m], dev) for m, dev in enumerate(row)])
    return out


def _to(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)          # the same tensor on the same device


def rank_param_bytes(rank_shards: RankShards) -> List[List[int]]:
    """Bytes of each rank's weights, [d][m]."""
    return [[D.quantized_param_bytes(t) for t in row] for row in rank_shards]


def empty_tp_cache(config: DecoderConfig, mesh: DeviceMesh, batch: int,
                   max_seq: int) -> List[List[Tuple[torch.Tensor,
                                                     torch.Tensor]]]:
    """Each rank's zeroed K/V pair, [L, batch/dp, kv_heads/tp, S, D]."""
    rcfg = rank_config(config, mesh.shape["model"])
    b = batch // mesh.shape["data"]
    return [[D.empty_cache(rcfg, b, max_seq, device=dev) for dev in row]
            for row in mesh.devices]


def tp_forward(rank_shards: RankShards, input_ids: torch.Tensor,
               positions: torch.Tensor, caches, cache_offset: int,
               config: DecoderConfig, mesh: DeviceMesh,
               attn_mask: torch.Tensor,
               last_only: bool = False) -> torch.Tensor:
    """``decoder.forward`` over the mesh: logits [B, T, V] f32 on the
    mesh's first device ([B, 1, V] with ``last_only``); each rank's cache
    (``empty_tp_cache``) written in place at slots [cache_offset,
    cache_offset + T)."""
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    rcfg = rank_config(config, tp)
    offset = int(cache_offset)
    if offset < 0 or offset + input_ids.shape[1] > caches[0][0][0].shape[3]:
        raise ValueError(
            f"cache slots [{offset}, {offset + input_ids.shape[1]}) outside "
            f"a cache of {caches[0][0][0].shape[3]}")
    cos, sin = D._rope_tables(positions, config.head_dim, config.rope_theta)
    rows = []
    for d, sl in enumerate(split_rows(input_ids.shape[0], dp)):
        devs, trees = mesh[d], rank_shards[d]
        local = [(cos[sl].to(dev), sin[sl].to(dev), attn_mask[sl].to(dev))
                 for dev in devs]
        x = D._embed(trees[0]["tok_emb"], input_ids[sl].to(devs[0]))
        for i in range(config.layers):
            lps = [D._layer_params(t["layers"], i) for t in trees]
            x = x + reduce_sum([
                D._attention(lps[m], x.to(dev), c, s, caches[d][m][0][i],
                             caches[d][m][1][i], offset, mk, rcfg)
                for m, (dev, (c, s, mk)) in enumerate(zip(devs, local))])
            x = x + reduce_sum([D._mlp(lps[m], x.to(dev), rcfg)
                                for m, dev in enumerate(devs)])
        if last_only:
            x = x[:, -1:]
        x = D._rms_norm(x, trees[0]["final_norm"],
                        config.norm_eps).to(config.compute_dtype)
        rows.append(gather([D._mm(x.to(dev), t["lm_head"],
                                  config.compute_dtype)
                            for dev, t in zip(devs, trees)], -1))
    return gather(rows, 0).to(mesh[0][0])


def make_tp_generate_fn(config: DecoderConfig, mesh: DeviceMesh,
                        max_seq: int, max_new: int):
    """A dp×tp generate function: ``make_generate_fn``'s signature, with
    ``shard_decoder_params``' rank trees in place of the params; greedy
    tokens equal its tokens. The batch must divide over "data"."""
    check_tp_divisibility(config, mesh)

    def generate(rank_shards, prompt_ids, prompt_len, seed, temperature,
                 top_p, eos_ids, on_logits=None):
        caches = None

        def forward_last(ids, positions, offset, mask):
            nonlocal caches
            if caches is None:
                split_rows(ids.shape[0], mesh.shape["data"])
                caches = empty_tp_cache(config, mesh, ids.shape[0], max_seq)
            return tp_forward(rank_shards, ids, positions, caches, offset,
                              config, mesh, mask, last_only=True)[:, -1, :]

        return D.decode_loop(forward_last, mesh[0][0], prompt_ids,
                             prompt_len, seed, temperature, top_p, eos_ids,
                             max_seq, max_new, on_logits=on_logits)

    return generate
