"""Causal decoder LM in PyTorch (port of the JAX package's
``models/decoder.py``): the LLaMA, Qwen2 and Qwen3 families with a
preallocated KV cache, int8 W8A8 weights and a static-horizon generate
loop.

- Parameters are the JAX package's tree: per-layer tensors stacked on a
  leading [L, ...] axis under ``"layers"``. ``init_params`` draws it in
  numpy value for value as the JAX package does, ``load_params_from_hf``
  converts an HF checkpoint into it, and ``params_from_numpy`` places it
  on a device (matmul weights in ``compute_dtype``, which the reference
  casts them to at every use; ``tok_emb``, norm gains and QKV biases in
  f32; ``QTensor`` leaves as int8 + f32 scales).
- Matmuls take ``compute_dtype`` operands and return f32 sums, as the
  reference's ``preferred_element_type=f32`` does (``mm_f32`` and
  ``bmm_f32``; on the CPU the operands are upcast). W8A8 products run
  ``torch._int_mm`` with the reference's epilogue order.
- The KV cache is one preallocated bf16 pair written in place, laid out
  head-major, [L, B, KH, S, D]: each (row, kv head) is then one
  contiguous [S, D] matrix, and attention is one strided-batched product
  over the cache as it lies. The reference's [L, B, S, KH, D] would make
  every layer copy the whole cache into that order at every step.
- GQA groups the queries as [B, KH, H/KH, T, D] against the cache
  instead of repeating the cache's heads: the same products and sums.
- ``lax.scan`` over layers and steps becomes Python loops. The decode
  loop keeps its done flags on the device and never reads a value back
  before the horizon ends. Sampled decoding draws from a
  ``torch.Generator`` seeded by ``seed`` (JAX's key stream cannot be
  reproduced); greedy decoding (temperature <= 0) gives JAX's tokens.

DeepSeek-V2 (``model_type`` deepseek_v2, ``DecoderConfig.deepseek_v2_lite``)
runs through the same ``forward``, ``decode_loop`` and
``make_generate_fn``: a config with ``mla`` attends with multi-head latent
attention over a latent cache [L, B, S, kv_lora_rank + qk_rope_dim]
(``models/mla.py``), and with ``moe`` its layers from ``first_dense`` on
run sparse experts (``models/moe.py``). Its tree is a list of per-layer
dicts (the dense and the expert layers differ), built on the device by
``hf_state.params_from_hf_state`` from an HF-named state dict.

Every entry point runs on the device of the parameters it is given;
``params_from_numpy(..., device=None)`` places them on CUDA. A layer is
its attention and SwiGLU blocks (``_attention``, ``_mlp``) and the
generate loop takes any forward (``decode_loop``), so that the dp×tp
decode (``parallel/tp_decode.py``) runs them on each rank.
"""

from __future__ import annotations

import dataclasses
import json
import math
from contextlib import contextmanager
from hashlib import blake2b
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from classmate_rag_tpu_torch.device import (
    DeviceLike,
    pin_fp32_matmul,
    resolve_device,
)
from classmate_rag_tpu_torch.embeddings.model import mm_f32
from classmate_rag_tpu_torch.utils.metrics import metrics
from classmate_rag_tpu_torch.utils.numerics import NEG_INF


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    kv_heads: int = 4
    ffn: int = 2048
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16
    # Family switches: Qwen2 puts biases on the QKV projections; Qwen3
    # RMS-normalises Q and K per head before RoPE and states a head_dim
    # that need not equal hidden/heads.
    qkv_bias: bool = False
    qk_norm: bool = False
    head_dim_override: Optional[int] = None
    # DeepSeek-V2: latent attention (``mla.MLAConfig``) and sparse
    # experts (``moe.MoEConfig``); None in the dense GQA families.
    mla: Optional[Any] = None
    moe: Optional[Any] = None

    @property
    def head_dim(self) -> int:
        if self.mla is not None:
            return self.mla.qk_nope_dim + self.mla.qk_rope_dim
        return self.head_dim_override or self.hidden // self.heads

    @property
    def latent(self) -> bool:
        """Whether the tree and cache are the MLA/MoE kind (per-layer
        dicts, one latent cache) rather than the stacked GQA kind."""
        return self.mla is not None or self.moe is not None

    @classmethod
    def small(cls) -> "DecoderConfig":
        return cls()

    @classmethod
    def tiny_test(cls) -> "DecoderConfig":
        return cls(vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2,
                   ffn=128, max_seq=128)

    @classmethod
    def llama3_8b(cls) -> "DecoderConfig":
        return cls(vocab_size=128256, hidden=4096, layers=32, heads=32,
                   kv_heads=8, ffn=14336, max_seq=8192)

    @classmethod
    def qwen2_7b(cls) -> "DecoderConfig":
        """Qwen2.5-7B shape (also DeepSeek-R1-Distill-Qwen-7B)."""
        return cls(vocab_size=152064, hidden=3584, layers=28, heads=28,
                   kv_heads=4, ffn=18944, max_seq=32768,
                   rope_theta=1000000.0, norm_eps=1e-6, qkv_bias=True)

    @classmethod
    def qwen3_8b(cls) -> "DecoderConfig":
        return cls(vocab_size=151936, hidden=4096, layers=36, heads=32,
                   kv_heads=8, ffn=12288, max_seq=32768,
                   rope_theta=1000000.0, norm_eps=1e-6, qk_norm=True,
                   head_dim_override=128)

    @classmethod
    def deepseek_v2_lite(cls) -> "DecoderConfig":
        """DeepSeek-V2-Lite's published config.json (15.7 B parameters):
        MLA without a query LoRA, one dense layer, 26 layers of 64 routed
        experts (top-6) and 2 shared, YaRN RoPE (factor 40)."""
        return cls.from_hf_dict({
            "model_type": "deepseek_v2", "vocab_size": 102400,
            "hidden_size": 2048, "num_hidden_layers": 27,
            "num_attention_heads": 16, "num_key_value_heads": 16,
            "intermediate_size": 10944, "max_position_embeddings": 163840,
            "rope_theta": 10000, "rms_norm_eps": 1e-6,
            "kv_lora_rank": 512, "q_lora_rank": None,
            "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
            "v_head_dim": 128, "n_routed_experts": 64,
            "num_experts_per_tok": 6, "moe_intermediate_size": 1408,
            "n_shared_experts": 2, "first_k_dense_replace": 1,
            "moe_layer_freq": 1, "routed_scaling_factor": 1.0,
            "norm_topk_prob": False, "topk_method": "greedy",
            "scoring_func": "softmax",
            "rope_scaling": {"type": "yarn", "factor": 40,
                             "original_max_position_embeddings": 4096,
                             "beta_fast": 32, "beta_slow": 1,
                             "mscale": 0.707, "mscale_all_dim": 0.707}})

    @classmethod
    def from_hf_config(cls, model_dir: str | Path) -> Optional["DecoderConfig"]:
        """Build the config from an HF checkpoint's config.json. None when
        no readable config is present."""
        path = Path(model_dir) / "config.json"
        if not path.exists():
            return None
        try:
            raw = json.loads(path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            return None
        return cls.from_hf_dict(raw)

    @classmethod
    def from_hf_dict(cls, raw: Dict[str, Any]) -> Optional["DecoderConfig"]:
        """``from_hf_config`` of a parsed config.json. None when a key is
        missing or unreadable; a DeepSeek-V2 variant the port does not
        run (a query LoRA, grouped or sigmoid routing, renormalised
        top-k, sparse layers at a stride) raises NotImplementedError."""
        try:
            model_type = str(raw.get("model_type", "llama")).lower()
            if model_type == "deepseek_v2":
                return cls._from_deepseek_v2(raw)
            # Qwen2's HF module hardcodes bias=True on q/k/v; LLaMA and
            # Qwen3 read it from `attention_bias` (default False).
            qkv_bias = bool(raw.get("attention_bias", model_type == "qwen2"))
            head_dim = raw.get("head_dim")
            return cls(
                vocab_size=int(raw["vocab_size"]),
                hidden=int(raw["hidden_size"]),
                layers=int(raw["num_hidden_layers"]),
                heads=int(raw["num_attention_heads"]),
                kv_heads=int(raw.get("num_key_value_heads",
                                     raw["num_attention_heads"])),
                ffn=int(raw["intermediate_size"]),
                max_seq=int(raw.get("max_position_embeddings", 8192)),
                # HF treats an absent rope_theta as 10000 (LLaMA-2 era).
                rope_theta=float(raw.get("rope_theta", 10000.0)),
                norm_eps=float(raw.get("rms_norm_eps", 1e-5)),
                qkv_bias=qkv_bias,
                qk_norm=model_type == "qwen3",
                head_dim_override=int(head_dim) if head_dim else None,
            )
        except (KeyError, TypeError, ValueError):
            return None

    @classmethod
    def _from_deepseek_v2(cls, raw: Dict[str, Any]) -> "DecoderConfig":
        from classmate_rag_tpu_torch.models.mla import MLAConfig, Yarn
        from classmate_rag_tpu_torch.models.moe import MoEConfig

        refused = [what for what, bad in (
            ("a query LoRA (q_lora_rank)", raw.get("q_lora_rank")),
            ("attention biases", raw.get("attention_bias")),
            ("top-k method other than greedy",
             raw.get("topk_method", "greedy") != "greedy"),
            ("a router scoring other than softmax",
             raw.get("scoring_func", "softmax") != "softmax"),
            ("renormalised top-k weights", raw.get("norm_topk_prob")),
            ("expert layers at a stride (moe_layer_freq != 1)",
             int(raw.get("moe_layer_freq", 1)) != 1),
        ) if bad]
        rs = raw.get("rope_scaling")
        if rs and rs.get("type", rs.get("rope_type")) != "yarn":
            refused.append(f"rope_scaling {rs!r}")
        if refused:
            raise NotImplementedError(
                "this DeepSeek-V2 variant is not supported by the port's "
                "decoder: " + ", ".join(refused))
        yarn = None if not rs else Yarn(
            factor=float(rs["factor"]),
            original_max_seq=int(rs["original_max_position_embeddings"]),
            beta_fast=float(rs.get("beta_fast", 32)),
            beta_slow=float(rs.get("beta_slow", 1)),
            mscale=float(rs.get("mscale", 1)),
            mscale_all_dim=float(rs.get("mscale_all_dim", 0)))
        heads = int(raw["num_attention_heads"])
        n_routed = raw.get("n_routed_experts")
        return cls(
            vocab_size=int(raw["vocab_size"]),
            hidden=int(raw["hidden_size"]),
            layers=int(raw["num_hidden_layers"]),
            heads=heads,
            kv_heads=int(raw.get("num_key_value_heads", heads)),
            ffn=int(raw["intermediate_size"]),
            max_seq=int(raw.get("max_position_embeddings", 8192)),
            rope_theta=float(raw.get("rope_theta", 10000.0)),
            norm_eps=float(raw.get("rms_norm_eps", 1e-6)),
            mla=MLAConfig(
                kv_lora_rank=int(raw["kv_lora_rank"]),
                qk_nope_dim=int(raw["qk_nope_head_dim"]),
                qk_rope_dim=int(raw["qk_rope_head_dim"]),
                v_head_dim=int(raw["v_head_dim"]), yarn=yarn),
            moe=None if not n_routed else MoEConfig(
                n_experts=int(n_routed),
                experts_per_token=int(raw["num_experts_per_tok"]),
                expert_ffn=int(raw["moe_intermediate_size"]),
                n_shared=int(raw.get("n_shared_experts") or 0),
                first_dense=int(raw.get("first_k_dense_replace", 0)),
                routed_scale=float(raw.get("routed_scaling_factor", 1.0))),
        )


Params = Dict[str, Any]


class QTensor(NamedTuple):
    """Per-output-channel symmetric int8 weight: ``q * scale`` ≈ w.

    Activations quantize dynamically per token (W8A8 symmetric) and the
    product runs int8 × int8 → int32. Decode reads one byte a weight
    instead of two. ``q`` and ``scale`` are tensors on the device, or
    numpy arrays in a host tree (``quantize_decoder_params_host``).
    """

    q: Any        # int8, weight shape
    scale: Any    # f32, per output channel (last axis of q)


# Weight leaves that are quantized: every 2-D matmul operand. Norm gains
# and QKV biases stay f32; tok_emb is quantized for the gather.
_QUANT_LAYER_KEYS = (
    "q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w",
)


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Symmetric per-out-channel int8 quantization (last axis = out,
    amax over every other axis)."""
    w = torch.as_tensor(w).float()
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return QTensor(q, scale)


def _col_major(q: torch.Tensor) -> torch.Tensor:
    """The same [..., in, out] values with each matrix stored column-major:
    cuBLAS's int8 product (and the CPU's) reads B that way several times
    faster than row-major (tools/torch_decode_probe.py times both on the
    card)."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_decoder_params(params: Params, config: DecoderConfig) -> Params:
    """int8-quantize the matmul weights of a decoder tree of tensors, on
    the tensors' device.

    Per-layer stacks [L, in, out] quantize per (layer, out) channel, one
    layer at a time (an 8B stack's f32 copy would be 7.5 GB). The values
    are those of the tensors given: f32 weights quantize as the JAX
    package's ``quantize_decoder_params`` does, bit for bit.
    """
    layers = dict(params["layers"])
    for key in _QUANT_LAYER_KEYS:
        w = torch.as_tensor(layers[key])                   # [L, in, out]
        L, n_in, n_out = w.shape
        q = torch.empty((L, n_out, n_in), dtype=torch.int8, device=w.device)
        scale = torch.empty((L, n_out), dtype=torch.float32, device=w.device)
        for i in range(L):
            qi, scale[i] = quantize_tensor(w[i])
            q[i] = qi.t()
        layers[key] = QTensor(q.transpose(1, 2), scale)
    out = dict(params)
    out["layers"] = layers
    lm = quantize_tensor(params["lm_head"])
    out["lm_head"] = QTensor(_col_major(lm.q), lm.scale)
    # Token embedding: int8 rows + per-hidden-channel scale; the gather
    # dequantizes the few looked-up rows only.
    out["tok_emb"] = quantize_tensor(params["tok_emb"])
    return out


def quantize_decoder_params_host(params: Params,
                                 config: DecoderConfig) -> Params:
    """numpy twin of ``quantize_decoder_params`` for host trees, so that
    only int8 + scales cross to the card. Same math (np.rint and
    torch.round both round half to even)."""

    def np_qt(w: np.ndarray) -> QTensor:
        w = np.asarray(w, np.float32)
        amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
        scale = np.maximum(amax, 1e-12).astype(np.float32) / 127.0
        q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        return QTensor(q, scale)

    layers = dict(params["layers"])
    for key in _QUANT_LAYER_KEYS:
        w = np.asarray(layers[key], np.float32)            # [L, in, out]
        amax = np.max(np.abs(w), axis=1)                   # [L, out]
        scale = np.maximum(amax, 1e-12).astype(np.float32) / 127.0
        q = np.clip(
            np.rint(w / scale[:, None, :]), -127, 127
        ).astype(np.int8)
        layers[key] = QTensor(q, scale)
    out = dict(params)
    out["layers"] = layers
    out["lm_head"] = np_qt(params["lm_head"])
    out["tok_emb"] = np_qt(params["tok_emb"])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, QTensor):
        yield from tree
    else:
        yield tree


def quantized_param_bytes(params: Params) -> int:
    """Bytes of every leaf of a tree (tensors or numpy arrays)."""
    return sum(
        x.numel() * x.element_size() if isinstance(x, torch.Tensor)
        else np.asarray(x).nbytes
        for x in _leaves(params)
    )


def _is_qtensor(leaf) -> bool:
    # The JAX package's QTensor is another class with the same fields.
    return getattr(leaf, "_fields", None) == ("q", "scale")


# Leaves stored in compute_dtype; every other float leaf stays f32.
_MATMUL_KEYS = frozenset(_QUANT_LAYER_KEYS + ("lm_head",))


def params_from_numpy(tree: Params, config: DecoderConfig,
                      device: DeviceLike = None) -> Params:
    """The JAX package's decoder tree (numpy, ``QTensor`` leaves
    included) placed on ``device`` (None → CUDA). Each leaf is a copy;
    int8 matmul weights are stored column-major (``_col_major``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32_matmul()

    def put(key, leaf):
        if _is_qtensor(leaf):
            q, scale = leaf
            q = torch.as_tensor(np.asarray(q, np.int8)).to(dev, copy=True)
            if key in _MATMUL_KEYS:
                q = _col_major(q)
            return QTensor(q, torch.as_tensor(
                np.asarray(scale, np.float32)).to(dev, copy=True))
        dtype = config.compute_dtype if key in _MATMUL_KEYS else torch.float32
        arr = np.asarray(leaf, np.float32)
        return torch.as_tensor(arr).to(dev, dtype=dtype, copy=True)

    out = {k: put(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: put(k, v) for k, v in tree["layers"].items()}
    return out


def init_params(config: DecoderConfig, seed_key: str) -> Params:
    """Deterministic random params as a numpy tree, drawn value for value
    as the JAX package's ``init_params`` draws them."""
    if config.latent:
        raise ValueError(
            "init_params draws the stacked GQA tree on the host; an MLA/MoE "
            "config draws on the device: hf_state.SeededHFState and "
            "params_from_hf_state")
    seed = int.from_bytes(blake2b(seed_key.encode(), digest_size=4).digest(), "little")
    rng = np.random.default_rng(seed)
    h, L, ff = config.hidden, config.layers, config.ffn
    qh = config.heads * config.head_dim
    kvh = config.kv_heads * config.head_dim

    def norm(*shape):
        return rng.normal(0.0, 0.02, size=shape).astype(np.float32)

    layers: Dict[str, np.ndarray] = {
        "attn_norm": np.ones((L, h), np.float32),
        "q_w": norm(L, h, qh),
        "k_w": norm(L, h, kvh),
        "v_w": norm(L, h, kvh),
        "o_w": norm(L, qh, h),
        "ffn_norm": np.ones((L, h), np.float32),
        "gate_w": norm(L, h, ff),
        "up_w": norm(L, h, ff),
        "down_w": norm(L, ff, h),
    }
    if config.qkv_bias:
        layers["q_b"] = norm(L, qh)
        layers["k_b"] = norm(L, kvh)
        layers["v_b"] = norm(L, kvh)
    if config.qk_norm:
        layers["q_norm"] = np.ones((L, config.head_dim), np.float32)
        layers["k_norm"] = np.ones((L, config.head_dim), np.float32)
    return {
        "tok_emb": norm(config.vocab_size, h),
        "final_norm": np.ones(h, np.float32),
        "lm_head": norm(h, config.vocab_size),
        "layers": layers,
    }


def _read_checkpoint(d: Path) -> Optional[Dict[str, np.ndarray]]:
    files = sorted(d.glob("*.safetensors")) or sorted(d.glob("pytorch_model*.bin"))
    if not files:
        return None
    sd: Dict[str, np.ndarray] = {}
    for f in files:
        if f.suffix == ".safetensors":
            # Needs the ``safetensors`` package, as in the JAX package.
            from safetensors.numpy import load_file

            sd.update(load_file(str(f)))
        else:
            part = torch.load(str(f), map_location="cpu", weights_only=True)
            sd.update({k: v.float().numpy() for k, v in part.items()})
    return sd


def load_params_from_hf(model_dir: str, config: DecoderConfig,
                        device: DeviceLike = None) -> Optional[Params]:
    """Convert an HF LLaMA/Qwen2/Qwen3 checkpoint into the stacked numpy
    tree; None when no weight file is found, a tensor is missing or the
    shapes are not the config's. A DeepSeek-V2 checkpoint (an MLA/MoE
    config) converts on ``device`` (None → CUDA) through
    ``hf_state.params_from_hf_state``: the tree is then of tensors."""
    if config.latent:
        from classmate_rag_tpu_torch.models import hf_state

        return hf_state.load_hf_checkpoint(Path(model_dir), config, device)
    sd = _read_checkpoint(Path(model_dir))
    if sd is None:
        return None

    def get(name: str) -> np.ndarray:
        for prefix in ("", "model."):
            if prefix + name in sd:
                return np.asarray(sd[prefix + name], dtype=np.float32)
        raise KeyError(name)

    try:
        keys = [
            "attn_norm", "q_w", "k_w", "v_w", "o_w",
            "ffn_norm", "gate_w", "up_w", "down_w",
        ]
        if config.qkv_bias:
            keys += ["q_b", "k_b", "v_b"]
        if config.qk_norm:
            keys += ["q_norm", "k_norm"]
        stacks: Dict[str, list] = {k: [] for k in keys}
        for i in range(config.layers):
            base = f"layers.{i}."
            stacks["attn_norm"].append(get(base + "input_layernorm.weight"))
            stacks["q_w"].append(get(base + "self_attn.q_proj.weight").T)
            stacks["k_w"].append(get(base + "self_attn.k_proj.weight").T)
            stacks["v_w"].append(get(base + "self_attn.v_proj.weight").T)
            stacks["o_w"].append(get(base + "self_attn.o_proj.weight").T)
            if config.qkv_bias:
                stacks["q_b"].append(get(base + "self_attn.q_proj.bias"))
                stacks["k_b"].append(get(base + "self_attn.k_proj.bias"))
                stacks["v_b"].append(get(base + "self_attn.v_proj.bias"))
            if config.qk_norm:
                stacks["q_norm"].append(get(base + "self_attn.q_norm.weight"))
                stacks["k_norm"].append(get(base + "self_attn.k_norm.weight"))
            stacks["ffn_norm"].append(get(base + "post_attention_layernorm.weight"))
            stacks["gate_w"].append(get(base + "mlp.gate_proj.weight").T)
            stacks["up_w"].append(get(base + "mlp.up_proj.weight").T)
            stacks["down_w"].append(get(base + "mlp.down_proj.weight").T)
        tok_emb = get("embed_tokens.weight")
        try:
            lm_head = get("lm_head.weight").T
        except KeyError:
            lm_head = tok_emb.T  # tied embeddings
        params: Params = {
            "tok_emb": tok_emb,
            "final_norm": get("norm.weight"),
            "lm_head": np.ascontiguousarray(lm_head),
            "layers": {k: np.stack(v) for k, v in stacks.items()},
        }
    except KeyError:
        return None
    # A checkpoint of the wrong size is rejected here, not inside the
    # forward's head reshapes.
    if params["tok_emb"].shape != (config.vocab_size, config.hidden):
        return None
    q_width = config.heads * config.head_dim
    if params["layers"]["q_w"].shape != (config.layers, config.hidden,
                                         q_width):
        return None
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

_BMM_OUT_DTYPE = hasattr(torch.ops.aten.bmm, "dtype")


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 [N, M, K'] = a [N, M, K] · b [N, K, K'] with f32 sums: the
    batched form of ``mm_f32`` (cuBLAS's bf16 → f32 strided-batched
    product on the card; upcast operands on the CPU)."""
    if (a.is_cuda and _BMM_OUT_DTYPE
            and a.dtype in (torch.bfloat16, torch.float16)):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 [M, N] = xq [M, K] · wq [K, N], int8 operands. cuBLAS's int8
    product needs more than 16 rows: a decode step's few rows are padded
    with zero rows, whose sums are dropped."""
    m = xq.shape[0]
    if xq.is_cuda and m <= 16:
        xq = torch.cat([xq, xq.new_zeros(32 - m, xq.shape[1])])
    return torch._int_mm(xq, wq)[:m]


def _mm(x: torch.Tensor, w, cdtype) -> torch.Tensor:
    """Last-dim contraction x[..., h] @ w[h, o] → f32.

    Dense weights: ``compute_dtype`` operands, f32 sums. QTensor weights:
    W8A8 with per-token activation scales, int8 × int8 → int32, and the
    reference's f32 epilogue ``acc * sx * scale``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QTensor):
        xf = x2.float()
        sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
        xq = torch.round(xf / sx).clamp_(-127, 127).to(torch.int8)
        out = _int_mm(xq, w.q).float() * sx * w.scale
    else:
        out = mm_f32(x2.to(cdtype), w)
    return out.reshape(*lead, out.shape[-1])


def _embed(tok_emb, input_ids: torch.Tensor) -> torch.Tensor:
    if isinstance(tok_emb, QTensor):
        return tok_emb.q[input_ids].float() * tok_emb.scale
    return tok_emb[input_ids].float()


def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    scale = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return x * scale * g


def _rope_tables(positions: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """[cos, cos] and [-sin, sin], [B, T, 1, D], of the half-split RoPE at
    ``positions``: the rotation is then x * cos' + [x2, x1] * sin', the
    reference's ``[x1 cos - x2 sin, x2 cos + x1 sin]`` with the same
    roundings, in four launches instead of seven."""
    half = head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], dim=-1)[:, :, None, :],
            torch.cat([-sin, sin], dim=-1)[:, :, None, :])


def _rope(x: torch.Tensor, cos: torch.Tensor,
          sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, D] f32."""
    half = x.shape[-1] // 2
    return x * cos + torch.cat([x[..., half:], x[..., :half]], dim=-1) * sin


def _attention(lp: Params, hidden: torch.Tensor, cos, sin,
               k_cache: torch.Tensor, v_cache: torch.Tensor, offset: int,
               attn_mask: torch.Tensor,
               config: DecoderConfig) -> torch.Tensor:
    """A layer's attention block up to its o_proj product, before the
    residual add: f32 [B, T, hidden]. Writes this step's K/V into the
    layer's cache ([B, KH, S, D]) at slots [offset, offset + T). On a
    tensor-parallel rank (``config`` at the rank's head counts, ``lp``
    its shards) it is the rank's partial sum of o_proj."""
    cdtype = config.compute_dtype
    B, T, _ = hidden.shape
    H, KH, D = config.heads, config.kv_heads, config.head_dim
    G = H // KH
    S = k_cache.shape[2]

    normed = _rms_norm(hidden, lp["attn_norm"], config.norm_eps).to(cdtype)
    q = _mm(normed, lp["q_w"], cdtype)
    k = _mm(normed, lp["k_w"], cdtype)
    v = _mm(normed, lp["v_w"], cdtype)
    if config.qkv_bias:  # Qwen2 family
        q = q + lp["q_b"]
        k = k + lp["k_b"]
        v = v + lp["v_b"]
    q = q.reshape(B, T, H, D)
    k = k.reshape(B, T, KH, D)
    v = v.reshape(B, T, KH, D)
    if config.qk_norm:  # Qwen3 family: per-head RMSNorm before RoPE
        q = _rms_norm(q, lp["q_norm"], config.norm_eps)
        k = _rms_norm(k, lp["k_norm"], config.norm_eps)
    q = _rope(q, cos, sin)
    k = _rope(k, cos, sin)
    k_cache[:, :, offset:offset + T] = k.transpose(1, 2)
    v_cache[:, :, offset:offset + T] = v.transpose(1, 2)

    # GQA: query head h = kh * G + g reads kv head kh.
    qg = (q.to(cdtype).reshape(B, T, KH, G, D).permute(0, 2, 3, 1, 4)
          .reshape(B * KH, G * T, D))
    kc = k_cache.reshape(B * KH, S, D).to(cdtype)
    vc = v_cache.reshape(B * KH, S, D).to(cdtype)
    scores = bmm_f32(qg, kc.transpose(1, 2)).view(B, KH, G, T, S)
    scores.div_(math.sqrt(D)).add_(attn_mask[:, None, None, :, :])
    probs = torch.softmax(scores, dim=-1).to(cdtype).view(B * KH, G * T, S)
    ctx = (bmm_f32(probs, vc).view(B, KH, G, T, D).permute(0, 3, 1, 2, 4)
           .reshape(B, T, H * D))
    return _mm(ctx.to(cdtype), lp["o_w"], cdtype)


def _mlp(lp: Params, hidden: torch.Tensor,
         config: DecoderConfig) -> torch.Tensor:
    """A layer's SwiGLU block up to its down_proj product, before the
    residual add (a tensor-parallel rank's partial sum)."""
    cdtype = config.compute_dtype
    normed2 = _rms_norm(hidden, lp["ffn_norm"], config.norm_eps).to(cdtype)
    gate = _mm(normed2, lp["gate_w"], cdtype)
    up = _mm(normed2, lp["up_w"], cdtype)
    ff = F.silu(gate) * up
    return _mm(ff.to(cdtype), lp["down_w"], cdtype)


def _layer(lp: Params, hidden: torch.Tensor, cos, sin, cache, offset: int,
           attn_mask: torch.Tensor, config: DecoderConfig,
           index: int) -> torch.Tensor:
    """Decoder layer ``index``; writes this step's K/V into the layer's
    cache at slots [offset, offset + T): a (K, V) pair [B, KH, S, D] in
    the GQA families, the latent cache [B, S, C + R] with MLA. The FFN is
    the layer's kind: SwiGLU, or sparse experts with ``moe``."""
    if config.mla is not None:
        hidden = hidden + _mla.mla_attention(lp, hidden, cos, sin, cache,
                                             offset, attn_mask, config)
    else:
        hidden = hidden + _attention(lp, hidden, cos, sin, cache[0],
                                     cache[1], offset, attn_mask, config)
    moe = config.moe
    if moe is not None and moe.is_moe(index):
        return hidden + _moe.moe_ffn(lp, hidden, config,
                                     index - moe.first_dense)
    if config.latent:
        normed = _rms_norm(hidden, lp["ffn_norm"], config.norm_eps)
        return hidden + _moe.swiglu(normed.to(config.compute_dtype),
                                    lp["gate_up_w"], lp["down_w"],
                                    config.compute_dtype)
    return hidden + _mlp(lp, hidden, config)


def _layer_params(layers: Params, i: int) -> Params:
    return {k: QTensor(v.q[i], v.scale[i]) if isinstance(v, QTensor)
            else v[i] for k, v in layers.items()}


def forward(
    params: Params,
    input_ids: torch.Tensor,         # [B, T]
    positions: torch.Tensor,         # [B, T] absolute positions
    kv_cache,                        # ([L,B,KH,S,D], ...) or [L,B,S,C+R]
    cache_offset,                    # write slot of input_ids[:, 0]
    config: DecoderConfig,
    attn_mask: torch.Tensor = None,  # [B, T, S] additive f32 — REQUIRED
    last_only: bool = False,
):
    """Returns (logits [B, T, V] f32, the kv cache, written in place at
    slots [cache_offset, cache_offset + T)). With ``last_only`` the head
    runs on the last position alone: logits [B, 1, V] (a prefill's
    [B, T, V] f32 logits are T times the memory and the head's work).
    With MLA and one position a row, ``cache_offset`` may be a [1] long
    tensor on the device: the step then attends over all S slots under
    ``attn_mask`` (static shapes, for a CUDA graph).

    ``attn_mask`` is required: a silent causal default would mask the
    left-padded prefill wrong."""
    if attn_mask is None:
        raise TypeError(
            "forward() requires attn_mask ([B, T, S] additive f32); see "
            "make_generate_fn for the left-padded prefill/decode masks"
        )
    if isinstance(cache_offset, torch.Tensor):
        # A decode step's write slot on the device ([1] long): MLA only,
        # one position a row (``_DecodeStep``); the slot is not read back.
        if config.mla is None or input_ids.shape[1] != 1:
            raise ValueError("a device cache_offset is one MLA position")
        offset = cache_offset
    else:
        offset = int(cache_offset)
        slots = kv_cache.shape[2] if config.latent else kv_cache[0].shape[3]
        if offset < 0 or offset + input_ids.shape[1] > slots:
            raise ValueError(
                f"cache slots [{offset}, {offset + input_ids.shape[1]}) "
                f"outside a cache of {slots}")
    if config.mla is not None:
        cos, sin = _mla.rope_tables(positions, config.mla, config.rope_theta)
    else:
        cos, sin = _rope_tables(positions, config.head_dim,
                                config.rope_theta)
    x = _embed(params["tok_emb"], input_ids)               # [B, T, h] f32
    layers = params["layers"]
    for i in range(config.layers):
        if config.latent:
            lp, cache = layers[i], kv_cache[i]
        else:
            lp = _layer_params(layers, i)
            cache = (kv_cache[0][i], kv_cache[1][i])
        x = _layer(lp, x, cos, sin, cache, offset, attn_mask, config, i)
    if last_only:
        x = x[:, -1:]
    x = _rms_norm(x, params["final_norm"], config.norm_eps)
    logits = _mm(x.to(config.compute_dtype), params["lm_head"],
                 config.compute_dtype)
    return logits, kv_cache


def empty_cache(config: DecoderConfig, batch: int,
                max_seq: Optional[int] = None, device: DeviceLike = None):
    """A zeroed bf16 K/V pair, [L, B, KH, S, D] each (head-major, see the
    module docstring); with MLA the latent cache [L, B, S, C + R] in
    ``compute_dtype``, one [c ‖ k_rope] row a position and layer. Zeros,
    not garbage: masked slots still enter the products, and NaN times a
    zero probability is NaN."""
    S = max_seq or config.max_seq
    dev = resolve_device(device)
    if config.mla is not None:
        return torch.zeros((config.layers, batch, S,
                            config.mla.latent_width),
                           dtype=config.compute_dtype, device=dev)
    shape = (config.layers, batch, config.kv_heads, S, config.head_dim)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            torch.zeros(shape, dtype=torch.bfloat16, device=dev))


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def _sample(logits: torch.Tensor, generator: torch.Generator,
            temperature: float, top_p: float) -> torch.Tensor:
    """Temperature + nucleus sampling; temperature <= 0 → greedy argmax
    (no draw). A sampled token is the Gumbel-max of the nucleus-filtered
    logits: one draw of [B, V] uniforms from ``generator`` a step."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    scaled = logits / max(temperature, 1e-6)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
    # Past the end (top_p above the total mass): nothing is filtered, as
    # the reference's out-of-range take gives.
    cutoff_idx = cutoff_idx.clamp_max(scaled.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    filtered = scaled.masked_fill(scaled < cutoff, float("-inf"))
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return (filtered + gumbel).argmax(dim=-1)


def _long(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.long)
    return torch.as_tensor(np.asarray(x), dtype=torch.long).to(dev)


@contextmanager
def _device_span(name: str, dev: torch.device, **counts):
    """``metrics.span`` that, under tracing on a card, also carries a CUDA
    event pair (``cuda_events``) around the work queued inside it, for
    its device time (read after the block, once the events are done)."""
    with metrics.span(name, **counts) as sp:
        if sp is None or dev.type != "cuda":
            yield sp
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield sp
        finally:
            end.record()
            sp.count(cuda_events=(start, end))


def decode_loop(forward_last, dev: torch.device, prompt_ids, prompt_len,
                seed, temperature, top_p, eos_ids, max_seq: int,
                max_new: int, on_logits=None) -> torch.Tensor:
    """The generate loop of ``make_generate_fn`` over any forward:
    ``forward_last(ids, positions, cache_offset, attn_mask)`` returns the
    logits [B, V] of each row's last position (and writes its cache).
    Sampling runs on ``dev``, with one generator there. ``on_logits(i,
    logits)``, when given, sees the logits of step i before they are
    sampled (a check's capture; it must not alter them).

    While ``metrics.tracing()`` is on, the prefill and each decode step
    record the spans ``decode.prefill`` (counts ``rows``, ``tokens``) and
    ``decode.step`` (``rows``, ``step``: step i samples token i, then
    runs its forward, except the last), with CUDA event pairs on a
    card."""
    ids = _long(prompt_ids, dev)
    plen = _long(prompt_len, dev)
    eos = _long(eos_ids, dev).reshape(-1)
    pad_tok = eos[0]
    B, P = ids.shape
    if P + max_new > max_seq:
        raise ValueError(
            f"prompt width {P} + {max_new} new tokens exceed the "
            f"{max_seq}-slot cache")
    temperature, top_p = float(temperature), float(top_p)
    pad_offset = P - plen                                    # [B]
    slot = torch.arange(P, device=dev)[None, :]              # [1, P]
    positions = slot - pad_offset[:, None]                   # [B, P]
    real = positions >= 0
    key_slot = torch.arange(max_seq, device=dev)[None, None, :]
    valid_key = key_slot >= pad_offset[:, None, None]

    # Prefill mask over cache slots: the key slot holds a real prompt
    # token and is causal; left-pad query rows mask every key (and
    # softmax to uniform, not NaN: every score is NEG_INF + s).
    causal = key_slot <= slot[:, :, None]
    with _device_span("decode.prefill", dev, rows=B, tokens=B * P):
        mask = torch.where(valid_key & causal & real[:, :, None], 0.0,
                           NEG_INF)
        cur = forward_last(ids, positions.clamp_min(0), 0, mask)
        del mask

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    toks = []
    for i in range(max_new):
        with _device_span("decode.step", dev, rows=B, step=i):
            if on_logits is not None:
                on_logits(i, cur)
            tok = _sample(cur, gen, temperature, top_p)
            tok = torch.where(done, pad_tok, tok)
            toks.append(tok)
            if i == max_new - 1:
                break
            done = done | (tok[:, None] == eos[None, :]).any(dim=1)
            write_slot = P + i
            step_mask = torch.where(
                valid_key & (key_slot <= write_slot), 0.0, NEG_INF)
            cur = forward_last(tok[:, None],
                               (write_slot - pad_offset)[:, None],
                               write_slot, step_mask)
    return torch.stack(toks, dim=1)                          # [B, max_new]


class _DecodeStep:
    """An MLA decode step's forward (one position a row) over static
    buffers: the ids, positions, mask and the write slot (a device
    tensor) are copied in, and the step attends over all S slots. On a
    card it is captured as a CUDA graph at the first call and replayed
    after, so that its ~2,000 kernels launch as one and the card, not
    the host, paces decode; on the CPU it runs eagerly.

    The capture follows a warm-up forward (cuBLAS handles, workspaces) on
    a side stream; both write the cache's last slot, S - 1, which no step
    reads unmasked (``decode_loop`` writes slots below P + max_new - 1).
    Under ``metrics.tracing()`` the spans inside the step are recorded at
    the capture alone, and its device tallies are added at every replay
    of a graph captured while tracing was on."""

    def __init__(self, params: Params, config: DecoderConfig,
                 cache: torch.Tensor, batch: int):
        dev = cache.device
        S = cache.shape[2]
        self.ids = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros_like(self.ids)
        self.slot = torch.full((1,), S - 1, dtype=torch.long, device=dev)
        self.mask = torch.full((batch, 1, S), NEG_INF, device=dev)

        def run():
            logits, _ = forward(params, self.ids, self.pos, cache,
                                self.slot, config, attn_mask=self.mask,
                                last_only=True)
            return logits[:, -1, :]

        self.graph = None
        if dev.type != "cuda":
            self._run = run
            return
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run()

    def __call__(self, ids, positions, offset: int, mask) -> torch.Tensor:
        self.ids.copy_(ids)
        self.pos.copy_(positions)
        self.slot.fill_(offset)
        self.mask.copy_(mask)
        if self.graph is None:
            return self._run()
        self.graph.replay()
        return self.out


def make_generate_fn(config: DecoderConfig, max_seq: int, max_new: int):
    """Build generate(params, prompt_ids, prompt_len, seed, temperature,
    top_p, eos_ids) → token ids [B, max_new] (eos-padded), on the device
    of ``params``.

    ``eos_ids`` is a list or [E] tensor (a scalar is accepted): a row
    stops on ANY of them. ``prompt_ids`` must be LEFT-padded to a common
    width P so every row's last real token sits at slot P−1: prefill is
    one forward over [B, P], and decode step i writes the shared cache
    slot P+i while RoPE positions stay per-row (slot − pad_offset). The
    loop runs the static ``max_new`` horizon with per-row done flags on
    the device and reads nothing back before it ends; the last step's
    forward is skipped, as its logits are never sampled. The prefill's
    head runs on the last slot alone (``forward(last_only=True)``).
    ``on_logits`` is ``decode_loop``'s. With MLA the decode steps run
    through ``_DecodeStep``: one CUDA graph a call on a card.
    """

    def generate(params, prompt_ids, prompt_len, seed, temperature, top_p,
                 eos_ids, on_logits=None):
        dev = params["final_norm"].device
        cache = step = None

        def forward_last(ids, positions, offset, mask):
            nonlocal cache, step
            if cache is None:
                cache = empty_cache(config, ids.shape[0], max_seq,
                                    device=dev)
            if config.mla is not None and ids.shape[1] == 1:
                if step is None:
                    step = _DecodeStep(params, config, cache, ids.shape[0])
                return step(ids, positions, offset, mask)
            logits, cache = forward(params, ids, positions, cache, offset,
                                    config, attn_mask=mask, last_only=True)
            return logits[:, -1, :]      # all rows end at the last slot

        return decode_loop(forward_last, dev, prompt_ids, prompt_len, seed,
                           temperature, top_p, eos_ids, max_seq, max_new,
                           on_logits=on_logits)

    return generate


# The MLA and MoE blocks use this module's products and norms; imported
# last, so that either side may be imported first.
from classmate_rag_tpu_torch.models import mla as _mla  # noqa: E402
from classmate_rag_tpu_torch.models import moe as _moe  # noqa: E402
