"""XLM-RoBERTa / E5 encoder as a PyTorch module (port of the JAX
package's ``embeddings/model.py``).

- Parameters come as the JAX package's tree of numpy arrays: embeddings
  and LayerNorm vectors at the top, per-layer tensors stacked on a
  leading [L, ...] axis under ``"layers"``. ``init_params`` draws that
  tree value for value as the JAX package does; ``load_params_from_hf``
  converts a local HF snapshot into it; ``params_from_numpy`` builds the
  module from it.
- Matmuls take bf16 operands and return f32 sums, as the reference's
  ``einsum(..., preferred_element_type=f32)`` does; the serving form
  keeps the weights in bf16 buffers (the reference casts them at every
  use, to the same values). Embeddings, LayerNorms, softmax and pooling
  run in f32.
- The trainable form (``trainable=True``, for ``training/``) keeps the
  JAX tree's f32 leaves as ``nn.Parameter``s, one per layer and key,
  and casts each weight to ``compute_dtype`` at each use, as the JAX
  train state does; both forms run the same layer loop. Gradients
  follow JAX's rules: ``mm_f32``'s backward is the transpose of the
  f32-sum product (f32 cotangent times the other bf16 operand, f32
  sums, rounded to the operand's dtype).
- ``lax.scan`` over the layers becomes a Python loop.
- ``MeshE5Model`` is the trainable form split over a ("data", "model")
  ``DeviceMesh`` for the dp×tp train step: its ranks run the same layer
  at their share of the heads and FFN, with the same gates.

Two gates pick the kernels, from the config alone:

- flash attention (``ops/attention.py``) when ``T >= flash_min_seq`` and
  ``T % 128 == 0``, else the plain attention;
- the fused epilogues (``ops/encoder_fused.py``) when ``fused_epilogue``
  and both widths are ``fusable``, else the plain unfused math.

On CUDA the gated wrappers launch the hand-written kernels; on the CPU
they take their plain versions, which compute the unfused math.
E5 semantics on top: "query: "/"passage: " prefixes (``encoder.py``),
masked mean pooling, L2 normalisation.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from hashlib import blake2b
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from classmate_rag_tpu_torch.device import (
    DeviceLike,
    pin_fp32_matmul,
    resolve_device,
)
from classmate_rag_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
)
from classmate_rag_tpu_torch.ops.encoder_fused import (
    bias_gelu,
    bias_gelu_reference,
    fusable,
    layer_norm,
    residual_ln,
    residual_ln_reference,
)
from classmate_rag_tpu_torch.parallel.tensor import (
    gather,
    model_dim,
    reduce_sum,
    split_rows,
)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 250002
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 514
    type_vocab: int = 1
    pad_id: int = 1
    ln_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16
    # Flash attention for sequences of at least this length (and a
    # multiple of 128). The default, as in the JAX package, is above the
    # longest length bucket (512), so the default encoder never uses it.
    flash_min_seq: int = 1024
    # The fused bias+GELU and residual+LayerNorm epilogues. Off by
    # default, as in the JAX package.
    fused_epilogue: bool = False

    @classmethod
    def base(cls) -> "EncoderConfig":
        return cls()

    @classmethod
    def large(cls) -> "EncoderConfig":
        return cls(hidden=1024, layers=24, heads=16, intermediate=4096)

    @classmethod
    def small_test(cls) -> "EncoderConfig":
        """Tiny config for CPU tests."""
        return cls(vocab_size=1024, hidden=64, layers=2, heads=4,
                   intermediate=128, max_positions=130)

    @classmethod
    def for_model_name(cls, name: str) -> "EncoderConfig":
        if "large" in (name or ""):
            return cls.large()
        return cls.base()


Params = Dict[str, Any]   # the JAX package's tree, as numpy arrays
_LAYER_KEYS = (
    "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "o_b",
    "attn_ln_g", "attn_ln_b", "ff_in_w", "ff_in_b",
    "ff_out_w", "ff_out_b", "ff_ln_g", "ff_ln_b",
)


def init_params(config: EncoderConfig, seed_key: str) -> Params:
    """Deterministic init, seeded from the model name: the JAX package's
    draws in its order (word, position, type embeddings, then q, k, v,
    o, ff_in, ff_out weights), so the values are identical."""
    seed = int.from_bytes(
        blake2b(seed_key.encode("utf-8"), digest_size=4).digest(), "little"
    )
    rng = np.random.default_rng(seed)
    scale = 0.02
    h, L, ff = config.hidden, config.layers, config.intermediate

    def norm(*shape):
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    return {
        "word_emb": norm(config.vocab_size, h),
        "pos_emb": norm(config.max_positions, h),
        "type_emb": norm(config.type_vocab, h),
        "emb_ln_g": np.ones(h, np.float32),
        "emb_ln_b": np.zeros(h, np.float32),
        "layers": {
            "q_w": norm(L, h, h), "q_b": np.zeros((L, h), np.float32),
            "k_w": norm(L, h, h), "k_b": np.zeros((L, h), np.float32),
            "v_w": norm(L, h, h), "v_b": np.zeros((L, h), np.float32),
            "o_w": norm(L, h, h), "o_b": np.zeros((L, h), np.float32),
            "attn_ln_g": np.ones((L, h), np.float32),
            "attn_ln_b": np.zeros((L, h), np.float32),
            "ff_in_w": norm(L, h, ff), "ff_in_b": np.zeros((L, ff), np.float32),
            "ff_out_w": norm(L, ff, h), "ff_out_b": np.zeros((L, h), np.float32),
            "ff_ln_g": np.ones((L, h), np.float32),
            "ff_ln_b": np.zeros((L, h), np.float32),
        },
    }


# ---------------------------------------------------------------------------
# HF weight loading
# ---------------------------------------------------------------------------

def _find_weight_file(model_dir: Path) -> Optional[Path]:
    for name in ("model.safetensors", "pytorch_model.bin"):
        for candidate in [model_dir / name, *model_dir.glob(f"**/{name}")]:
            if candidate.exists():
                return candidate
    return None


def _load_state_dict(path: Path) -> Dict[str, np.ndarray]:
    if path.suffix == ".safetensors":
        # Needs the ``safetensors`` package, as in the JAX package.
        from safetensors.numpy import load_file

        return dict(load_file(str(path)))
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def load_params_from_hf(model_dir: str, config: EncoderConfig) -> Optional[Params]:
    """Convert an HF XLM-R checkpoint into the stacked-layer tree; None
    when no weight file is found or a tensor is missing."""
    wfile = _find_weight_file(Path(model_dir))
    if wfile is None:
        return None
    sd = _load_state_dict(wfile)

    def get(*names: str) -> np.ndarray:
        for n in names:
            for prefix in ("", "roberta.", "model.", "0.auto_model."):
                key = prefix + n
                if key in sd:
                    return np.asarray(sd[key], dtype=np.float32)
        raise KeyError(names[0])

    # HF name of each stacked tensor; Linear stores [out, in], the tree
    # [in, out].
    hf = {
        "q": "attention.self.query", "k": "attention.self.key",
        "v": "attention.self.value", "o": "attention.output.dense",
        "ff_in": "intermediate.dense", "ff_out": "output.dense",
        "attn_ln": "attention.output.LayerNorm", "ff_ln": "output.LayerNorm",
    }
    try:
        stacks: Dict[str, list] = {k: [] for k in _LAYER_KEYS}
        for i in range(config.layers):
            base = f"encoder.layer.{i}."
            for key in _LAYER_KEYS:
                stem, part = key.rsplit("_", 1)
                name = base + hf[stem] + {
                    "w": ".weight", "b": ".bias", "g": ".weight"}[part]
                arr = get(name)
                stacks[key].append(arr.T if part == "w" else arr)
        params: Params = {
            "word_emb": get("embeddings.word_embeddings.weight"),
            "pos_emb": get("embeddings.position_embeddings.weight"),
            "type_emb": get("embeddings.token_type_embeddings.weight"),
            "emb_ln_g": get("embeddings.LayerNorm.weight"),
            "emb_ln_b": get("embeddings.LayerNorm.bias"),
            "layers": {k: np.stack(v) for k, v in stacks.items()},
        }
    except KeyError:
        return None
    if params["word_emb"].shape[1] != config.hidden:
        return None
    return params


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

_MM_OUT_DTYPE = hasattr(torch.ops.aten.mm, "dtype")


class _MmF32(torch.autograd.Function):
    """``aten::mm.dtype`` (bf16 operands, f32 result), which has no
    derivative in torch, with the transpose rule of JAX's
    ``dot_general`` (jax/_src/lax/lax.py:5464-5489): the f32 cotangent
    times the other operand in f32, rounded to the operand's dtype. On
    the card those products run in f32 (TF32 off,
    ``device.pin_fp32_matmul``)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = (g @ w.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            dw = (a.float().t() @ g).to(w.dtype)
        return da, dw


def mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 [M, N] = a [M, K] · w [K, N] with f32 sums of the operands'
    products (the reference's ``preferred_element_type=f32``; a bf16
    ``matmul`` would round the result to bf16). On CUDA: cuBLAS's
    bf16 → f32 product (``aten::mm.dtype``) where torch has it, through
    ``_MmF32`` when a gradient is wanted (without one, the call skips
    the Function's dispatch: host time that the decode step, seven
    products a layer, would pay); else, and on the CPU, the f32 product of the
    upcast operands (exact products; TF32 is off, see
    ``device.pin_fp32_matmul``), which torch autograd differentiates by
    the same rule."""
    if (a.is_cuda and _MM_OUT_DTYPE
            and a.dtype in (torch.bfloat16, torch.float16)):
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            return _MmF32.apply(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)
    return a.float() @ w.float()


_TOP_KEYS = ("word_emb", "pos_emb", "type_emb", "emb_ln_g", "emb_ln_b")


class E5Model(nn.Module):
    """The encoder on one device: ``encode(ids, mask)`` → [B, H] f32.

    Serving form: bf16 weight buffers, q/k/v fused into one [H, 3H]
    product a layer. Trainable form (``trainable=True``): the JAX tree's
    f32 leaves as parameters (``q_w[i]`` is layer i's [H, H]), cast to
    the compute dtype at each use; q, k and v are concatenated for the
    same fused product."""

    # Leaves split over a mesh's "model" axis (``MeshE5Model``): none.
    tp = 1
    shard_dims: Dict[str, int] = {}

    def __init__(self, params: Params, config: EncoderConfig,
                 device: torch.device, trainable: bool = False) -> None:
        super().__init__()
        self.config = config
        self.trainable = trainable
        cd = config.compute_dtype
        lay = params["layers"]

        def put(arr, dtype=torch.float32):   # a copy, never a view
            return torch.tensor(np.asarray(arr, np.float32),
                                device=device).to(dtype)

        if trainable:
            for key in _TOP_KEYS:
                self.register_parameter(key, nn.Parameter(put(params[key])))
            for key in _LAYER_KEYS:
                setattr(self, key, nn.ParameterList(
                    nn.Parameter(put(x)) for x in lay[key]))
            return
        for key in _TOP_KEYS:
            self.register_buffer(key, put(params[key]))
        # q, k and v as one [H, 3H] product a layer: the same sums of
        # the same products as three.
        self.register_buffer("qkv_w", put(np.concatenate(
            [lay["q_w"], lay["k_w"], lay["v_w"]], axis=2), cd))
        self.register_buffer("qkv_b", put(np.concatenate(
            [lay["q_b"], lay["k_b"], lay["v_b"]], axis=1)))
        for key in ("o_w", "ff_in_w", "ff_out_w"):
            self.register_buffer(key, put(lay[key], cd))
        for key in ("o_b", "attn_ln_g", "attn_ln_b", "ff_in_b", "ff_out_b",
                    "ff_ln_g", "ff_ln_b"):
            self.register_buffer(key, put(lay[key]))

    def params_numpy(self) -> Params:
        """The tree back as numpy (the serving form's weights as their
        bf16 values in f32)."""
        def get(t):
            return t.detach().float().cpu().numpy()

        if self.trainable:
            out = {key: get(getattr(self, key)) for key in _TOP_KEYS}
            out["layers"] = {key: np.stack([get(x) for x in getattr(
                self, key)]) for key in _LAYER_KEYS}
            return out
        h = self.config.hidden
        qkv = get(self.qkv_w)
        qkv_b = get(self.qkv_b)
        layers = {f"{p}_w": qkv[:, :, i * h:(i + 1) * h]
                  for i, p in enumerate("qkv")}
        layers.update({f"{p}_b": qkv_b[:, i * h:(i + 1) * h]
                       for i, p in enumerate("qkv")})
        for key in _LAYER_KEYS:
            if key not in layers:
                layers[key] = get(getattr(self, key))
        out = {key: get(getattr(self, key)) for key in _TOP_KEYS}
        out["layers"] = layers
        return out

    def _weights(self, i: int):
        """Layer i's product weights in the compute dtype and the fused
        QKV bias: (qkv_w, qkv_b, o_w, ff_in_w, ff_out_w)."""
        cd = self.config.compute_dtype
        if self.trainable:
            qkv_w = torch.cat([self.q_w[i], self.k_w[i], self.v_w[i]], 1)
            qkv_b = torch.cat([self.q_b[i], self.k_b[i], self.v_b[i]])
        else:
            qkv_w, qkv_b = self.qkv_w[i], self.qkv_b[i]
        return (qkv_w.to(cd), qkv_b, self.o_w[i].to(cd),
                self.ff_in_w[i].to(cd), self.ff_out_w[i].to(cd))

    def embed_tokens(self, ids: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        """Token + position + type embeddings with the embedding
        LayerNorm → [B, T, H] f32."""
        return _embed_tokens(*(getattr(self, k) for k in _TOP_KEYS), ids,
                             mask, self.config)

    def encode_from_embeddings(self, x: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
        """Transformer stack + pooling → L2-normalised [B, H] f32."""
        cfg = self.config
        cd = cfg.compute_dtype
        b, t, h = x.shape
        nh = cfg.heads
        hd = h // nh
        sm_scale = 1.0 / math.sqrt(hd)
        attend, ln, gelu = _layer_ops(cfg, b, t, cfg.intermediate)

        mask = mask.to(torch.int32)   # once, not in each layer's attention
        hidden = x.reshape(b * t, h)
        for i in range(cfg.layers):
            qkv_w, qkv_b, o_w, ff_in_w, ff_out_w = self._weights(i)
            qkv = mm_f32(hidden.to(cd), qkv_w) + qkv_b
            q, k, v = qkv.to(cd).view(b, t, 3, nh, hd).unbind(2)
            ctx = attend(q, k, v, mask, sm_scale).view(b * t, h)
            hidden = ln(hidden, mm_f32(ctx.to(cd), o_w),
                        self.o_b[i], self.attn_ln_g[i], self.attn_ln_b[i],
                        cfg.ln_eps)
            ff = gelu(mm_f32(hidden.to(cd), ff_in_w), self.ff_in_b[i])
            hidden = ln(hidden, mm_f32(ff.to(cd), ff_out_w),
                        self.ff_out_b[i], self.ff_ln_g[i], self.ff_ln_b[i],
                        cfg.ln_eps)

        return _pool(hidden.view(b, t, h), mask)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.encode_from_embeddings(self.embed_tokens(ids, mask), mask)

    encode = forward


class MeshE5Model(nn.Module):
    """The trainable encoder over a ("data", "model") ``DeviceMesh``: the
    JAX package's dp×tp train step (Megatron layout, ``specs`` being
    ``training.contrastive.encoder_param_specs``).

    - Each leaf lives once, as f32 parameters: a layer leaf split over
      "model" as one piece a rank on ``mesh[0][m]`` (the ParameterList of
      ``key`` holds layer i's pieces at [i·tp, (i+1)·tp)); every other
      leaf on ``mesh[0][0]``. Other data rows read a differentiable
      ``.to(device)`` copy, so autograd sums the rows' gradients into
      the one leaf.
    - Column-split q/k/v and ff_in: a rank's q, k and v pieces hold its
      own heads, concatenated into one [H, 3·H/tp] product whose output
      [B, T, 3, heads/tp, 64] gives the attention its q, k and v views
      (``ops.attention``'s layout); the rank's attention runs at
      heads/tp heads (the kernel on CUDA, the plain version on the CPU).
    - Row-split o and ff_out: the ranks' partial sums are added in rank
      order on the row's first device (``reduce_sum``), where the
      residual stream, the biases, the LayerNorms and pooling run.
    - ``forward`` splits the batch over the data rows and returns the
      rows' vectors concatenated on ``mesh[0][0]``.
    """

    trainable = True

    def __init__(self, params: Params, config: EncoderConfig, mesh,
                 specs: Dict[str, Any]) -> None:
        super().__init__()
        self.config, self.mesh = config, mesh
        self.tp = tp = mesh.shape["model"]
        if config.heads % tp or config.intermediate % tp:
            raise ValueError(
                f"tensor-parallel degree {tp} must divide heads="
                f"{config.heads} and intermediate={config.intermediate}")
        # A per-layer leaf's split axis: the stacked spec's, less the [L].
        self.shard_dims = {k: model_dim(sp) - 1
                           for k, sp in specs["layers"].items()
                           if model_dim(sp) is not None}
        home = mesh[0][0]

        def put(arr, dev):   # a copy, never a view
            return nn.Parameter(torch.tensor(np.asarray(arr, np.float32),
                                             device=dev))

        for key in _TOP_KEYS:
            self.register_parameter(key, put(params[key], home))
        for key, stack in params["layers"].items():
            dim = self.shard_dims.get(key)
            setattr(self, key, nn.ParameterList(
                put(x, home) for x in stack) if dim is None else
                nn.ParameterList(put(piece, mesh[0][m]) for x in stack
                                 for m, piece in enumerate(
                                     np.array_split(x, tp, axis=dim))))

    def _leaf(self, key: str, i: int, m: int) -> torch.Tensor:
        """Layer i's leaf ``key``: rank m's piece when split."""
        return getattr(self, key)[i * self.tp + m if key in self.shard_dims
                                  else i]

    def params_numpy(self) -> Params:
        """The full tree as numpy, the pieces gathered in rank order."""
        def get(t):
            return t.detach().float().cpu().numpy()

        out = {key: get(getattr(self, key)) for key in _TOP_KEYS}
        L, tp = self.config.layers, self.tp
        out["layers"] = {key: np.stack([
            np.concatenate([get(self._leaf(key, i, m)) for m in range(tp)],
                           axis=self.shard_dims[key])
            if key in self.shard_dims else get(self._leaf(key, i, 0))
            for i in range(L)]) for key in _LAYER_KEYS}
        return out

    def _encode_row(self, d: int, ids: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """Data row d's [b, H] vectors, on the row's first device."""
        cfg = self.config
        cd = cfg.compute_dtype
        devs = self.mesh[d]
        dev = devs[0]
        ids, mask = ids.to(dev), mask.to(dev)
        b, t = ids.shape
        h, tp = cfg.hidden, self.tp
        nh, hd = cfg.heads // tp, h // cfg.heads
        sm_scale = 1.0 / math.sqrt(hd)
        attend, ln, gelu = _layer_ops(cfg, b, t, cfg.intermediate // tp)
        x = _embed_tokens(*(getattr(self, k).to(dev) for k in _TOP_KEYS),
                          ids, mask, cfg)
        mask = mask.to(torch.int32)
        masks = [mask.to(r) for r in devs]
        hidden = x.reshape(b * t, h)
        for i in range(cfg.layers):
            def w(key, m):
                return self._leaf(key, i, m).to(devs[m])

            def rep(key):
                return self._leaf(key, i, 0).to(dev)

            hcd = hidden.to(cd)
            parts = []
            for m, r in enumerate(devs):
                qkv_w = torch.cat([w("q_w", m), w("k_w", m), w("v_w", m)], 1)
                qkv_b = torch.cat([w("q_b", m), w("k_b", m), w("v_b", m)])
                qkv = mm_f32(hcd.to(r), qkv_w.to(cd)) + qkv_b
                q, k, v = qkv.to(cd).view(b, t, 3, nh, hd).unbind(2)
                ctx = attend(q, k, v, masks[m], sm_scale).view(b * t, nh * hd)
                parts.append(mm_f32(ctx.to(cd), w("o_w", m).to(cd)))
            hidden = ln(hidden, reduce_sum(parts), rep("o_b"),
                        rep("attn_ln_g"), rep("attn_ln_b"), cfg.ln_eps)
            hcd = hidden.to(cd)
            parts = [mm_f32(gelu(mm_f32(hcd.to(r), w("ff_in_w", m).to(cd)),
                                 w("ff_in_b", m)).to(cd),
                            w("ff_out_w", m).to(cd))
                     for m, r in enumerate(devs)]
            hidden = ln(hidden, reduce_sum(parts), rep("ff_out_b"),
                        rep("ff_ln_g"), rep("ff_ln_b"), cfg.ln_eps)
        return _pool(hidden.view(b, t, h), mask)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, H] f32 vectors on ``mesh[0][0]``; B must divide over the
        data rows."""
        return gather([self._encode_row(d, ids[sl], mask[sl])
                       for d, sl in enumerate(split_rows(
                           ids.shape[0], self.mesh.shape["data"]))], 0)

    encode = forward


def _embed_tokens(word_emb, pos_emb, type_emb, g, b, ids: torch.Tensor,
                  mask: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    m = mask.to(torch.int64)
    # RoBERTa position ids: pad_id + 1 onwards for real tokens; pad
    # tokens point at row pad_id.
    positions = torch.cumsum(m, dim=1) * m + config.pad_id
    x = word_emb[ids.to(torch.int64)] + pos_emb[positions] + type_emb[0]
    return layer_norm(x, g, b, config.ln_eps)


def _layer_ops(cfg: EncoderConfig, b: int, t: int, ff_width: int):
    """(attend, ln, gelu) of a layer at [b, t] and an FFN of ``ff_width``
    columns: the two gates of the module docstring."""
    cd = cfg.compute_dtype
    attend = functools.partial(
        flash_attention if t >= cfg.flash_min_seq and t % 128 == 0
        else attention_reference, dtype=cd)
    fused = (cfg.fused_epilogue and fusable(b * t, cfg.hidden)
             and fusable(b * t, ff_width))
    ln = residual_ln if fused else residual_ln_reference
    gelu = (bias_gelu if fused
            else functools.partial(bias_gelu_reference, out_dtype=cd))
    return attend, ln, gelu


def _pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """E5 average pooling of [B, T, H] over real tokens, then L2 norm."""
    m = mask.to(torch.float32)
    denom = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    pooled = (hidden * m[:, :, None]).sum(dim=1) / denom
    norm = torch.linalg.norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)


def params_from_numpy(tree: Params, config: EncoderConfig,
                      device: DeviceLike = None,
                      trainable: bool = False) -> E5Model:
    """The port's encoder from the JAX package's parameter tree as numpy
    (``{k: np.asarray(v)}``, layers stacked [L, ...]); ``trainable``
    gives the f32-parameter form (see ``E5Model``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32_matmul()
    model = E5Model(tree, config, dev, trainable=trainable)
    model.eval()
    return model


def encoder_flops(config: EncoderConfig, batch: int, seq: int) -> float:
    """Approximate forward FLOPs (for MFU accounting)."""
    h, ff, L = config.hidden, config.intermediate, config.layers
    per_token = 4 * h * h + 2 * h * ff  # qkvo + ffn matmuls (MACs)
    attn = 2 * seq * h  # scores + context per token (MACs)
    return 2.0 * batch * seq * L * (per_token + attn)
