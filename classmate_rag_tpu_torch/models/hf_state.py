"""DeepSeek-V2 weights by their HF names (the public checkpoint's names and
shapes) into the decoder's tree, on the device.

``params_from_hf_state(state, config, device)`` is the one way an MLA/MoE
tree is made: from a checkpoint's files (``load_hf_checkpoint``, which
``decoder.load_params_from_hf`` calls), from tensors a caller already
holds (``DecodeRunner(hf_state=...)``), or from a seeded draw on the
device (``SeededHFState``, the runner's weights when it is given none).
It goes layer by layer and takes each tensor out of ``state`` (``pop``)
as it is placed, so that a drawn or loaded tensor is released once its
copy is in the tree: the peak is the tree plus one layer.

The tree (``decoder.forward`` reads it) is a dict with ``tok_emb`` [V, h],
``final_norm`` [h] f32, ``lm_head`` [h, V] and ``layers``, a list of one
dict a layer. Matmul weights are in ``compute_dtype``; a [in, out]
weight is the transposed view of HF's [out, in] matrix (no copy):

- ``attn_norm``, ``ffn_norm``, ``kv_a_norm``: RMSNorm gains, f32;
- ``q_kv_a_w`` [h, H(N+R) + C+R]: q_proj and kv_a_proj_with_mqa as one
  product, each head's rope rows and k_rope's de-interleaved (the order
  HF's ``apply_rotary_pos_emb`` rotates in; ``mla.py``);
- ``w_kv_b`` [C, H(N+V)] (prefill), and views of the same matrix for
  the absorbed decode: ``w_uk`` [H, N, C] and ``w_uv`` [H, C, V];
- ``o_w`` [H V, h];
- a dense layer: ``gate_up_w`` [h, 2F] and ``down_w`` [F, h];
- a MoE layer: ``router_w`` [h, E] f32, ``experts_gate_up`` [E, 2f, h]
  and ``experts_down`` [E, h, f] stacked in HF's [out, in] layout, and
  ``shared_gate_up_w`` / ``shared_down_w``.
"""

from __future__ import annotations

from hashlib import blake2b
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from classmate_rag_tpu_torch.device import DeviceLike, resolve_device


def hf_shapes(config) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the HF checkpoint of ``config``, name → shape, in
    the order the converter takes them."""
    m, moe = config.mla, config.moe
    h, H = config.hidden, config.heads
    N, R, C, V = m.qk_nope_dim, m.qk_rope_dim, m.kv_lora_rank, m.v_head_dim
    out: Dict[str, Tuple[int, ...]] = {
        "model.embed_tokens.weight": (config.vocab_size, h)}
    for i in range(config.layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = (h,)
        out[p + "self_attn.q_proj.weight"] = (H * (N + R), h)
        out[p + "self_attn.kv_a_proj_with_mqa.weight"] = (C + R, h)
        out[p + "self_attn.kv_a_layernorm.weight"] = (C,)
        out[p + "self_attn.kv_b_proj.weight"] = (H * (N + V), C)
        out[p + "self_attn.o_proj.weight"] = (h, H * V)
        out[p + "post_attention_layernorm.weight"] = (h,)
        if moe is not None and moe.is_moe(i):
            f, fs = moe.expert_ffn, moe.expert_ffn * moe.n_shared
            out[p + "mlp.gate.weight"] = (moe.n_experts, h)
            for e in range(moe.n_experts):
                q = f"{p}mlp.experts.{e}."
                out[q + "gate_proj.weight"] = (f, h)
                out[q + "up_proj.weight"] = (f, h)
                out[q + "down_proj.weight"] = (h, f)
            if fs:
                out[p + "mlp.shared_experts.gate_proj.weight"] = (fs, h)
                out[p + "mlp.shared_experts.up_proj.weight"] = (fs, h)
                out[p + "mlp.shared_experts.down_proj.weight"] = (h, fs)
        else:
            out[p + "mlp.gate_proj.weight"] = (config.ffn, h)
            out[p + "mlp.up_proj.weight"] = (config.ffn, h)
            out[p + "mlp.down_proj.weight"] = (h, config.ffn)
    out["model.norm.weight"] = (h,)
    out["lm_head.weight"] = (config.vocab_size, h)
    return out


def _seed(key: str, name: str) -> int:
    return int.from_bytes(
        blake2b(f"{key}:{name}".encode(), digest_size=8).digest(),
        "little") >> 1


class SeededHFState:
    """Random weights by HF name, drawn on ``device`` when taken: each
    tensor from its own generator seeded by (``seed_key``, name), N(0,
    0.02) in f32 rounded to ``compute_dtype``; norm gains are ones."""

    def __init__(self, config, seed_key: str, device: DeviceLike = None):
        self.shapes = hf_shapes(config)
        self.key, self.dtype = seed_key, config.compute_dtype
        self.device = resolve_device(device)

    def keys(self):
        return self.shapes.keys()

    def pop(self, name: str) -> torch.Tensor:
        shape = self.shapes.pop(name)
        if name.endswith("norm.weight"):
            return torch.ones(shape, dtype=torch.float32, device=self.device)
        g = torch.Generator(device=self.device)
        g.manual_seed(_seed(self.key, name))
        w = torch.randn(shape, generator=g, device=self.device)
        return w.mul_(0.02).to(self.dtype)


def _rope_rows(w: torch.Tensor, start: int, rope: int) -> torch.Tensor:
    """``w`` [..., rows, in] with rows [start, start + rope) of each
    leading index de-interleaved: [r0, r2, ..., r1, r3, ...]."""
    perm = torch.cat([torch.arange(0, rope, 2), torch.arange(1, rope, 2)])
    out = w.clone()
    out[..., start:start + rope, :] = w[..., start + perm.to(w.device), :]
    return out


def params_from_hf_state(state, config, device: DeviceLike = None):
    """The decoder's tree of an MLA/MoE ``config`` from ``state``, HF name
    → tensor (any float dtype, any device; ``pop`` takes each tensor out
    as it is placed). A missing tensor raises KeyError, a tensor of
    another shape ValueError."""
    if config.mla is None:
        raise ValueError("params_from_hf_state converts an MLA/MoE config")
    dev = resolve_device(device)
    cdtype = config.compute_dtype
    shapes = hf_shapes(config)
    m, moe = config.mla, config.moe
    H, N, R, C, V = (config.heads, m.qk_nope_dim, m.qk_rope_dim,
                     m.kv_lora_rank, m.v_head_dim)

    def take(name: str, dtype=cdtype) -> torch.Tensor:
        t = state.pop(name)
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the config "
                             f"gives {shapes[name]}")
        return t.to(dev, dtype)

    def gate_up(p: str) -> torch.Tensor:
        g = take(p + "gate_proj.weight")
        return torch.cat([g, take(p + "up_proj.weight")]).t()

    tree: Dict[str, Any] = {"tok_emb": take("model.embed_tokens.weight"),
                            "layers": []}
    for i in range(config.layers):
        p = f"model.layers.{i}."
        lp: Dict[str, Any] = {
            "attn_norm": take(p + "input_layernorm.weight", torch.float32)}
        q = _rope_rows(take(p + "self_attn.q_proj.weight").view(
            H, N + R, -1), N, R).view(H * (N + R), -1)
        kv_a = _rope_rows(take(p + "self_attn.kv_a_proj_with_mqa.weight"),
                          C, R)
        lp["q_kv_a_w"] = torch.cat([q, kv_a]).t()
        del q, kv_a
        lp["kv_a_norm"] = take(p + "self_attn.kv_a_layernorm.weight",
                               torch.float32)
        kv_b = take(p + "self_attn.kv_b_proj.weight")     # [H (N+V), C]
        lp["w_kv_b"] = kv_b.t()
        heads = kv_b.view(H, N + V, C)
        lp["w_uk"] = heads[:, :N]
        lp["w_uv"] = heads[:, N:].transpose(1, 2)
        lp["o_w"] = take(p + "self_attn.o_proj.weight").t()
        lp["ffn_norm"] = take(p + "post_attention_layernorm.weight",
                              torch.float32)
        if moe is not None and moe.is_moe(i):
            E, f, h = moe.n_experts, moe.expert_ffn, config.hidden
            lp["router_w"] = take(p + "mlp.gate.weight", torch.float32).t()
            gu = torch.empty((E, 2 * f, h), dtype=cdtype, device=dev)
            down = torch.empty((E, h, f), dtype=cdtype, device=dev)
            for e in range(E):
                q = f"{p}mlp.experts.{e}."
                gu[e, :f] = take(q + "gate_proj.weight")
                gu[e, f:] = take(q + "up_proj.weight")
                down[e] = take(q + "down_proj.weight")
            lp["experts_gate_up"], lp["experts_down"] = gu, down
            if moe.n_shared:
                lp["shared_gate_up_w"] = gate_up(p + "mlp.shared_experts.")
                lp["shared_down_w"] = take(
                    p + "mlp.shared_experts.down_proj.weight").t()
        else:
            lp["gate_up_w"] = gate_up(p + "mlp.")
            lp["down_w"] = take(p + "mlp.down_proj.weight").t()
        tree["layers"].append(lp)
    tree["final_norm"] = take("model.norm.weight", torch.float32)
    tree["lm_head"] = take("lm_head.weight").t()
    return tree


class _CheckpointState:
    """An HF checkpoint directory's tensors by name, read when taken
    (safetensors through ``safe_open``; ``.bin`` files memory-mapped)."""

    def __init__(self, d: Path):
        self._where: Dict[str, Any] = {}
        files = sorted(d.glob("*.safetensors"))
        if files:
            from safetensors import safe_open

            for f in files:
                h = safe_open(str(f), framework="pt", device="cpu")
                for name in h.keys():
                    self._where[name] = h
        else:
            for f in sorted(d.glob("pytorch_model*.bin")):
                part = torch.load(str(f), map_location="cpu",
                                  weights_only=True, mmap=True)
                self._where.update({k: v for k, v in part.items()})

    def __bool__(self) -> bool:
        return bool(self._where)

    def pop(self, name: str) -> torch.Tensor:
        src = self._where.pop(name)
        return src if isinstance(src, torch.Tensor) else src.get_tensor(name)


def load_hf_checkpoint(d: Path, config,
                       device: DeviceLike = None) -> Optional[Dict[str, Any]]:
    """``params_from_hf_state`` of the checkpoint in directory ``d``; None
    when it holds no weight file, lacks a tensor, or a tensor's shape is
    not the config's."""
    state = _CheckpointState(Path(d))
    if not state:
        return None
    try:
        return params_from_hf_state(state, config, device)
    except (KeyError, ValueError):
        return None
