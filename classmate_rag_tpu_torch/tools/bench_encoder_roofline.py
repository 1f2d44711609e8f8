"""Encoder roofline: where the forward's time goes outside the products.

Times the port's encoder step (``E5Model``, random weights from a seed)
and its components alone at one [batch, seq] shape:

  transformer_stack   ``encode_from_embeddings`` (the layers + pooling)
  embed_gather_ln     ``embed_tokens`` (the gathers + embedding LN)
  proj_ffn_matmuls    every layer's QKV, O, FFN-in and FFN-out products
  attention_core      every layer's attention (scores, softmax, context)
  layernorms          2L + 1 residual+bias+LayerNorm epilogues
  bias_gelu           L bias+GELU epilogues

With ``--fused on`` (the default) the encoder runs in the kernel
configuration (``fused_epilogue=True``, ``flash_min_seq=128``): the
attention core is the ``flash_attn`` kernel at a seq that is a multiple
of 128, and the epilogues are the ``residual_ln`` and ``bias_gelu``
kernels (on the CPU their plain versions). ``--fused off`` runs the
plain versions. Each time is ``utils.profiling.held_stream_ms``'s; the
bf16 peak is ``utils.profiling``'s table for the card.

    python -m classmate_rag_tpu_torch.tools.bench_encoder_roofline \\
        [--batch 64] [--seq 256] [--iters 32] [--config base] \\
        [--fused on|off] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import numpy as np
import torch

from classmate_rag_tpu_torch.device import resolve_device


def components(model, batch: int, seq: int):
    """{component: call} at [batch, seq] for ``model``."""
    from classmate_rag_tpu_torch.embeddings.model import _layer_ops, mm_f32

    cfg = model.config
    dev = model.word_emb.device
    b, t, h = batch, seq, cfg.hidden
    nh, cd, n_layers = cfg.heads, cfg.compute_dtype, cfg.layers
    hd = h // nh
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(4, cfg.vocab_size, (b, t))).to(dev)
    mask = torch.ones((b, t), dtype=torch.int32, device=dev)
    x = torch.from_numpy(
        rng.standard_normal((b, t, h)).astype(np.float32)).to(dev)
    x_emb = model.embed_tokens(ids, mask)
    attend, ln, gelu = _layer_ops(cfg, b, t, cfg.intermediate)
    ws = [model._weights(i) for i in range(n_layers)]
    flat = x.reshape(b * t, h)

    def matmuls():
        hid = flat.to(cd)
        for qkv_w, _b, o_w, ff_in_w, ff_out_w in ws:
            qkv = mm_f32(hid, qkv_w)
            o = mm_f32((qkv[:, :h] + qkv[:, h:2 * h] + qkv[:, 2 * h:])
                       .to(cd), o_w)
            f1 = mm_f32(o.to(cd), ff_in_w)
            hid = mm_f32(f1.to(cd), ff_out_w).to(cd)
        return hid

    def attention():
        q = x.to(cd).view(b, t, nh, hd)
        return [attend(q, q, q, mask, 1.0 / math.sqrt(hd))
                for _ in range(n_layers)]

    def layernorms():
        return [ln(flat, flat, model.o_b[i % n_layers],
                   model.attn_ln_g[i % n_layers],
                   model.attn_ln_b[i % n_layers], cfg.ln_eps)
                for i in range(2 * n_layers + 1)]

    ff = torch.from_numpy(rng.standard_normal(
        (b * t, cfg.intermediate)).astype(np.float32)).to(dev)

    def gelus():
        return [gelu(ff, model.ff_in_b[i]) for i in range(n_layers)]

    return {
        "transformer_stack": lambda: model.encode_from_embeddings(x_emb,
                                                                  mask),
        "embed_gather_ln": lambda: model.embed_tokens(ids, mask),
        "proj_ffn_matmuls": matmuls,
        "attention_core": attention,
        "layernorms": layernorms,
        "bias_gelu": gelus,
    }


def run(model, batch: int = 64, seq: int = 256, iters: int = 32,
        config_name: str = "base") -> dict:
    """Every component of ``components`` timed; the report."""
    from classmate_rag_tpu_torch.embeddings.model import encoder_flops
    from classmate_rag_tpu_torch.utils.profiling import (
        _detect_chip, device_peaks, held_stream_ms,
    )

    cfg = model.config
    dev = model.word_emb.device
    times, held = {}, {}
    with torch.no_grad():
        for name, fn in components(model, batch, seq).items():
            t = held_stream_ms(fn, iters, dev)
            times[name] = t.get("profiler_ms", t["ms"]) / 1e3
            held[name] = t["held"]
    b, t_, h = batch, seq, cfg.hidden
    n_layers, ff = cfg.layers, cfg.intermediate
    flops = encoder_flops(cfg, b, t_)
    mm_flops = n_layers * (4 * 2 * b * t_ * h * h + 2 * 2 * b * t_ * h * ff)
    attn_flops = n_layers * 2 * 2 * b * t_ * t_ * h
    chip = _detect_chip() if dev.type == "cuda" else "cpu"
    peak = device_peaks(chip)[0]
    full = times["transformer_stack"] + times["embed_gather_ln"]

    def tf(secs, f):
        return f / secs / 1e12 if secs > 0 else 0.0

    stack, mm, attn = (times["transformer_stack"],
                       times["proj_ffn_matmuls"], times["attention_core"])
    other = stack - mm - attn - times["layernorms"] - times["bias_gelu"]
    return {
        "config": config_name, "batch": b, "seq": t_, "iters": iters,
        "fused_epilogue": bool(cfg.fused_epilogue),
        "flash_attn": t_ >= cfg.flash_min_seq and t_ % 128 == 0,
        "backend": dev.type, "chip": chip,
        "full_step_ms": full * 1e3,
        "mfu": flops / full / (peak * 1e12),
        "components_ms": {**{k: v * 1e3 for k, v in times.items()},
                          "stack_residual_other": max(other, 0.0) * 1e3},
        "held": held,
        "achieved_tflops": {"full": tf(full, flops),
                            "proj_ffn": tf(mm, mm_flops),
                            "attention": tf(attn, attn_flops)},
        "mfu_if_only_matmuls": flops / (mm + attn) / (peak * 1e12),
        "peak_tflops_assumed": peak,
    }


def main(argv=None) -> int:
    from classmate_rag_tpu_torch.embeddings.model import (
        EncoderConfig, init_params, params_from_numpy,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--config", choices=["base", "large", "small_test"],
                    default="base")
    ap.add_argument("--fused", choices=["on", "off"], default="on",
                    help="the kernel configuration (fused epilogues, "
                         "flash attention from seq 128)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    config = getattr(EncoderConfig, args.config)()
    if args.fused == "on":
        config = dataclasses.replace(config, fused_epilogue=True,
                                     flash_min_seq=128)
    model = params_from_numpy(init_params(config, "roofline"), config,
                              resolve_device(args.device))
    print(json.dumps(run(model, args.batch, args.seq, args.iters,
                         args.config)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
