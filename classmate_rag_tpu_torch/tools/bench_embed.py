"""E5 encoder throughput: chunks/s and the share of the card's bf16
peak.

Runs the port's encoder forward (``E5Model``, E5-base unless
``--large``; ``--tiny`` the small test configuration) on random token
batches of one shape, with random weights from a seed (the compute
shape of the real model). On CUDA the encoder runs in the kernel
configuration (``fused_epilogue=True, flash_min_seq=128``: the
``bias_gelu``, ``residual_ln`` and ``flash_attn`` kernels). The time a
batch is ``utils.profiling.held_stream_ms``'s; the peaks are
``utils.profiling``'s table.

    python -m classmate_rag_tpu_torch.tools.bench_embed \\
        [--batch 64] [--seq 256] [--iters 16] [--large|--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from classmate_rag_tpu_torch.device import resolve_device


def encoder_for(config_name: str, device):
    """The encoder ``config_name`` ("base", "large", "small_test") with
    random weights, on ``device``, in the kernel configuration on CUDA."""
    from classmate_rag_tpu_torch.embeddings.model import (
        EncoderConfig, init_params, params_from_numpy,
    )

    dev = resolve_device(device)
    config = getattr(EncoderConfig, config_name)()
    if dev.type == "cuda":
        config = dataclasses.replace(config, fused_epilogue=True,
                                     flash_min_seq=128)
    return params_from_numpy(init_params(config, "bench-embed"), config, dev)


def run(model, batch: int = 64, seq: int = 256, iters: int = 16,
        name: str = "e5-base") -> dict:
    """Forward ``model`` (an ``E5Model``) on [batch, seq] random ids."""
    from classmate_rag_tpu_torch.embeddings.model import encoder_flops
    from classmate_rag_tpu_torch.utils.profiling import (
        Throughput, held_stream_ms,
    )

    config = model.config
    dev = model.word_emb.device
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(
        rng.integers(4, config.vocab_size, (batch, seq))).to(dev)
    mask = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    with torch.no_grad():
        t = held_stream_ms(lambda: model(ids, mask), iters, dev)
    dt = t.get("profiler_ms", t["ms"]) / 1e3
    report = Throughput(seconds=dt,
                        flops=encoder_flops(config, batch, seq)).report()
    return {
        "model": name, "batch": batch, "seq": seq, "iters": iters,
        "kernel_config": bool(config.fused_epilogue),
        "ms_per_batch": round(dt * 1e3, 4),
        "chunks_per_sec": round(batch / dt, 2),
        "tokens_per_sec": round(batch * seq / dt, 1),
        "held": t["held"], "timing": t["timing"],
        **report,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="small_test config (CPU smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    cfg = "small_test" if args.tiny else ("large" if args.large else "base")
    model = encoder_for(cfg, args.device)
    name = {"small_test": "small_test", "large": "e5-large"}.get(
        cfg, "e5-base")
    print(json.dumps(run(model, args.batch, args.seq, args.iters, name)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
