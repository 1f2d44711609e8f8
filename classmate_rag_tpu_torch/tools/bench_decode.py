"""Decoder generation throughput: tokens/s of the port's decode loop.

Runs ``models.decoder.make_generate_fn`` (prefill plus greedy decode
with the KV cache, the loop ``DecodeRunner`` serves) on the configured
decoder shape with random weights from a seed: the compute shape of real
generation. ``--preset llama3-8b --int8`` runs the reference's model
class with W8A8 weights on one card. ``--emit-gguf PATH`` writes the
preset's geometry (random weights) as a GGUF through ``models/gguf.py``
and exits; ``--gguf PATH`` then decodes from that file.

    python -m classmate_rag_tpu_torch.tools.bench_decode \\
        [--preset llama3-8b] [--batch 8] [--prompt 256] [--new 128] \\
        [--int8] [--hidden 768] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from classmate_rag_tpu_torch.device import resolve_device, synchronize


def _rss_mb() -> dict:
    out = {}
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith(("VmRSS", "VmHWM")):
                k, v = line.split(":", 1)
                out[k] = round(int(v.split()[0]) / 1024, 1)
    except OSError:
        pass
    return out


def _memory(dev) -> dict:
    if dev.type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": torch.cuda.mem_get_info(dev)[1]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default=None,
                    choices=["llama3-8b", "qwen2-7b", "qwen3-8b"],
                    help="real model shapes from the reference lineup")
    ap.add_argument("--batch", default="8",
                    help="batch size, or a comma list sharing one "
                         "transfer of the weights (e.g. 1,8)")
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--new", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 quantized decode")
    ap.add_argument("--gguf", default=None,
                    help="decode from a .gguf file")
    ap.add_argument("--emit-gguf", default=None, metavar="PATH",
                    help="write the preset geometry (random weights) as a "
                         "GGUF at PATH and exit")
    ap.add_argument("--quant", default="q8_0",
                    choices=["f32", "f16", "q8_0", "q4_0", "q4_k", "q6_k"],
                    help="GGUF quantization for --emit-gguf")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    return ap.parse_args(argv)


def run(args) -> list:
    """The runs of ``args`` (see ``parse_args``); one report a batch
    size (or the emitted file's)."""
    from classmate_rag_tpu_torch.models import decoder as D
    from classmate_rag_tpu_torch.models import gguf as gg

    dev = resolve_device(args.device)
    max_seq = args.prompt + args.new
    if args.preset:
        base = {"llama3-8b": D.DecoderConfig.llama3_8b,
                "qwen2-7b": D.DecoderConfig.qwen2_7b,
                "qwen3-8b": D.DecoderConfig.qwen3_8b}[args.preset]()
        config = dataclasses.replace(base, max_seq=max_seq)
    elif args.gguf:
        config = None            # the geometry comes from the file
    else:
        config = D.DecoderConfig(
            hidden=args.hidden, heads=max(4, args.hidden // 64),
            kv_heads=max(2, args.hidden // 192), ffn=args.hidden * 3,
            layers=12, max_seq=max_seq)

    if args.emit_gguf:
        qmap = {"f32": gg.GGML_F32, "f16": gg.GGML_F16,
                "q8_0": gg.GGML_Q8_0, "q4_0": gg.GGML_Q4_0,
                "q4_k": gg.GGML_Q4_K, "q6_k": gg.GGML_Q6_K}
        if config is None:
            raise SystemExit("--emit-gguf needs --preset or --hidden")
        t0 = time.perf_counter()
        gg.export_decoder_to_gguf(args.emit_gguf,
                                  D.init_params(config, "bench-decode"),
                                  config, quant_type=qmap[args.quant])
        return [{"emitted": args.emit_gguf, "quant": args.quant,
                 "file_bytes": Path(args.emit_gguf).stat().st_size,
                 "seconds": round(time.perf_counter() - t0, 3),
                 "rss_mb": _rss_mb()}]

    load_s = None
    if args.gguf:
        t0 = time.perf_counter()
        config, params = gg.load_params_from_gguf(args.gguf, host=True)
        config = dataclasses.replace(config, max_seq=max_seq)
        load_s = time.perf_counter() - t0
    else:
        params = D.init_params(config, "bench-decode")
    if args.int8:
        params = D.quantize_decoder_params_host(params, config)
    # Time only the host-to-card transfer (the metric's name).
    t0 = time.perf_counter()
    params = D.params_from_numpy(params, config, dev)
    synchronize(dev)
    transfer_s = time.perf_counter() - t0
    param_bytes = D.quantized_param_bytes(params)
    gen = D.make_generate_fn(config, max_seq, args.new)

    rng = np.random.default_rng(0)
    out = []
    for batch in (int(b) for b in str(args.batch).split(",")):
        prompts = rng.integers(4, config.vocab_size, (batch, args.prompt))
        plen = np.full((batch,), args.prompt)
        gen(params, prompts, plen, 0, 0.0, 0.95, 2).cpu()       # warm-up
        t0 = time.perf_counter()
        gen(params, prompts, plen, 1, 0.0, 0.95, 2).cpu()
        dt = time.perf_counter() - t0
        out.append({
            "preset": args.preset, "gguf": args.gguf,
            "gguf_load_s": round(load_s, 3) if load_s is not None else None,
            "layers": config.layers, "hidden": config.hidden,
            "batch": batch, "prompt_len": args.prompt,
            "new_tokens": args.new, "int8": bool(args.int8),
            "param_bytes": param_bytes,
            "transfer_seconds": round(transfer_s, 3),
            "seconds": round(dt, 4),
            # The timed call includes one prefill over the prompt on top
            # of the decode steps: the rate slightly understates decode.
            "decode_tokens_per_sec": round(batch * args.new / dt, 2),
            "device": str(dev), "rss_mb": _rss_mb(), **_memory(dev)})
    return out


def main(argv=None) -> int:
    for line in run(parse_args(argv)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
