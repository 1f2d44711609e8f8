"""Probe of the port's decode step on one CUDA card: what its operations
cost, and how W8A8 and bf16 logits part with depth.

    python3 tools/torch_decode_probe.py      # on a machine with one GPU

Prints one JSON line each, beside the card's name and power limit:

- ``launch``: the host's cost of one small launch (a [8] ``add_``, 1,000
  in a row, CUDA-event time over the count);
- ``products``: a decode step's largest product, [8, 4,096] × [4,096,
  14,336], as the decoder runs it (bf16 operands, f32 sums) and with a
  bf16 result; W8A8's ``torch._int_mm`` at [32, 4,096] with the int8
  weight stored row-major and column-major;
- ``depth``: teacher-forced logits of 4 prompts (real lengths 256-512)
  through Llama-3.1-8B's width with weights drawn as ``chip_smoke.py``
  draws them, cut to 1, 2, 4, 8 and 16 layers: W8A8 against bf16, and
  bf16 against the same weights computed in f32.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from classmate_rag_tpu_torch.device import pin_fp32_matmul  # noqa: E402
from classmate_rag_tpu_torch.models import decoder as D  # noqa: E402


def event_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_probe: no CUDA device", file=sys.stderr)
        return 2
    pin_fp32_matmul()
    card = cs.smi_line()
    dev = torch.device("cuda")
    z = torch.zeros(8, device=dev)
    cs.emit({"probe": "launch", "card": card,
             "add_us": 1e3 * event_ms(lambda: z.add_(1), 1000)})

    a = torch.randn(8, 4096, device=dev).bfloat16()
    w = torch.randn(4096, 14336, device=dev).bfloat16()
    row = {"probe": "products", "card": card,
           "mm_bf16_f32_out_ms": event_ms(
               lambda: torch.mm(a, w, out_dtype=torch.float32), 50),
           "mm_bf16_ms": event_ms(lambda: torch.mm(a, w), 50)}
    x = torch.randint(-127, 128, (32, 4096), device=dev, dtype=torch.int8)
    wr = torch.randint(-127, 128, (4096, 14336), device=dev,
                       dtype=torch.int8)
    wc = wr.t().contiguous().t()
    check = torch.equal(torch._int_mm(x, wr), torch._int_mm(x, wc))
    row.update(int_mm_row_major_ms=event_ms(lambda: torch._int_mm(x, wr), 50),
               int_mm_col_major_ms=event_ms(lambda: torch._int_mm(x, wc), 50),
               int_mm_layouts_equal=check)
    cs.emit(row)
    del a, w, x, wr, wc

    cfg = D.DecoderConfig.llama3_8b()
    params = cs.draw_decoder_params(cfg, 1, dev)
    rng = np.random.default_rng(9)
    B, P = 4, 512
    ids, lens = cs.decoder_prompts(rng, cfg, B, P, P // 2, P)
    with torch.inference_mode():
        for n in (1, 2, 4, 8, 16):
            c = dataclasses.replace(cfg, layers=n)
            p = cs.first_layers(params, n)
            ref = cs.teacher_forced(D, c, p, ids, lens, P, dev)
            q8 = D.quantize_decoder_params(p, c)
            w8a8 = cs.rows_agree(cs.teacher_forced(D, c, q8, ids, lens, P,
                                                   dev), ref)
            del q8
            c32 = dataclasses.replace(c, compute_dtype=torch.float32)
            p32 = {k: v.float() for k, v in p.items() if k != "layers"}
            p32["layers"] = {k: v.float() for k, v in p["layers"].items()}
            f32 = cs.rows_agree(ref, cs.teacher_forced(D, c32, p32, ids,
                                                       lens, P, dev))
            del p32, ref
            torch.cuda.empty_cache()
            cs.emit({"probe": "depth", "card": card, "layers": n,
                     "w8a8_vs_bf16": w8a8, "bf16_vs_f32": f32})
    return 0


if __name__ == "__main__":
    sys.exit(main())
