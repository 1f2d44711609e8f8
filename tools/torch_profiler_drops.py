"""Does torch.profiler see every kernel the port launches, and does that
change as the process ages? On one CUDA card.

    python3 tools/torch_profiler_drops.py    # on a machine with one GPU

At 0, 10, 30, 60, 100, 140, 180 and 220 s after start (the card kept
busy with f32 products in between) it traces 20 calls in a row of the
fused backward kernel's wrapper, ``flash_attn_bwd_fused`` (B 32, T 128,
12 heads), in four sessions
one after another: CUDA activity alone, the same with 50 ms of host
time traced before the first call and after the last, and both again
with CPU activity. The card's name and power limit, then one JSON line
a time point; per session:

- ``n_kernels`` of the 20 kernels in the trace, ``n_launch_events``
  the runtime's launch calls it holds, ``dev_us_per_call`` the traced
  kernels' device time over 20;
- ``skew_us_*``: each kernel's start minus its launch call's start;
- the first kernel's start after the session's wall-clock start and the
  session's wall-clock end after the last kernel's start (µs).

``chip_smoke.py`` retries a trace that is short of the port's kernels
(``traced``) because of what this shows.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from classmate_rag_tpu_torch.ops import attention as tatt  # noqa: E402

T0 = time.perf_counter()
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
rng = np.random.default_rng(13)
b, t, nh, hd = 32, 128, 12, 64
qkv = torch.from_numpy(rng.normal(0, 1, (b, t, 3, nh, hd)).astype(np.float32)
                       ).to(torch.bfloat16).cuda()
q, k, v = qkv.unbind(2)
mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
dout = torch.randn(b, t, nh * hd, device="cuda").to(torch.bfloat16)
out, lse = tatt.flash_attn(q, k, v, mask, 0.125, with_lse=True)
delta, ws, count = tatt.flash_attn_bwd_delta(out, dout, nh)


def fn():
    tatt.flash_attn_bwd_fused(q, k, v, dout, mask, lse, delta, ws, count,
                              0.125)


def session(pad, cpu):
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    w0 = time.time_ns()
    with profile(activities=acts) as prof:
        if pad:
            time.sleep(pad)
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    w1 = time.time_ns()
    evs = prof.profiler.kineto_results.events()
    kern = [e for e in evs if "flash_attn_bwd_kernel" in e.name()]
    launches = [e for e in evs if e.name().startswith("cudaLaunch")]
    by_corr = {e.correlation_id(): e for e in launches}
    skews = []
    for e in kern:
        lk = by_corr.get(e.linked_correlation_id()) or by_corr.get(
            e.correlation_id())
        if lk is not None:
            skews.append((e.start_ns() - lk.start_ns()) / 1e3)
    dev = sum(e.duration_ns() for e in kern) / 1e3 / 20
    ks = sorted(e.start_ns() for e in kern)
    return {"pad": pad, "cpu": cpu, "n_kernels": len(kern),
            "n_launch_events": len(launches), "dev_us_per_call": dev,
            "skew_us_min": min(skews) if skews else None,
            "skew_us_med": statistics.median(skews) if skews else None,
            "n_pairs": len(skews),
            "first_kernel_minus_wall_start_us":
                (ks[0] - w0) / 1e3 if ks else None,
            "wall_end_minus_last_kernel_us":
                (w1 - ks[-1]) / 1e3 if ks else None}


a = torch.randn(8192, 8192, device="cuda")
marks = [0, 10, 30, 60, 100, 140, 180, 220]
for m in marks:
    while time.perf_counter() - T0 < m:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
        time.sleep(0.5)
    line = {"t_s": time.perf_counter() - T0}
    line["plain"] = session(0, False)
    line["padded"] = session(0.05, False)
    line["cpu_padded"] = session(0.05, True)
    line["cpu_plain"] = session(0, True)
    print(json.dumps(line), flush=True)
