"""The kind ``answer``: the RAG answer step, batches of grounded questions
answered by a model through the port's ``DecodeRunner.generate_ids_batch``
(prefill of each left-padded batch, then decode to the static horizon).
The configuration is the model's HF config.json (``model_type``
deepseek_v2); the traffic file gives the batch, the prompt lengths, the
horizon and the sampling knobs.

- Inputs: each pool batch's prompts are token ids uniform over the
  vocabulary, of lengths uniform over ``prompt_tokens``, drawn from the
  seed; each batch has its own sampling seed.
- Set-up: the weights are drawn on the card from the seed
  (``reference/deepseek_v2.SeededState``) and enter the runner by its
  ``hf_state``, as a user's checkpoint would; every pool batch is then
  answered once.
- Window: ``loops/closed_answer.py``. Under the harness's profiler (a
  ``--trace 1`` run) the program's tracing is on for the window
  (``utils.metrics.tracing`` with device tallies); a ``--trace 0`` run
  measures the untraced program.
- Check, after the program's state is freed: a seeded sample of (pool
  batch, row) pairs served in the window, from at most ``RERUN_POOLS``
  of its pool batches. Each sampled batch is answered
  again through the same entry point, on weights drawn again, with a
  capture of each step's logits (``on_logits``) and of the router's
  choices; its ids must equal every serving of that batch in the window.
  Then the reference's full forward over each sampled row's prompt and
  served tokens, one layer at a time, gives the logits at the last prompt
  position and at every decode step, and the two are compared
  (``logit_max_rel``, ``logit_rms_rel``; ``limits/<cell>.json`` gives the
  limits and the reasons).

Its readers' values: ``answer_config`` (the HF config values),
``prompt_lens`` (a pool batch's real prompt lengths), ``max_new``, and,
after a traced window, ``spans`` (the program's) and ``tallies``. Its info
keys: ``sampled_rows``, ``router_choices_differing`` (of
``router_choices_compared``: the prompt positions' top-k choices),
``expert_tokens_max_over_mean``.
"""

from __future__ import annotations

import gc
import math
import random
from typing import Dict, List, NamedTuple

import torch

from rag_bench.loops.closed_answer import serve_one
from rag_bench.reference import deepseek_v2 as ref

CONTROL = ("the reference with every matmul weight rounded to float8 e4m3, "
           "one scale an output channel")
# The check answers each sampled batch again: its sample lies in at most
# this many of the window's pool batches.
RERUN_POOLS = 2
# Keys of the configuration file that are not config.json's.
META = ("kind", "source", "deployment", "reduced", "assumed")


class Batch(NamedTuple):
    prompts: List[List[int]]
    seed: int                     # the batch's sampling seed


def _profiling() -> bool:
    return bool(torch._C._autograd._profiler_enabled())


def readings(pairs) -> Dict[str, float]:
    """``logit_max_rel``: the largest |Δlogit| at a position over the
    reference's logit RMS there, the largest over all positions;
    ``logit_rms_rel``: the RMS of Δ over the RMS of the reference's
    logits, over every position compared. ``pairs``: (program, reference)
    logits [K, V] of each sampled row."""
    worst, d2, r2 = 0.0, 0.0, 0.0
    for got, want in pairs:
        d = got.float() - want
        rms = want.pow(2).mean(dim=-1).sqrt().clamp_min(1e-30)
        worst = max(worst, float((d.abs().amax(dim=-1) / rms).max()))
        d2 += float(d.double().pow(2).sum())
        r2 += float(want.double().pow(2).sum())
    return {"logit_max_rel": worst,
            "logit_rms_rel": math.sqrt(d2 / r2) if r2 else math.inf}


class Run:
    def __init__(self, cell, seed: int, device):
        t = cell.traffic
        if int(t.get("clients", 1)) != 1:
            raise ValueError("the closed loop drives one client")
        self.cell, self.seed, self.device = cell, seed, device
        self.raw = {k: v for k, v in cell.config.items() if k not in META}
        self.cfg = ref.config(self.raw)
        self.max_new, self.width = int(t["max_new"]), int(t["width"])
        lo, hi = t["prompt_tokens"]
        if not 0 < lo <= hi <= self.width:
            raise ValueError(f"prompt_tokens {t['prompt_tokens']} outside "
                             f"the width {self.width}")
        g = torch.Generator().manual_seed(seed % 2**63)
        self.batches: List[Batch] = []
        for p in range(int(t["pool_batches"])):
            lens = torch.randint(lo, hi + 1, (int(t["batch"]),),
                                 generator=g).tolist()
            prompts = [torch.randint(0, self.cfg.vocab_size, (n,),
                                     generator=g).tolist() for n in lens]
            self.batches.append(Batch(prompts, (seed * 1_000_003 + p)
                                      % 2**62))
        self.knobs = {"temperature": float(t["temperature"]),
                      "top_p": float(t["top_p"])}
        self.runner = self.spans = None
        self.tallies: Dict[str, torch.Tensor] = {}
        self.info: Dict[str, object] = {}

    def _runner(self):
        from classmate_rag_tpu_torch.generation.runner import DecodeRunner
        from classmate_rag_tpu_torch.models.decoder import DecoderConfig

        runner = DecodeRunner(
            config=DecoderConfig.from_hf_dict(self.raw),
            hf_state=ref.SeededState(self.cfg, self.seed, self.device),
            max_seq=self.width + self.max_new, max_new_tokens=self.max_new,
            device=self.device)
        if (runner.max_new, runner.max_seq - runner.max_new) != (
                self.max_new, self.width):
            raise ValueError(
                f"the runner decodes {runner.max_new} tokens after a width "
                f"of {runner.max_seq - runner.max_new}, not the traffic's")
        return runner

    def build(self, mark) -> None:
        self.runner = self._runner()
        mark("weights")
        for p, b in enumerate(self.batches):
            if serve_one(self.runner, b, self.knobs, p).out is None:
                raise RuntimeError(f"warm-up batch {p} failed")
            if p == 0:
                mark("first_batch")

    def drive(self, loop, seconds: float):
        from classmate_rag_tpu_torch.utils.metrics import metrics

        if not _profiling():
            return loop.drive(self.runner, self.batches, seconds, self.knobs)
        with metrics.tracing(tallies=self.tallies) as spans:
            win = loop.drive(self.runner, self.batches, seconds, self.knobs)
        self.spans = spans
        return win

    def free(self) -> None:
        self.runner = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def _rerun(self, picks, window):
        """Answer each sampled batch again with captures: (ids by pool,
        logits [max_new, V] by pick, router choices by pick: one [P, k]
        tensor a MoE layer over the row's prompt positions, from the
        prefill, or None where the program's router cannot be observed;
        a decode step's router may run inside a CUDA graph, unseen)."""
        from classmate_rag_tpu_torch.models import moe as program_moe

        runner = self._runner()
        route = getattr(program_moe, "route", None)
        rows_of: Dict[int, List[int]] = {}
        for p, r in picks:
            rows_of.setdefault(p, []).append(r)
        ids_of, logits, choices = {}, {}, {}
        n_moe = sum(ref.is_moe_layer(self.cfg, i)
                    for i in range(self.cfg.num_hidden_layers))
        try:
            for p, rows in rows_of.items():
                b = self.batches[p]
                B, W = len(b.prompts), self.width
                steps, calls = [], []

                def on_logits(i, lg, rows=rows, steps=steps):
                    steps.append(lg[rows].float().clone())

                def routed(normed, w, k, rows=rows, calls=calls, B=B, W=W):
                    out = route(normed, w, k)
                    if out[1].shape[0] == B * W:             # the prefill
                        calls.append(out[1].view(B, W, -1)[rows])
                    return out

                if route is not None:
                    program_moe.route = routed
                try:
                    ids_of[p] = runner.generate_ids_batch(
                        b.prompts, seed=b.seed, on_logits=on_logits,
                        **self.knobs)
                finally:
                    if route is not None:
                        program_moe.route = route
                for j, r in enumerate(rows):
                    logits[(p, r)] = torch.stack([s[j] for s in steps])
                    if route is None or not n_moe:
                        choices[(p, r)] = None
                        continue
                    pad = W - len(b.prompts[r])
                    choices[(p, r)] = [calls[m][j][pad:]
                                       for m in range(n_moe)]
        finally:
            del runner
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        mismatch = sum(
            sum(a != b for a, b in zip(s.out, ids_of[s.pool]))
            for s in window.served if s.out is not None and s.pool in ids_of)
        return ids_of, logits, choices, mismatch

    def _reference(self, picks, ids_of, control: bool):
        """(reference logits, control logits or None, router choices) of
        each pick over its prompt and served tokens, layer by layer."""
        cfg, dev, seed = self.cfg, self.device, self.seed
        shapes = ref.hf_shapes(cfg)
        rows = []
        for p, r in picks:
            prompt, out = self.batches[p].prompts[r], ids_of[p][r]
            n = len(out)
            feed = torch.tensor(prompt + out[:min(n, self.max_new - 1)],
                                device=dev)
            rows.append((feed, len(prompt), min(n + 1, self.max_new)))
        name = "model.embed_tokens.weight"
        emb = ref.draw(seed, name, shapes[name], dev)
        xs = [ref.embed({name: emb}.__getitem__, f) for f, _, _ in rows]
        del emb
        xc = list(xs) if control else None
        pos = [torch.arange(f.shape[0], device=dev) for f, _, _ in rows]
        ref_choices: List[List[torch.Tensor]] = [[] for _ in rows]
        for i in range(cfg.num_hidden_layers):
            w = ref.layer_weights(cfg, seed, i, dev)
            for j in range(len(rows)):
                xs[j], ch = ref.layer(w.__getitem__, cfg, i, xs[j], pos[j])
                if ch is not None:
                    ref_choices[j].append(ch)
            if control:
                getc = ref.control_getter(w.__getitem__)
                for j in range(len(rows)):
                    xc[j], _ = ref.layer(getc, cfg, i, xc[j], pos[j])
            del w
        hw = {n: ref.draw(seed, n, shapes[n], dev)
              for n in ("model.norm.weight", "lm_head.weight")}
        want, ctl = [], []
        for j, (_f, plen, K) in enumerate(rows):
            want.append(ref.head(hw.__getitem__, cfg, xs[j][plen - 1:
                                                            plen - 1 + K]))
            if control:
                ctl.append(ref.head(ref.control_getter(hw.__getitem__), cfg,
                                    xc[j][plen - 1:plen - 1 + K]))
        return want, (ctl if control else None), ref_choices

    def check(self, window, control: bool):
        limits = self.cell.limits
        pools = sorted({s.pool for s in window.served if s.out is not None})
        rng = random.Random(self.seed)
        # Rows of at most RERUN_POOLS batches: each is answered again.
        pools = sorted(rng.sample(pools, min(RERUN_POOLS, len(pools))))
        cand = [(p, r) for p in pools
                for r in range(len(self.batches[p].prompts))]
        picks = sorted(rng.sample(cand, min(int(limits["sample"]),
                                            len(cand))))
        self.info["sampled_rows"] = len(picks)
        t = self.tallies.get("moe.expert_tokens")
        if t is not None:
            per_layer = t.double()
            self.info["expert_tokens_max_over_mean"] = float(
                (per_layer.amax(dim=1) / per_layer.mean(dim=1)).max())
        if not picks:
            return False, {}, None
        ids_of, logits, prog_choices, mismatch = self._rerun(picks, window)
        want, ctl, ref_choices = self._reference(picks, ids_of, control)
        pairs = [(logits[pk][:w.shape[0]], w) for pk, w in zip(picks, want)]
        values = readings(pairs)
        values["rerun_token_mismatch"] = float(mismatch)
        differ = compared = 0
        for pk, rc in zip(picks, ref_choices):
            pc = prog_choices[pk]
            if pc is None:
                continue
            for a, b in zip(pc, rc):
                n = min(a.shape[0], b.shape[0])
                hit = (a[:n, :, None] == b[:n, None, :].to(a.device)).any(-1)
                differ += int((~hit).sum())
                compared += hit.numel()
        self.info["router_choices_differing"] = differ
        self.info["router_choices_compared"] = compared
        checks = {k: {"value": v, "limit": float(limits[k])}
                  for k, v in values.items()}
        correct = window.failed == 0 and all(
            c["value"] <= c["limit"] for c in checks.values())
        readings_ctl = None
        if ctl is not None:
            readings_ctl = readings(list(zip(ctl, want)))
        return correct, checks, readings_ctl

    def values(self) -> Dict[str, object]:
        return {"answer_config": self.cfg,
                "prompt_lens": [[len(x) for x in b.prompts]
                                for b in self.batches],
                "max_new": self.max_new,
                "spans": self.spans, "tallies": self.tallies}
