"""The ``answer`` kind (``kinds/answer.py``) at a tiny DeepSeek-V2 shape on
the CPU: the cell runs through the harness and is correct; a planted
fault in the program, a served answer that the rerun does not give
again, and the control come out not correct; ``work_answer.py``'s counts
at known shapes; the new readers on canned spans, and None untraced."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from rag_bench import run, spec, work, work_answer
from rag_bench.reference import deepseek_v2 as ref
from rag_bench.trace import Trace
from rag_bench.window import Served, Window

CELL = "deepseek-v2-lite.rag-answer-b64"
SEED = 2**33 + 5
# At this shape (hidden 64, 4 layers) the bf16 program stands 0.024 (max)
# and 0.0038 (RMS) from the f32 reference; the float8 control 0.22 and
# 0.057. The limits lie between, 2-4 times above the program's readings.
TINY_LIMITS = {"sample": 3, "logit_max_rel": 0.1, "logit_rms_rel": 0.02,
               "rerun_token_mismatch": 0}


def tiny_cell():
    cell = spec.load_cell(CELL)
    small = dict(
        hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=4, intermediate_size=128, kv_lora_rank=32,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        n_routed_experts=8, num_experts_per_tok=3, moe_intermediate_size=32,
        vocab_size=512, rope_scaling=dict(
            cell.config["rope_scaling"],
            original_max_position_embeddings=64))
    return dataclasses.replace(
        cell, config=dict(cell.config, **small),
        traffic=dict(cell.traffic, batch=4, pool_batches=2,
                     prompt_tokens=[10, 20], width=24, max_seq=32,
                     max_new=8),
        limits=TINY_LIMITS)


def run_tiny(trace=False, control=False):
    import time

    return run.run_cell(tiny_cell(), SEED, 0.3, trace, "cpu",
                        time.perf_counter(), control=control)


def test_cell_runs_through_the_harness():
    for trace in (False, True):
        res = run_tiny(trace=trace)
        assert res["correct"], res["checks"]
        assert res["attempted"] >= 4 and res["failed"] == 0
        assert set(res["checks"]) == {"logit_max_rel", "logit_rms_rel",
                                      "rerun_token_mismatch"}
        assert res["checks"]["rerun_token_mismatch"]["value"] == 0
        info = res["info"]
        assert info["sampled_rows"] == 3
        assert info["router_choices_compared"] > 0
        phases = info["setup_phases_end_s"]
        assert phases["inputs"] < phases["weights"] <= phases["first_batch"]
        # On the CPU the profiler does not run: no span, trace or peak,
        # so every per-layer reader of the cell has nothing to read.
        want = {"query_qps", "setup_s"} if not trace else set()
        assert set(res["metrics"]) == want


def test_planted_fault_is_not_correct(monkeypatch):
    """One expert's weights perturbed in the program (and in its rerun)."""
    from classmate_rag_tpu_torch.models import hf_state

    convert = hf_state.params_from_hf_state

    def faulty(state, config, device=None):
        tree = convert(state, config, device)
        w = tree["layers"][1]["experts_gate_up"]
        w[0] += 0.05 * torch.randn(w[0].shape, generator=torch.Generator()
                                   .manual_seed(0)).to(w.dtype)
        return tree

    monkeypatch.setattr(hf_state, "params_from_hf_state", faulty)
    res = run_tiny()
    assert not res["correct"]
    c = res["checks"]
    assert (c["logit_max_rel"]["value"] > c["logit_max_rel"]["limit"]
            or c["logit_rms_rel"]["value"] > c["logit_rms_rel"]["limit"])


def test_answer_not_given_again_is_not_correct(monkeypatch):
    from rag_bench.loops import closed_answer

    serve = closed_answer.serve_one

    def altered(runner, batch, knobs, pool):
        s = serve(runner, batch, knobs, pool)
        if s.out is not None:
            s.out[0] = [t + 1 for t in s.out[0]] or [1]
        return s

    monkeypatch.setattr(closed_answer, "serve_one", altered)
    res = run_tiny()
    assert not res["correct"]
    assert res["checks"]["rerun_token_mismatch"]["value"] > 0


def test_control_fails_a_limit():
    res = run_tiny(control=True)
    assert res["correct"]
    ctl, lim = res["control"], TINY_LIMITS
    assert (ctl["logit_max_rel"] > lim["logit_max_rel"]
            or ctl["logit_rms_rel"] > lim["logit_rms_rel"])


def test_fp8_control_rounds_each_output_channel():
    w = torch.tensor([[1.0, 0.3, -0.01], [100.0, 7.0, 3.0]])
    got = ref.fp8_round(w)
    assert got[0, 0] == 1.0 and got[1, 0] == 100.0       # amax maps to 448
    assert torch.allclose(got, w, rtol=2 ** -3) and not torch.equal(got, w)
    get = ref.control_getter({"a": w, "model.embed_tokens.weight": w,
                              "g": w[0]}.__getitem__)
    assert torch.equal(get("a"), got)
    assert torch.equal(get("model.embed_tokens.weight"), w)
    assert torch.equal(get("g"), w[0])


def _lite():
    return ref.config({k: v for k, v in spec.load_cell(CELL).config.items()
                       if k not in ("kind", "source", "deployment",
                                    "reduced", "assumed")})


def test_work_answer_counts_at_published_shapes():
    cfg = _lite()
    n = sum(torch.Size(s).numel() for s in ref.hf_shapes(cfg).values())
    assert n == 15_706_484_224                           # 15.71 B
    emb = 102400 * 2048
    assert work_answer.weight_bytes(cfg) == 2.0 * (n - emb)
    assert work_answer.expert_bytes(cfg) == 2.0 * 26 * 64 * 3 * 2048 * 1408
    assert work_answer.n_moe_layers(cfg) == 26
    assert work_answer.latent_width(cfg) == 576
    # A decode step of one row at 1,000 cached positions.
    per_token = 2.0 * (
        27 * (2048 * 16 * 192 + 2048 * 576 + 16 * 128 * 2048
              + 16 * (128 * 512 + 512 * 128))
        + 26 * (2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816)
        + 3 * 2048 * 10944) + 2.0 * 2048 * 102400
    attn = 27 * 2.0 * 16 * (576 + 512) * 1000
    assert work_answer.decode_flops(cfg, [1000]) == pytest.approx(
        per_token + attn, rel=1e-12)
    assert work_answer.decode_bytes(cfg, [1000]) == pytest.approx(
        work_answer.weight_bytes(cfg) + 2 * 2048 + 1001 * 27 * 576 * 2,
        rel=1e-12)
    peak = (989e12, 3.35e12)
    # Decode is bound by the bytes: ~9.3 ms a step at 64 rows.
    ctx = [1000] * 64
    assert work.least_s(work_answer.decode_flops(cfg, ctx),
                        work_answer.decode_bytes(cfg, ctx), peak) == \
        pytest.approx(work_answer.decode_bytes(cfg, ctx) / 3.35e12)
    # Prefill is bound by the FLOPs.
    lens = [830] * 64
    assert work_answer.prefill_flops(cfg, lens) / 989e12 > \
        work_answer.prefill_bytes(cfg, lens) / 3.35e12
    assert work_answer.batch_least_s(cfg, [1], 2, peak) == pytest.approx(
        work.least_s(work_answer.prefill_flops(cfg, [1]),
                     work_answer.prefill_bytes(cfg, [1]), peak)
        + work.least_s(work_answer.decode_flops(cfg, [2]),
                       work_answer.decode_bytes(cfg, [2]), peak))
    # A decode step: 64 rows x 6 experts x 26 layers of pairs; the
    # experts' bytes bound it.
    assert work_answer.experts_least_s(cfg, 64 * 6 * 26, peak) == \
        pytest.approx(2.0 * 26 * 64 * 3 * 2048 * 1408 / 3.35e12)


class _Events:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _span(name, t0, t1, batch_id, **counts):
    return SimpleNamespace(name=name, t0_ns=t0, t1_ns=t1, batch_id=batch_id,
                           counts=counts)


MS = 1_000_000
READERS = ("answer_mfu", "prefill_device_ms", "decode_step_device_ms",
           "decode_step_host_ms", "moe_experts_roofline")


def _ctx(traced=True):
    cfg = _lite()
    w = Window([Served(0, 0, 4000 * MS, 4000 * MS, 64, [[1]] * 64),
                Served(1, 4000 * MS, 9000 * MS, 9000 * MS, 64, [[1]] * 64)])
    spans = [
        _span("decode.prefill", 0, 3 * MS, 1, rows=64, tokens=64 * 1024,
              cuda_events=(_Events(0.0), _Events(300.0))),
        _span("moe.experts", MS, 2 * MS, 1, routed_pairs=64 * 1024 * 6),
        _span("decode.step", 3 * MS, 23 * MS, 2, rows=64, step=0,
              cuda_events=(_Events(300.0), _Events(315.0))),
        _span("decode.step", 23 * MS, 33 * MS, 3, rows=64, step=1,
              cuda_events=(_Events(315.0), _Events(340.0))),
        # The last step samples and runs no forward.
        _span("decode.step", 33 * MS, 34 * MS, 4, rows=64, step=255,
              cuda_events=(_Events(340.0), _Events(340.5))),
    ]
    ops = [("void cutlass::device_kernel<GroupProblemShape<...>>(...)",
            0, 200 * MS),
           ("sm90_xmma_gemm_bf16bf16_bf16f32", 200 * MS, 250 * MS)]
    return run.Context(w, 30.0, Trace(ops, 0) if traced else None,
                       (989e12, 3.35e12), answer_config=cfg,
                       prompt_lens=[[800] * 64, [900] * 64], max_new=256,
                       spans=spans if traced else None, tallies={})


def test_readers_on_canned_spans():
    ctx = _ctx()
    assert run.read_metric("prefill_device_ms", ctx) == 300.0
    assert run.read_metric("decode_step_device_ms", ctx) == 40.5 / 3
    assert run.read_metric("decode_step_host_ms", ctx) == 31 / 3
    cfg = ctx.answer_config
    # Pairs: tokens x 6 experts x 26 expert layers.
    least = (work_answer.experts_least_s(cfg, 64 * 1024 * 6 * 26, ctx.peak)
             + 2 * work_answer.experts_least_s(cfg, 64 * 6 * 26, ctx.peak))
    assert run.read_metric("moe_experts_roofline", ctx) == pytest.approx(
        100 * least / 0.2)
    want = 100 * (work_answer.batch_least_s(cfg, [800] * 64, 256, ctx.peak)
                  + work_answer.batch_least_s(cfg, [900] * 64, 256,
                                              ctx.peak)) / 9.0
    assert run.read_metric("answer_mfu", ctx) == pytest.approx(want)
    assert 0 < want < 100


@pytest.mark.parametrize("name", READERS[1:])
def test_new_readers_return_none_untraced(name):
    assert run.read_metric(name, _ctx(traced=False)) is None


def test_answer_mfu_needs_a_known_card():
    ctx = _ctx(traced=False)
    ctx.peak = None
    assert run.read_metric("answer_mfu", ctx) is None
