"""Measurement harnesses of the port: one module for each of the
repository's root ``tools/`` scripts, with its file name, its arguments
and the keys of its report, each run as
``python -m classmate_rag_tpu_torch.tools.<name>``.

Every tool takes ``--device`` (default CUDA; ``cpu`` runs the plain
path, as the tests do), prints one JSON line last, and exposes the
function that computes that line so that ``chip_smoke.py`` and the tests
call it in-process (``probe_cold_start`` excepted: a fresh process is
its point). Nothing runs at import.

    build_product_index   a persisted product index (the bench's layout)
    bench_serve           sustained /ask QPS through the HTTP server,
                          with a mutation storm
    probe_cold_start      fresh process to first answer, stage by stage
    probe_mutation_sync   the first ask after a 1-row mutation
    probe_fold_1m         the catalog's journal fold and a persist
    bench_ingest          ingest chunks/s over files x repeats
    bench_hybrid_profile  each stage of the fused step timed alone
    debug_recall_1m       per-miss decomposition against the oracle
    probe_first_dispatch  kernel build / load / first call of the step
    bench_ask             per-ask wall time, mean and p95
    bench_embed           encoder chunks/s and share of the bf16 peak
    bench_scan            the dense scan's routes side by side
    bench_encoder_roofline  the encoder step by component
    bench_decode          decode tokens/s
"""
