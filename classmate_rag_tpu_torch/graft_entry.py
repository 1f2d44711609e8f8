"""Driver entry points of the port (counterpart of the root
``__graft_entry__.py``).

- ``entry(device=None)``: the E5-base forward at full width with example
  inputs, ``(fn, args)`` so that ``fn(*args)`` is the forward ([8, 768]
  f32): ``fn`` is the ``E5Model`` (eval mode), ``args`` the reference's
  ids and all-ones mask on the device.
- ``dryrun_multichip(n_devices, device=None)``: six stages over n
  devices, each asserting that its result equals one device's on the same
  inputs: (a) one contrastive train step of the encoder over a ("data",
  "model") mesh; (b) the sharded hybrid step (dense scan + BM25 + RRF)
  over a corpus mesh, rows equal to the single-device step's; (c) the
  same with split-frequency BM25; (d) a dp×tp greedy decode, tokens equal
  to the single-device decode's; (e) the product path: ``get_runtime``
  builds a ``ShardedHybridIndex``, ask answers as a one-device runtime
  on the same on-disk index, and an admin delete is seen through the
  store's journal; (f) data-parallel encode, vectors equal to one
  device's.

Devices: the first n CUDA cards when the machine has them, else n logical
ranks of one card (``[cuda:0] * n``: the code that puts one rank on each
card). ``device="cpu"`` gives ``[cpu] * n``. Without CUDA and without
``device="cpu"`` both entry points raise; nothing moves to the CPU.

The inputs are drawn from one ``np.random.default_rng(0)`` in the
reference's order (``dryrun_inputs``), so every stage sees the reference
dryrun's numbers. Each stage is a function that returns what it checked.

    python -m classmate_rag_tpu_torch.graft_entry

runs the forward on the card, then ``dryrun_multichip`` over every card,
or over 4 logical ranks of a machine's only card (one device cannot
shard stage (e)).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from classmate_rag_tpu_torch.device import (
    DeviceLike,
    resolve_device,
    synchronize,
)
from classmate_rag_tpu_torch.embeddings.model import (
    EncoderConfig,
    init_params,
    params_from_numpy,
)

ENTRY_BATCH, ENTRY_SEQ = 8, 128
TRAIN_SEQ = 16
ROWS_PER_SHARD, DIM, WIDTH, VOCAB_PAD, N_TERMS = 16, 64, 16, 4096, 500
TOP_K = 4
DECODE_MAX_SEQ, DECODE_PROMPT, DECODE_NEW = 24, 5, 6
FUSED_ATOL = 1e-5       # sharded vs single-device fused scores (f32)
ENCODE_ATOL = 1e-6      # data-parallel vs single-device vectors


def entry(device: DeviceLike = None):
    """(fn, (input_ids, attention_mask)): E5-base from
    ``init_params(config, "graft-entry")`` on ``device`` (None: CUDA) and
    the reference's example batch, B 8, T 128."""
    dev = resolve_device(device)
    config = EncoderConfig.base()
    model = params_from_numpy(init_params(config, "graft-entry"), config,
                              dev)
    ids = np.random.default_rng(0).integers(
        4, config.vocab_size, (ENTRY_BATCH, ENTRY_SEQ)).astype(np.int32)
    return model, (torch.from_numpy(ids).to(dev),
                   torch.ones(ENTRY_BATCH, ENTRY_SEQ, dtype=torch.int32,
                              device=dev))


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------

def dryrun_devices(n_devices: int, device: DeviceLike = None
                   ) -> List[torch.device]:
    """The dryrun's n devices: the first n CUDA cards when there are that
    many, else n logical ranks of ``device`` (None: CUDA; raises without
    it)."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, asked for {n_devices}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() >= n_devices > 1:
            return [torch.device("cuda", i) for i in range(n_devices)]
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * n_devices


def dryrun_inputs(devices: Sequence[torch.device]) -> Dict[str, np.ndarray]:
    """Every stage's random inputs for a dryrun over ``devices``, drawn
    from one default_rng(0) in the reference's order: (a) query and
    passage ids, (b) the corpus (unit embeddings, term ids, term
    frequencies; 16 rows a device), (d) the decode prompts. The batches
    of (a) and (d) divide over the training mesh's data axis."""
    from classmate_rag_tpu_torch.parallel.mesh import training_mesh

    n_devices = len(devices)
    data_axis = training_mesh(devices=devices).shape["data"]
    rng = np.random.default_rng(0)
    vocab = EncoderConfig.small_test().vocab_size
    batch = data_axis * max(2, -(-8 // data_axis))
    q_ids = rng.integers(4, vocab, (batch, TRAIN_SEQ)).astype(np.int32)
    p_ids = rng.integers(4, vocab, (batch, TRAIN_SEQ)).astype(np.int32)
    n_rows = ROWS_PER_SHARD * n_devices
    emb = rng.standard_normal((n_rows, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    term_ids = rng.integers(0, N_TERMS, (n_rows, WIDTH)).astype(np.int32)
    tfs = rng.integers(1, 4, (n_rows, WIDTH)).astype(np.uint8)
    prompt = rng.integers(4, decoder_config().vocab_size,
                          (2 * data_axis, DECODE_PROMPT)).astype(np.int32)
    return {
        "q_ids": q_ids, "p_ids": p_ids,
        "mask": np.ones((batch, TRAIN_SEQ), np.int32),
        "emb": emb, "term_ids": term_ids, "tfs": tfs,
        "doc_len": np.full(n_rows, float(WIDTH), np.float32),
        "bias": np.zeros(n_rows, np.float32),
        "q_vecs": emb[:2] + 0.01,
        "q_terms": term_ids[:2, :8].astype(np.int32),
        "q_counts": np.ones((2, 8), np.float32),
        "prompt": prompt,
        "prompt_len": np.full(2 * data_axis, DECODE_PROMPT, np.int32),
    }


def decoder_config():
    """Stage (d)'s decoder: tiny, f32, 4 KV heads (the mesh's model axis,
    1, 2 or 4, must divide them)."""
    from classmate_rag_tpu_torch.models.decoder import DecoderConfig

    return dataclasses.replace(DecoderConfig.tiny_test(),
                               compute_dtype=torch.float32, kv_heads=4)


def _check(cond, msg: str) -> None:
    """A stage's assertion (kept under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def _blocks(x: np.ndarray, devices: Sequence[torch.device], dim: int = 0,
            dtype=None) -> List[torch.Tensor]:
    """A global array as one equal block a shard along ``dim``, each on
    its shard's device (a copy of its own)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None:
        t = t.to(dtype)
    return [b.to(d, copy=True).contiguous()
            for b, d in zip(t.chunk(len(devices), dim), devices)]


def _on(dev: torch.device, *arrays) -> List[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def stage_train(devices: Sequence[torch.device],
                inputs: Dict[str, np.ndarray]) -> float:
    """(a) One contrastive train step of the small encoder over the
    ("data", "model") mesh of ``devices``; returns the loss."""
    from classmate_rag_tpu_torch.parallel.mesh import training_mesh
    from classmate_rag_tpu_torch.training import make_train_step

    config = EncoderConfig.small_test()
    mesh = training_mesh(devices=devices)
    init_state, train_step = make_train_step(config, mesh,
                                             learning_rate=1e-3)
    state = init_state(init_params(config, "dryrun"))
    mask = inputs["mask"]
    state, loss = train_step(state, inputs["q_ids"], mask, inputs["p_ids"],
                             mask)
    loss = float(loss)
    _check(np.isfinite(loss), f"train step loss {loss}")
    print(f"[dryrun] train step ok on {mesh.shape}: loss={loss:.4f}")
    return loss


def _same_step(got, want, what: str):
    rows, want_rows = got.rows.cpu().numpy(), want.rows.cpu().numpy()
    _check(np.array_equal(rows, want_rows),
           f"{what} != single-device step: {rows} vs {want_rows}")
    fused = got.fused.cpu().numpy()
    np.testing.assert_allclose(want.fused.cpu().numpy(), fused,
                               atol=FUSED_ATOL)
    return rows, fused


def stage_sharded_hybrid(devices: Sequence[torch.device],
                         inputs: Dict[str, np.ndarray]):
    """(b) The sharded hybrid step (gather-pass BM25) over the corpus
    mesh of ``devices``, held against the single-device fused step on the
    mesh's first device; returns (rows [2, 4], fused [2, 4])."""
    from classmate_rag_tpu_torch.index.lexical import subset_df
    from classmate_rag_tpu_torch.ops.hybrid_step import hybrid_query_step
    from classmate_rag_tpu_torch.parallel.mesh import corpus_mesh
    from classmate_rag_tpu_torch.parallel.sharded import (
        make_sharded_hybrid_fn,
    )

    x = inputs
    mesh = corpus_mesh(devices=devices)
    fn = make_sharded_hybrid_fn(mesh, vocab_pad=VOCAB_PAD, top_k=TOP_K)
    out = fn(
        _blocks(x["emb"], mesh, dtype=torch.bfloat16),
        _blocks(x["term_ids"], mesh), _blocks(x["tfs"], mesh),
        _blocks(x["doc_len"], mesh), _blocks(x["bias"], mesh),
        x["q_vecs"], x["q_terms"], x["q_counts"],
    )
    _check(tuple(out.rows.shape) == (2, TOP_K), f"rows {out.rows.shape}")
    dev = mesh[0]
    emb, term_ids, tfs, doc_len, bias = _on(
        dev, x["emb"], x["term_ids"], x["tfs"], x["doc_len"], x["bias"])
    df = subset_df(term_ids, tfs,
                   torch.ones(len(bias), dtype=torch.bool, device=dev),
                   VOCAB_PAD)
    single = hybrid_query_step(
        emb.bfloat16(), term_ids, tfs, doc_len, df, bias,
        *_on(dev, x["q_vecs"], x["q_terms"], x["q_counts"]),
        top_k=TOP_K, vocab_pad=VOCAB_PAD,
    )
    rows, fused = _same_step(out, single, "sharded")
    print(f"[dryrun] sharded hybrid query ok on {len(mesh)} shards: "
          f"rows[0]={rows[0]} — bit-identical to single-device step")
    return rows, fused


def stage_split_hybrid(devices: Sequence[torch.device],
                       inputs: Dict[str, np.ndarray]):
    """(c) The sharded step with split-frequency BM25 (head matrix by
    columns, tail postings partitioned by shard), held against the
    single-device split step; returns (rows [2, 4], fused [2, 4])."""
    from classmate_rag_tpu_torch.index.lexical import (
        STEP_COLUMNS,
        build_split_layout,
        shard_postings,
        shard_tail_ranges,
        split_query_arrays,
        subset_df,
    )
    from classmate_rag_tpu_torch.ops.hybrid_step import (
        hybrid_query_step_split,
    )
    from classmate_rag_tpu_torch.parallel.mesh import corpus_mesh
    from classmate_rag_tpu_torch.parallel.sharded import (
        make_sharded_split_hybrid_fn,
    )

    x = inputs
    mesh = corpus_mesh(devices=devices)
    layout = build_split_layout(x["term_ids"], x["tfs"], N_TERMS,
                                head_bytes_budget=1 << 20,
                                head_df_threshold=2)
    qa = split_query_arrays(layout["lut"], layout["offsets"], x["q_terms"],
                            x["q_counts"], r_cap=layout["r_cap"])
    r_cap = layout["r_cap"]
    has_terms = np.any(x["q_terms"] >= 0, axis=1, keepdims=True)
    dev = mesh[0]
    term_ids, tfs, bias = _on(dev, x["term_ids"], x["tfs"], x["bias"])
    df = subset_df(term_ids, tfs,
                   torch.ones(len(bias), dtype=torch.bool, device=dev),
                   VOCAB_PAD)
    single = hybrid_query_step_split(
        _on(dev, x["emb"])[0].bfloat16(),
        *_on(dev, layout["tf_head"], layout["post_rows"],
             layout["post_tfs"], x["doc_len"]),
        df, bias,
        *_on(dev, x["q_vecs"], *(qa[k] for k in STEP_COLUMNS),
             x["q_terms"], x["q_counts"], has_terms),
        r_cap=r_cap, top_k=TOP_K, vocab_pad=VOCAB_PAD,
    )
    s = len(mesh)
    post_rows_sh, post_tfs_sh, offsets_sh = shard_postings(
        layout["post_rows"], layout["post_tfs"], layout["offsets"], s,
        len(x["bias"]) // s, r_cap,
    )
    u_starts_sh, u_lens_sh = shard_tail_ranges(offsets_sh, qa["u_tids"],
                                               r_cap=r_cap)
    fn = make_sharded_split_hybrid_fn(mesh, r_cap=r_cap, top_k=TOP_K,
                                      vocab_pad=VOCAB_PAD)
    out = fn(
        _blocks(x["emb"], mesh, dtype=torch.bfloat16),
        _blocks(x["term_ids"], mesh), _blocks(x["tfs"], mesh),
        _blocks(layout["tf_head"], mesh, dim=1),
        post_rows_sh, post_tfs_sh,
        _blocks(x["doc_len"], mesh), _blocks(x["bias"], mesh),
        x["q_vecs"], qa["h_slots"], qa["h_tids"], u_starts_sh, u_lens_sh,
        qa["u_cols"], qa["t_tids"], x["q_terms"], x["q_counts"], has_terms,
    )
    rows, fused = _same_step(out, single, "sharded split-BM25")
    print(f"[dryrun] sharded SPLIT-BM25 hybrid ok on {s} shards: "
          f"rows[0]={rows[0]} — bit-identical to single-device split step")
    return rows, fused


def stage_tp_decode(devices: Sequence[torch.device],
                    inputs: Dict[str, np.ndarray]) -> np.ndarray:
    """(d) Greedy decode over the ("data", "model") mesh of ``devices``
    (heads, KV heads and FFN split over "model"), tokens equal to the
    single-device decode's; returns the tokens [B, 6]."""
    from classmate_rag_tpu_torch.models.decoder import (
        init_params as decoder_init,
        make_generate_fn,
        params_from_numpy as decoder_params,
    )
    from classmate_rag_tpu_torch.parallel.mesh import training_mesh
    from classmate_rag_tpu_torch.parallel.tp_decode import (
        make_tp_generate_fn,
        shard_decoder_params,
    )

    config = decoder_config()
    params = decoder_init(config, "dryrun-tp")
    mesh = training_mesh(devices=devices)
    args = (inputs["prompt"], inputs["prompt_len"], 0, 0.0, 1.0, 2)
    want = make_generate_fn(config, DECODE_MAX_SEQ, DECODE_NEW)(
        decoder_params(params, config, mesh[0][0]), *args).cpu().numpy()
    got = make_tp_generate_fn(config, mesh, DECODE_MAX_SEQ, DECODE_NEW)(
        shard_decoder_params(params, config, mesh), *args).cpu().numpy()
    _check(np.array_equal(want, got),
           f"tp decode != single-device decode: {got} vs {want}")
    print(f"[dryrun] dp x tp decode ok on {mesh.shape}: tokens[0]={got[0]} "
          f"— identical to single-device decode")
    return got


@contextlib.contextmanager
def _product_scope(root: Path, devices: Sequence[torch.device]):
    """Stage (e)'s process state, restored on the way out: the index
    directories under ``root``, the hash embedder and the extractive
    answerer in the environment; the runtime's local devices replaced by
    ``devices`` (so one card, or the CPU, stands for n); and the runtime
    singleton and the loaded config as they were."""
    from classmate_rag_tpu_torch.config import load_config
    from classmate_rag_tpu_torch.pipeline import runtime

    env = {
        "INDEX_DIR": f"{root}/indexes",
        "DENSE_DIR": f"{root}/indexes/dense",
        "BM25_DIR": f"{root}/indexes/bm25",
        "EMB_CACHE_DIR": f"{root}/indexes/emb_cache",
        "EMBEDDING_BACKEND": "hash",
        # The answerer is not under test (both runtimes use the same
        # one); "auto" could try to fetch the configured GGUF.
        "LLM_BACKEND": "extractive",
        "N_SHARDS": "1",
    }
    saved_env = {k: os.environ.get(k) for k in env}
    saved_rt, saved_local = runtime._RUNTIME, runtime.local_devices
    try:
        os.environ.update(env)
        runtime.local_devices = lambda _device=None: list(devices)
        yield
    finally:
        runtime.local_devices = saved_local
        runtime._RUNTIME = saved_rt
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        load_config(reload=True)


def stage_product(devices: Sequence[torch.device]) -> Dict[str, list]:
    """(e) The product path: ingest and ask on a one-device runtime, then
    a runtime with ``N_SHARDS`` = n over the same on-disk index must build
    a ``ShardedHybridIndex`` and answer identically; a deleted chunk
    leaves its answers after the journal refresh. Returns the retrieved
    ids of both runtimes, the deleted id and the ids after the delete."""
    from classmate_rag_tpu_torch.config import load_config
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline.ask import ask_question
    from classmate_rag_tpu_torch.pipeline.ingest import ingest_file
    from classmate_rag_tpu_torch.pipeline.runtime import (
        get_runtime,
        reset_runtime,
    )

    tmp = Path(tempfile.mkdtemp(prefix="dryrun_rt_"))
    try:
        with _product_scope(tmp, devices):
            doc = tmp / "doc.txt"
            doc.write_text(
                "The derivative measures the rate of change of a function. "
                "The chain rule differentiates composed functions.\n\n"
                "Boil salted water to cook pasta for nine minutes."
            )
            load_config(reload=True)
            reset_runtime()
            rt1 = get_runtime(reload=True, device=devices[0])
            ingest_file(path=doc, doc_meta=normalize_cli_metadata(
                course="c1"), runtime=rt1)
            q = "what is the derivative"

            def ask(rt):
                return ask_question(question=q,
                                    filters=normalize_cli_metadata(),
                                    runtime=rt, top_k=4)

            want = ask(rt1)
            os.environ["N_SHARDS"] = str(len(devices))
            load_config(reload=True)
            reset_runtime()
            rt2 = get_runtime(reload=True, device=devices[0])
            _check(rt2.sharded is not None, "runtime must auto-shard")
            got = ask(rt2)
            _check(got.answer == want.answer,
                   f"answers differ: {got.answer!r} vs {want.answer!r}")
            ids = [r["id"] for r in got.retrieved]
            want_ids = [r["id"] for r in want.retrieved]
            _check(ids == want_ids, f"retrieved {ids} vs {want_ids}")
            # An admin mutation reaches the placed state via the journal.
            victim = ids[0]
            rt2.store.delete([victim])
            rt2.catalog.delete([victim])
            after = [r["id"] for r in ask(rt2).retrieved]
            _check(victim not in after, f"deleted {victim} still in {after}")
            print(f"[dryrun] PRODUCT Runtime sharded ask ok on "
                  f"{rt2.sharded.n_shards} shards — answer identical to "
                  f"single-device runtime; delete visible after journal "
                  f"refresh")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"want": want_ids, "got": ids, "victim": victim, "after": after}


def stage_dp_encode(devices: Sequence[torch.device]):
    """(f) Data-parallel encode of 16 texts with the small encoder, one
    replica a device, against one device's encode; returns (vectors of
    the replicas, vectors of one device)."""
    from classmate_rag_tpu_torch.embeddings.encoder import E5Encoder

    config = EncoderConfig.small_test()
    texts = [f"document {i} about subject {i % 3}" for i in range(16)]
    one = E5Encoder(model_name="dryrun-enc", config=config,
                    data_parallel=1, device=devices[0])
    many = E5Encoder(model_name="dryrun-enc", config=config,
                     data_parallel=len(devices), device=devices[0],
                     devices=devices)
    v1 = one.encode_passages(texts)
    vn = many.encode_passages(texts)
    np.testing.assert_allclose(vn, v1, atol=ENCODE_ATOL)
    print(f"[dryrun] dp bulk encode ok on {many._dp} devices — vectors "
          f"identical to single-device encode")
    return vn, v1


def _launch_counts() -> Dict[str, int]:
    from classmate_rag_tpu_torch.ops import (
        attention,
        bm25_core,
        encoder_fused,
        topk,
    )

    return {k: v for m in (topk, encoder_fused, attention, bm25_core)
            for k, v in m.LAUNCHES.items()}


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """Run stages (a)-(f) over ``n_devices`` devices (see
    ``dryrun_devices``); every stage asserts its equality to one device.
    Returns each stage's result under its letter, with its seconds and
    the kernel launches it made (``seconds``, ``launches``)."""
    devices = dryrun_devices(n_devices, device)
    cards = len(set(devices)) == n_devices and n_devices > 1
    print(f"[dryrun] {n_devices} "
          + (f"cards: {[str(d) for d in devices]}" if cards else
             f"logical ranks of {devices[0]}"))
    inputs = dryrun_inputs(devices)
    stages = (
        ("a", lambda: stage_train(devices, inputs)),
        ("b", lambda: stage_sharded_hybrid(devices, inputs)),
        ("c", lambda: stage_split_hybrid(devices, inputs)),
        ("d", lambda: stage_tp_decode(devices, inputs)),
        ("e", lambda: stage_product(devices)),
        ("f", lambda: stage_dp_encode(devices)),
    )
    out = {"devices": [str(d) for d in devices], "seconds": {},
           "launches": {}}
    for name, run in stages:
        before = _launch_counts()
        t0 = time.perf_counter()
        out[name] = run()
        for d in set(devices):
            synchronize(d)
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = {k: v - before[k]
                                 for k, v in _launch_counts().items()}
    return out


def main() -> int:
    fn, args = entry()
    with torch.inference_mode():
        out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
    # One card cannot shard stage (e): its logical ranks stand for 4.
    count = torch.cuda.device_count()
    dryrun_multichip(count if count > 1 else 4)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
