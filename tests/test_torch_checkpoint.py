"""The port's training checkpoints (classmate_rag_tpu_torch/training/
checkpoint.py) and the train → serve loop, on the CPU.

- save, restore and resume: a restored state continues exactly as the
  one that was saved (bit-equal parameters on the CPU);
- ``_params_digest`` equals the JAX package's on the same parameters, so
  both packages key the embedding cache alike;
- ``get_embedder(checkpoint=...)`` serves vectors equal to the trained
  model's (to 1e-6: the same bf16 roundings of the same f32 weights);
- the port version of tests/test_train_to_serve.py: fine-tune, save,
  serve through ``ENCODER_CHECKPOINT``, and held-out dense retrieval
  accuracy improves.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from classmate_rag_tpu.embeddings import model as jm
from classmate_rag_tpu.training.checkpoint import (
    _params_digest as j_digest,
)
from classmate_rag_tpu_torch.config import EmbeddingConfig
from classmate_rag_tpu_torch.embeddings import get_embedder
from classmate_rag_tpu_torch.embeddings.model import EncoderConfig
from classmate_rag_tpu_torch.embeddings.tokenizer import (
    load_tokenizer,
    pad_to_bucket,
)
from classmate_rag_tpu_torch.training import make_train_step
from classmate_rag_tpu_torch.training.checkpoint import (
    _params_digest,
    latest_checkpoint,
    load_encoder_checkpoint,
    restore_train_state,
    save_train_state,
)
from classmate_rag_tpu_torch.training.data import encode_pairs

# The corpus of tests/test_train_to_serve.py: 8 "courses" whose doc
# words and query words are disjoint vocabularies, so only the training
# pairs link them; held-out queries carry a distractor word of the next
# course's document.
WORDS = [
    ["tensor", "gradient", "backprop", "optimizer", "softmax", "epoch"],
    ["sonnet", "stanza", "meter", "rhyme", "verse", "couplet"],
    ["glacier", "moraine", "crevasse", "icefall", "serac", "firn"],
    ["enzyme", "substrate", "catalysis", "kinase", "ligand", "protein"],
    ["fresco", "pigment", "plaster", "mural", "tempera", "gesso"],
    ["torque", "flywheel", "camshaft", "piston", "crankshaft", "valve"],
    ["sonata", "allegro", "crescendo", "tempo", "cadence", "fugue"],
    ["plankton", "krill", "baleen", "cetacean", "pod", "blowhole"],
]
QWORDS = [
    ["apple", "banana", "cherry"], ["delta", "echo", "foxtrot"],
    ["green", "harbor", "island"], ["jungle", "kitten", "lemon"],
    ["mango", "noodle", "orange"], ["pepper", "quartz", "river"],
    ["sunset", "turtle", "umbrella"], ["violet", "walnut", "yellow"],
]


def _doc_text(i):
    w = WORDS[i]
    return (f"Lecture notes on {w[0]} and {w[1]}. The {w[2]} interacts with "
            f"the {w[3]}. Remember that {w[4]} relates to {w[5]} in every "
            f"exercise about {w[0]}.")


def _train_query(i):
    return "explain " + " ".join(QWORDS[i])


def _heldout_query(i):
    q = QWORDS[i]
    return f"overview of {q[1]} {q[2]} near {WORDS[(i + 1) % len(WORDS)][0]}"


def _batches(cfg, seq_len=48):
    tok = load_tokenizer(None, max_length=seq_len, vocab_size=cfg.vocab_size)
    pairs = [(_train_query(i), _doc_text(i)) for i in range(len(WORDS))]
    return list(encode_pairs(pairs, tok, batch_size=8, seq_len=seq_len))


def _tree(cfg, key="ckpt-test"):
    from classmate_rag_tpu_torch.embeddings.model import init_params

    return init_params(cfg, key)


def _leaves(state):
    return jax.tree_util.tree_leaves(state.params.params_numpy())


@pytest.mark.parametrize("accum", [1, 2])
def test_save_restore_resume(tmp_path, accum):
    cfg = EncoderConfig.small_test()
    init, step = make_train_step(cfg, "cpu", learning_rate=1e-3,
                                 warmup_steps=1, total_steps=6,
                                 accum_steps=accum)
    batches = _batches(cfg)
    state = init(_tree(cfg))
    for _ in range(3):
        state, _ = step(state, *batches[0])
    path = save_train_state(state, tmp_path, config=cfg)
    assert path.endswith("step_3") and latest_checkpoint(tmp_path).name \
        == "step_3"

    restored = restore_train_state(tmp_path, init(_tree(cfg, "other")))
    assert restored.step == 3
    for a, b in zip(_leaves(restored), _leaves(state)):
        np.testing.assert_array_equal(a, b)
    state, loss_a = step(state, *batches[0])
    restored, loss_b = step(restored, *batches[0])
    assert float(loss_a) == float(loss_b)
    for a, b in zip(_leaves(restored), _leaves(state)):
        np.testing.assert_array_equal(a, b)

    save_train_state(state, tmp_path)
    assert latest_checkpoint(tmp_path).name == "step_4"
    params, config, tag = load_encoder_checkpoint(tmp_path)
    assert config == cfg and tag.startswith("ckpt-step_4-")
    assert params["layers"]["q_w"].shape == (cfg.layers, cfg.hidden,
                                             cfg.hidden)


def test_no_checkpoint(tmp_path):
    cfg = EncoderConfig.small_test()
    init, _ = make_train_step(cfg, "cpu")
    assert latest_checkpoint(tmp_path / "absent") is None
    assert latest_checkpoint(tmp_path) is None
    assert restore_train_state(tmp_path, init(_tree(cfg))) is None
    with pytest.raises(FileNotFoundError):
        load_encoder_checkpoint(tmp_path)


def test_orbax_checkpoint_refused(tmp_path):
    """A JAX package checkpoint (an orbax directory) needs JAX to read."""
    step = tmp_path / "step_7"
    step.mkdir()
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    (tmp_path / "encoder_config.json").write_text(json.dumps(
        {"hidden": 64, "compute_dtype": "bfloat16"}))
    with pytest.raises(ValueError, match="orbax"):
        load_encoder_checkpoint(tmp_path)


def test_params_digest_matches_jax():
    tree = jax.tree.map(np.asarray, jm.init_params(
        jm.EncoderConfig.small_test(), "digest"))
    assert _params_digest(tree) == j_digest(tree)
    tree["layers"]["q_w"] = tree["layers"]["q_w"] + np.float32(1e-3)
    assert _params_digest(tree) == j_digest(tree)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Fine-tune the tiny encoder on the (train-query, doc) pairs; the
    untrained step_0 directory, the trained one, the final loss and the
    trained state."""
    root = tmp_path_factory.mktemp("t2s")
    cfg = EncoderConfig.small_test()
    init, step = make_train_step(cfg, "cpu", learning_rate=3e-3)
    state = init(_tree(cfg, "train-to-serve"))
    save_train_state(state, root / "ck_base", config=cfg)
    batches = _batches(cfg)
    for _ in range(60):
        for batch in batches:
            state, loss = step(state, *batch)
    save_train_state(state, root / "ck_tuned", config=cfg)
    return root / "ck_base", root / "ck_tuned", float(loss), state


def test_embedder_serves_the_trained_weights(trained):
    _base, tuned, _loss, state = trained
    enc = get_embedder(EmbeddingConfig(embedding_backend="e5"),
                       checkpoint=str(tuned), device="cpu")
    _p, _c, tag = load_encoder_checkpoint(tuned)
    assert enc.model_name.endswith(f"@{tag}") and tag.startswith(
        "ckpt-step_60-")
    assert enc.has_pretrained_weights
    texts = [_heldout_query(i) for i in range(len(WORDS))]
    rows = [enc.tokenizer.encode(f"query: {t}", enc.max_length)
            for t in texts]
    ids, mask = (torch.from_numpy(a) for a in pad_to_bucket(rows, 32))
    with torch.no_grad():
        want = state.params(ids, mask).numpy()
    np.testing.assert_allclose(enc.model(ids, mask).numpy(), want,
                               atol=1e-6)
    got = enc.encode_queries(texts)
    assert np.min(np.sum(got * want, axis=1)) >= 1 - 1e-6


def test_train_to_serve_improves_heldout_retrieval(trained, tmp_path,
                                                   monkeypatch):
    base, tuned, final_loss, _state = trained
    assert final_loss < 0.5, "training must have overfit the tiny corpus"
    from classmate_rag_tpu_torch.config import load_config
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline.ask import ask_question
    from classmate_rag_tpu_torch.pipeline.ingest import ingest_file
    from classmate_rag_tpu_torch.pipeline.runtime import (
        get_runtime,
        reset_runtime,
    )

    for i in range(len(WORDS)):
        (tmp_path / f"course{i}.txt").write_text(_doc_text(i))

    def accuracy(ckpt, name):
        for var, sub in (("INDEX_DIR", ""), ("DENSE_DIR", "/dense"),
                         ("BM25_DIR", "/bm25"), ("EMB_CACHE_DIR", "/emb")):
            monkeypatch.setenv(var, str(tmp_path / name) + sub)
        monkeypatch.setenv("EMBEDDING_BACKEND", "e5")
        monkeypatch.setenv("LLM_BACKEND", "extractive")
        monkeypatch.setenv("ENCODER_CHECKPOINT", str(ckpt))
        reset_runtime()
        rt = get_runtime(reload=True, device="cpu")
        assert "@ckpt-" in rt.embedder.model_name
        for i in range(len(WORDS)):
            ingest_file(path=tmp_path / f"course{i}.txt",
                        doc_meta=normalize_cli_metadata(course=f"c{i}"),
                        runtime=rt)
        hits = 0
        for i in range(len(WORDS)):
            res = rt.retriever.retrieve(question=_heldout_query(i),
                                        top_k=1, hybrid=False)
            hits += bool(res) and res[0]["metadata"].get("course") == f"c{i}"
        return hits / len(WORDS), rt

    try:
        before, _rt = accuracy(base, "base")
        after, rt = accuracy(tuned, "tuned")
        assert after > before, f"held-out accuracy {before} -> {after}"
        assert after >= 0.75, f"trained accuracy too low: {after}"
        res = ask_question(question=_heldout_query(0),
                           filters=normalize_cli_metadata(), runtime=rt,
                           top_k=2)
        assert res.retrieved
    finally:
        reset_runtime()
        monkeypatch.undo()
        load_config(reload=True)


def test_checkpoint_config_roundtrip(tmp_path):
    cfg = dataclasses.replace(EncoderConfig.small_test(),
                              compute_dtype=torch.float32, flash_min_seq=128)
    init, _ = make_train_step(cfg, "cpu")
    save_train_state(init(_tree(cfg)), tmp_path, config=cfg)
    saved = json.loads((tmp_path / "encoder_config.json").read_text())
    assert saved["compute_dtype"] == "float32"   # the JAX package's name
    assert load_encoder_checkpoint(tmp_path / "step_0")[1] == cfg
