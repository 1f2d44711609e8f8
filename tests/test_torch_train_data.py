"""The port's training-pair mining (classmate_rag_tpu_torch/training/
data.py) against the JAX package's on one catalog, and the port's
``train_encoder`` entry point on the CPU. Pairs and batches must be
equal: mining is deterministic host code."""

import json

import numpy as np
import pytest

from classmate_rag_tpu.embeddings.tokenizer import HashTokenizer as JTok
from classmate_rag_tpu.index.catalog import Catalog as JCatalog
from classmate_rag_tpu.index.catalog import CatalogEntry as JEntry
from classmate_rag_tpu.index.lexical import tokenize
from classmate_rag_tpu.training.data import encode_pairs as j_encode
from classmate_rag_tpu.training.data import mine_pairs as j_mine
from classmate_rag_tpu_torch.embeddings.tokenizer import HashTokenizer as TTok
from classmate_rag_tpu_torch.index.catalog import Catalog as TCatalog
from classmate_rag_tpu_torch.index.catalog import CatalogEntry as TEntry
from classmate_rag_tpu_torch.training.data import encode_pairs, mine_pairs

TEXTS = [
    "The derivative measures instantaneous change. It is the limit of "
    "the difference quotient as the step shrinks to zero.",
    "Eigenvalues characterize how linear transformations stretch "
    "eigenvector directions. They solve the characteristic polynomial.",
    "Boil the pasta for nine minutes in salted water. Drain it and add "
    "the tomato sauce with fresh basil leaves.",
    "Gradient descent iteratively updates the parameters. The learning "
    "rate controls how large each update step becomes.",
    "short text",                       # below min_chunk_chars
    "One long sentence without any full stop that talks about tensors "
    "gradients optimizers and epochs in a single breath for the test",
]


def _catalogs(tmp_path, n_copies=4):
    j = JCatalog.load_or_create(tmp_path / "j")
    t = TCatalog.load_or_create(tmp_path / "t")
    for i, text in enumerate(TEXTS * n_copies):
        toks = tokenize(text, "en")
        j.upsert(JEntry(f"id{i}", text, toks, {}))
        t.upsert(TEntry(f"id{i}", text, list(toks), {}))
    return j, t


@pytest.mark.parametrize("max_pairs", [10_000, 7])
def test_mine_pairs_matches_jax(tmp_path, max_pairs):
    j, t = _catalogs(tmp_path)
    want = j_mine(j, max_pairs=max_pairs)
    got = mine_pairs(t, max_pairs=max_pairs)
    assert got == want and got
    # Both strategies ran: lead sentences and keyword queries.
    assert {q.endswith(".") for q, _p in got} == {True, False}


def test_encode_pairs_matches_jax(tmp_path):
    j, _t = _catalogs(tmp_path)
    pairs = j_mine(j)
    want = list(j_encode(pairs, JTok(vocab_size=1024), batch_size=8,
                         seq_len=32))
    got = list(encode_pairs(pairs, TTok(vocab_size=1024), batch_size=8,
                            seq_len=32))
    assert len(got) == len(want) == len(pairs) // 8
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == np.int32 and a.shape == (8, 32)
            np.testing.assert_array_equal(a, b)


def test_train_encoder_entry_point(tmp_path, capsys):
    """``python -m classmate_rag_tpu_torch.training.train_encoder`` on a
    small catalog, on the CPU: the JSON lines, a held-out split, a
    checkpoint written and a resume that picks it up."""
    from classmate_rag_tpu_torch.training import train_encoder

    cat = TCatalog.load_or_create(tmp_path / "idx" / "bm25")
    for i, text in enumerate(TEXTS * 8):
        cat.upsert(TEntry(f"id{i}", text, tokenize(text, "en"), {}))
    cat.save()
    ckpt = tmp_path / "ckpt"
    argv = ["--config", "small_test", "--steps", "4", "--batch", "4",
            "--seq-len", "32", "--warmup-steps", "1", "--eval-every", "2",
            "--eval-batches", "1", "--indexes", str(tmp_path / "idx"),
            "--checkpoint-dir", str(ckpt), "--checkpoint-every", "2",
            "--lr", "1e-3"]
    assert train_encoder.main(argv, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["step"] == 0 and "eval_acc" in lines[0]
    assert [x["step"] for x in lines[1:-1]] == [2, 4]
    done = lines[-1]
    assert done["done"] and done["steps"] == 4
    assert done["pairs"] == 40 - 4      # one batch of 4 held out
    assert done["checkpoint"].endswith("step_4")
    assert np.isfinite(done["train_loss"])
    assert (ckpt / "step_2").is_dir()
    assert (ckpt / "encoder_config.json").exists()

    # Resume: the state restores at step 4 and no step runs again.
    assert train_encoder.main(argv + ["--resume"], device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"resumed_from": str(ckpt), "step": 4}
    assert lines[-1]["steps"] == 4 and lines[-1]["eval_loss"] == done[
        "eval_loss"]


def test_train_encoder_needs_pairs(tmp_path, capsys):
    from classmate_rag_tpu_torch.training import train_encoder

    TCatalog.load_or_create(tmp_path / "idx" / "bm25")
    assert train_encoder.main(["--config", "small_test", "--indexes",
                               str(tmp_path / "idx")], device="cpu") == 1
    out = json.loads(capsys.readouterr().out)
    assert out["error"] == "not enough training pairs"
