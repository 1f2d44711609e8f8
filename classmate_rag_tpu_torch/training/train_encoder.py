"""Fine-tune the E5 encoder on the ingested corpus, end to end (port of
the JAX package's ``tools/train_encoder.py``, with its flags, held-out
split and JSON lines).

Mines deterministic (query, passage) pairs from the live catalog
(``training/data.py``), runs the InfoNCE step (``training/
contrastive.py``) over ``training_mesh()`` of the local CUDA cards (dp×tp;
one card: the single-device step), tracks in-batch retrieval accuracy
on a held-out slice and writes checkpoints (``training/checkpoint.py``).
Run from the directory whose ./indexes you want to train on:

    python -m classmate_rag_tpu_torch.training.train_encoder \\
        --steps 200 --batch 32 --lr 2e-5 --checkpoint-dir ./ckpt

Prints one JSON line per eval and a final JSON summary. The checkpoint
serves through ``ENCODER_CHECKPOINT=./ckpt`` (``get_embedder``).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from classmate_rag_tpu_torch.device import DeviceLike, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Contrastive encoder fine-tune")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--warmup-steps", type=int, default=10)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--max-pairs", type=int, default=10_000)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="Resume from the latest checkpoint in --checkpoint-dir")
    ap.add_argument("--config", choices=["base", "large", "small_test"],
                    default="base")
    ap.add_argument("--model-dir", default=None,
                    help="HF snapshot to start from (default: config init)")
    ap.add_argument("--indexes", default=None,
                    help="Index root (default: the configured BM25_DIR)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = None) -> int:
    """The tool; ``device`` None is CUDA, on every local card (the tests
    pass the CPU)."""
    args = parse_args(argv)

    from classmate_rag_tpu_torch.embeddings.model import (
        EncoderConfig,
        init_params,
        load_params_from_hf,
    )
    from classmate_rag_tpu_torch.embeddings.tokenizer import load_tokenizer
    from classmate_rag_tpu_torch.index.catalog import Catalog
    from classmate_rag_tpu_torch.parallel.mesh import (
        local_devices,
        training_mesh,
    )
    from classmate_rag_tpu_torch.training import (
        make_eval_step,
        make_train_step,
    )
    from classmate_rag_tpu_torch.training.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from classmate_rag_tpu_torch.training.data import (
        encode_pairs,
        mine_pairs,
    )

    mesh = training_mesh(devices=local_devices(resolve_device(device)))
    config = getattr(EncoderConfig, args.config)()
    if args.indexes:
        bm25_dir = Path(args.indexes) / "bm25"
    else:
        from classmate_rag_tpu_torch.config import load_config

        bm25_dir = load_config().bm25_dir
    catalog = Catalog.load_or_create(bm25_dir)
    pairs = mine_pairs(catalog, max_pairs=args.max_pairs)
    if len(pairs) < 2 * args.batch:
        print(json.dumps({
            "error": "not enough training pairs",
            "pairs": len(pairs), "needed": 2 * args.batch,
        }))
        return 1

    # Held-out eval slice: the LAST eval_batches*batch pairs (mining is
    # deterministic, so the split is stable across runs). When the corpus
    # is too small to hold anything out, report NaN eval metrics rather
    # than evaluate on the training set.
    n_eval = min(args.eval_batches * args.batch, len(pairs) // 4)
    if n_eval > 0:
        train_pairs, eval_pairs = pairs[:-n_eval], pairs[-n_eval:]
    else:
        train_pairs, eval_pairs = pairs, []

    tokenizer = load_tokenizer(
        args.model_dir, max_length=args.seq_len, vocab_size=config.vocab_size
    )
    params = None
    if args.model_dir:
        params = load_params_from_hf(args.model_dir, config)
    if params is None:
        params = init_params(config, f"train-{args.config}")

    init_state, train_step = make_train_step(
        config, mesh, learning_rate=args.lr,
        warmup_steps=args.warmup_steps, total_steps=args.steps,
        accum_steps=args.accum_steps,
    )
    eval_step = make_eval_step(config, mesh)
    state = init_state(params)

    ckpt_dir = Path(args.checkpoint_dir) if args.checkpoint_dir else None
    if args.resume and ckpt_dir:
        restored = restore_train_state(ckpt_dir, state)
        if restored is not None:
            state = restored
            print(json.dumps({"resumed_from": str(ckpt_dir),
                              "step": int(state.step)}))
    start_step = int(state.step)

    eval_batches = list(encode_pairs(
        eval_pairs, tokenizer, batch_size=args.batch, seq_len=args.seq_len,
    ))

    def run_eval(model):
        losses, accs = [], []
        for q_ids, q_mask, p_ids, p_mask in eval_batches:
            loss, acc = eval_step(model, q_ids, q_mask, p_ids, p_mask)
            losses.append(float(loss))
            accs.append(float(acc))
        return (float(np.mean(losses)) if losses else float("nan"),
                float(np.mean(accs)) if accs else float("nan"))

    loss0, acc0 = run_eval(state.params)
    print(json.dumps({"step": int(state.step), "eval_loss": round(loss0, 4),
                      "eval_acc": round(acc0, 4)}))

    t0 = time.perf_counter()
    step = int(state.step)
    last_loss = float("nan")
    while step < args.steps:
        for batch in encode_pairs(
            train_pairs, tokenizer, batch_size=args.batch,
            seq_len=args.seq_len,
        ):
            if step >= args.steps:
                break
            state, loss = train_step(state, *batch)
            step = int(state.step)
            last_loss = float(loss)
            if args.eval_every and step % args.eval_every == 0:
                ev_loss, ev_acc = run_eval(state.params)
                print(json.dumps({
                    "step": step, "train_loss": round(last_loss, 4),
                    "eval_loss": round(ev_loss, 4),
                    "eval_acc": round(ev_acc, 4),
                }))
            if ckpt_dir and args.checkpoint_every and \
                    step % args.checkpoint_every == 0:
                save_train_state(state, ckpt_dir, config=config)

    final_path = (save_train_state(state, ckpt_dir, config=config)
                  if ckpt_dir else None)
    ev_loss, ev_acc = run_eval(state.params)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "done": True, "steps": step, "pairs": len(train_pairs),
        "train_loss": round(last_loss, 4),
        "eval_loss": round(ev_loss, 4), "eval_acc": round(ev_acc, 4),
        "eval_loss_start": round(loss0, 4), "eval_acc_start": round(acc0, 4),
        # Steps run this session over this session's wall time.
        "steps_per_s": round((step - start_step) / max(dt, 1e-9), 2),
        "mesh": mesh.shape,
        "device": str(mesh[0][0]),
        "checkpoint": str(final_path) if final_path else None,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
