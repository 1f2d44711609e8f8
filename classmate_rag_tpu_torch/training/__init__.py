"""Encoder fine-tuning (port of ``classmate_rag_tpu.training``): the
InfoNCE train step, pair mining and checkpoints."""

from classmate_rag_tpu_torch.training.contrastive import (
    TrainState,
    make_eval_step,
    make_train_step,
)

__all__ = ["TrainState", "make_eval_step", "make_train_step"]
