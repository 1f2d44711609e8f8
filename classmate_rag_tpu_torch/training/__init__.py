"""Encoder fine-tuning (port of ``classmate_rag_tpu.training``): the
InfoNCE train step on one device or a ("data", "model") mesh, pair
mining and checkpoints."""

from classmate_rag_tpu_torch.training.contrastive import (
    TrainState,
    encoder_param_specs,
    make_eval_step,
    make_train_step,
)

__all__ = ["TrainState", "encoder_param_specs", "make_eval_step",
           "make_train_step"]
