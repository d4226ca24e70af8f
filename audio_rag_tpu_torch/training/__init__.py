"""Whisper fine-tuning on one card (counterpart of ``audio_rag_tpu.training``)."""

from audio_rag_tpu_torch.training.train import (
    Optimizer,
    OptState,
    TrainConfig,
    init_train_state,
    loss_fn,
    make_optimizer,
    make_train_step,
    warmup_cosine_decay,
)

__all__ = ["TrainConfig", "loss_fn", "warmup_cosine_decay", "Optimizer",
           "OptState", "make_optimizer", "init_train_state",
           "make_train_step"]
