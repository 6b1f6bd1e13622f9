"""Fine-tuning for the SR model zoo (port of ``upscale_video_tpu/train``)."""

from upscale_video_tpu_torch.train.trainer import (
    TrainState,
    make_train_state,
    make_train_step,
    make_sharded_train_step,
    synthesize_pairs,
)

__all__ = [
    "TrainState",
    "make_train_state",
    "make_train_step",
    "make_sharded_train_step",
    "synthesize_pairs",
]
