"""Training engine: step functions, metrics, meters, schedules, checkpoints."""

from ctc_tpu_torch.train.metrics import AverageMeter, topk_accuracy
from ctc_tpu_torch.train.schedule import step_decay_schedule
from ctc_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    make_eval_step,
    make_train_step,
    resolve_device,
)

__all__ = [
    "AverageMeter",
    "topk_accuracy",
    "step_decay_schedule",
    "Trainer",
    "TrainState",
    "make_train_step",
    "make_eval_step",
    "resolve_device",
]
