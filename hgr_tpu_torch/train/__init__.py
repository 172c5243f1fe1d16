"""OM fine-tuning: pair weights, LR schedule, negative sampling and pair
schedules, the OM loss, and the train step (port of ``hgr_tpu/train``)."""

from .om import make_om_loss_fn, om_loss, resolve_weight_modes
from .sampling import NegativeSampler, PairSchedule, ScheduleBuilder, max_pairs
from .schedule import cosine_lr
from .trainer import (
    TrainState,
    freeze_params,
    init_train_state,
    make_optimizer,
    make_train_step,
    sched_to_device,
)
from .weights import pair_weights

__all__ = [
    "make_om_loss_fn",
    "om_loss",
    "resolve_weight_modes",
    "NegativeSampler",
    "PairSchedule",
    "ScheduleBuilder",
    "max_pairs",
    "cosine_lr",
    "TrainState",
    "freeze_params",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
    "sched_to_device",
    "pair_weights",
]
