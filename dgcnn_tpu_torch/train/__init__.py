"""Loss, metrics, schedules, optimizers, train/eval steps and
checkpoints."""
from dgcnn_tpu_torch.train.checkpoint import (
    load_model,
    load_train_checkpoint,
    save_model,
    save_train_checkpoint,
)
from dgcnn_tpu_torch.train.engine import (
    ScheduledOptimizer,
    make_cls_steps,
    make_optimizer,
    make_seg_steps,
)
from dgcnn_tpu_torch.train.loss import (
    cross_entropy,
    cross_entropy_per_example,
    masked_mean_loss,
)
from dgcnn_tpu_torch.train.metrics import (
    accuracy_score,
    balanced_accuracy_score,
    calculate_sem_IoU,
)
from dgcnn_tpu_torch.train.schedules import (
    cosine_annealing,
    make_schedule,
    step_decay,
)

__all__ = [
    "ScheduledOptimizer",
    "accuracy_score",
    "balanced_accuracy_score",
    "calculate_sem_IoU",
    "cosine_annealing",
    "cross_entropy",
    "cross_entropy_per_example",
    "load_model",
    "load_train_checkpoint",
    "make_cls_steps",
    "make_optimizer",
    "make_schedule",
    "make_seg_steps",
    "masked_mean_loss",
    "save_model",
    "save_train_checkpoint",
    "step_decay",
]
