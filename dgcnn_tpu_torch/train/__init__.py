"""Loss and metrics of the eval loop (training itself is not ported yet)."""
from dgcnn_tpu_torch.train.loss import cross_entropy
from dgcnn_tpu_torch.train.metrics import accuracy_score, balanced_accuracy_score

__all__ = ["accuracy_score", "balanced_accuracy_score", "cross_entropy"]
