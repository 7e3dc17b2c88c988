"""Run utilities."""
from dgcnn_tpu_torch.utils.io import IOStream

__all__ = ["IOStream"]
