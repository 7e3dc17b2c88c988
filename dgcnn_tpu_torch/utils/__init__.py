"""Run utilities."""
from dgcnn_tpu_torch.utils.io import IOStream
from dgcnn_tpu_torch.utils.profiling import ThroughputMeter

__all__ = ["IOStream", "ThroughputMeter"]
