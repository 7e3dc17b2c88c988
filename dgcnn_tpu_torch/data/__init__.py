"""Datasets (h5 readers) and synthetic in-memory data."""
from dgcnn_tpu_torch.data.datasets import ModelNet40, data_root, load_data_cls

__all__ = ["ModelNet40", "data_root", "load_data_cls"]
