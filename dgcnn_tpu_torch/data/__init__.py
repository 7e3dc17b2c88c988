"""Datasets (h5 readers or arrays in memory), augmentation, the batch
loader and synthetic in-memory data."""
from dgcnn_tpu_torch.data.datasets import ModelNet40, data_root, load_data_cls
from dgcnn_tpu_torch.data.pipeline import PipelineLoader, make_loader

__all__ = ["ModelNet40", "PipelineLoader", "data_root", "load_data_cls",
           "make_loader"]
