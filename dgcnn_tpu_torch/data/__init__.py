"""Datasets (h5 readers or arrays in memory), augmentation, the batch
loader and synthetic in-memory data."""
from dgcnn_tpu_torch.data.datasets import (
    S3DIS,
    ModelNet40,
    ShapeNetPart,
    ShapeNetPartAugmented,
    data_root,
    load_data_cls,
    load_data_partseg,
    load_data_semseg,
    split_semseg,
)
from dgcnn_tpu_torch.data.pipeline import PipelineLoader, make_loader

__all__ = ["S3DIS", "ModelNet40", "PipelineLoader", "ShapeNetPart",
           "ShapeNetPartAugmented", "data_root", "load_data_cls",
           "load_data_partseg", "load_data_semseg", "make_loader",
           "split_semseg"]
