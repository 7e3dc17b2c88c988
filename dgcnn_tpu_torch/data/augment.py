"""Whole-batch point-cloud augmentations, numpy with an explicit Generator
(the port's own copy of the batched forms of dgcnn_tpu/data/augment.py,
the ones the loader's ``batch()`` path draws; same draws in the same
order, so the same seed gives the same batches).  ``apply`` (B,) bool
selects the samples an augmentation changes; the draws are made for
every sample either way."""
from __future__ import annotations

import numpy as np


def translate_batch(pc: np.ndarray, rng: np.random.Generator,
                    apply: np.ndarray | None = None) -> np.ndarray:
    """Per-sample anisotropic scale U(2/3, 3/2) + shift U(-0.2, 0.2) per
    axis."""
    b = pc.shape[0]
    scale = rng.uniform(2.0 / 3.0, 3.0 / 2.0, size=(b, 1, 3)).astype(np.float32)
    shift = rng.uniform(-0.2, 0.2, size=(b, 1, 3)).astype(np.float32)
    if apply is not None:
        sel = apply[:, None, None]
        scale = np.where(sel, scale, np.float32(1.0))
        shift = np.where(sel, shift, np.float32(0.0))
    return pc * scale + shift


def jitter_batch(pc: np.ndarray, rng: np.random.Generator,
                 sigma: float = 0.01, clip: float = 0.02,
                 apply: np.ndarray | None = None) -> np.ndarray:
    """Gaussian noise of ``sigma`` clipped to +-``clip`` on every value."""
    noise = np.clip(
        sigma * rng.standard_normal(pc.shape).astype(np.float32),
        -clip, clip)
    if apply is not None:
        noise *= apply[:, None, None].astype(np.float32)
    return pc + noise


def rotate_batch(pc: np.ndarray, rng: np.random.Generator,
                 apply: np.ndarray | None = None) -> np.ndarray:
    """Per-sample rotation in the x-z plane by a gaussian angle 2 pi N(0,
    1) (the reference's draw)."""
    b = pc.shape[0]
    theta = (np.pi * 2 * rng.standard_normal(b)).astype(np.float32)
    if apply is not None:
        theta = np.where(apply, theta, np.float32(0.0))
    c, s = np.cos(theta), np.sin(theta)
    out = pc.copy()
    x, z = pc[..., 0], pc[..., 2]
    out[..., 0] = x * c[:, None] + z * s[:, None]
    out[..., 2] = -x * s[:, None] + z * c[:, None]
    return out


def shuffle_points_batch(rng: np.random.Generator, b: int,
                         n: int) -> np.ndarray:
    """(B, N) independent point permutations (argsort of random keys)."""
    return np.argsort(rng.random((b, n)), axis=1)
