"""One AMP (bf16) training step of the port's canonical DGCNNPartSeg
against the JAX package's AMP step, on the CPU at a small size, held as
tests/test_torch_amp_train_models.py holds DGCNNCls's and DGCNNSemSeg's
(its module docstring states the tolerances).  A file of its own: each
step runs the JAX kernels in Pallas interpret mode for ~30 s.
"""
import jax
import jax.numpy as jnp
import numpy as np

from dgcnn_tpu_torch.models import DGCNNPartSeg

from test_torch_amp_train_models import K, N, _held_step, amp_env  # noqa: F401


def test_dgcnn_partseg_amp_step_matches_jax(amp_env):
    """Canonical DGCNNPartSeg: kernels 3, 5, 7 and 8 in AMP; the
    TransformNet's graph (kernel 11) exact in both packages."""
    from dgcnn_tpu.models import DGCNNPartSeg as FlaxDGCNNPartSeg

    fmodel = FlaxDGCNNPartSeg(emb_dims=32, k=K, dropout=0.0)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((2, N, 3), jnp.float32),
                            jnp.zeros((2, 16), jnp.float32), train=False)
    rng = np.random.default_rng(72)
    points = rng.standard_normal((8, N, 3)).astype(np.float32)
    one_hot = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 8)]
    seg = rng.integers(0, 50, (8, N)).astype(np.int64)
    model = DGCNNPartSeg(emb_dims=32, k=K, dropout=0.0, device="cpu")
    _held_step(model, variables, fmodel, (points, one_hot), seg, amp_env,
               3)
