"""The banded kernels 12 and 13 on clouds above ``knn.MAX_N``, the most
points a whole-cloud kNN kernel takes.

The JAX package runs its banded Pallas kernels at any N that is a multiple
of 128 (``use_pallas`` has no upper bound; ``pallas_banded`` blocks the
band, so their VMEM does not grow with the cloud).  The port's models took
the shape gate (``use_kernel``) before the band, so a ``--fast_extract``
eval of more than 32768 points ran the exact XLA path.  Here the gate is
held down to 256 points (``knn.MAX_N`` and ``banded``'s copy patched), so
that a DGCNNSemSeg eval of 384 points with a band of 128 stands in for
one of 65536 with a band of 1024:

- it takes the banded kernels' plain versions (``banded_knn_edge2`` twice,
  ``banded_edge_conv_eval`` once; no ``knn`` call), exact and AMP, and the
  AMP mode is the default's (``use_amp_eval`` with the band);
- its logits match the JAX package's banded forward at that N (Pallas in
  interpret mode, ``DGCNN_TPU_FAST_EXTRACT`` set; one jitted forward a
  mode, shared by the tests): exact within rel 1e-4 of the logits' scale,
  AMP by ``tests/test_torch_amp_seg.py``'s hold (the same argmax on >=
  99.5% of the points, max|diff| within a tenth of the JAX package's own
  banded AMP-vs-exact max|diff|), on a block rounded to a 1/64 grid so
  that the first stage's scores are exact in both frameworks;
- training ignores the band, as in the JAX package.

The ``cuda``-marked tests (they skip without a card) hold each banded
CUDA form at N = 65536 and 131072 (B = 1, band 1024) bit-equal to its
plain version on one PC1 order, on integer duplicate points: v3 class
words whose lowest members lie past 65535 points.
"""
import importlib

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.models import DGCNNSemSeg
from dgcnn_tpu_torch.ops.amp_select import EXACT_ENV, EXTRACT_ENV, use_amp_eval

# the modules (the packages' __init__ export functions of the same names)
dgcnn = importlib.import_module("dgcnn_tpu_torch.models.dgcnn")
nn_layers = importlib.import_module("dgcnn_tpu_torch.models.nn_layers")
banded = importlib.import_module("dgcnn_tpu_torch.ops.banded")
knn = importlib.import_module("dgcnn_tpu_torch.ops.knn")

try:  # the reference; a host with the card may lack it: the cuda tests
    import jax
    import jax.numpy as jnp

    from dgcnn_tpu_torch.convert import state_dict_from_flax
    from test_torch_port_semseg import flax_semseg_variables
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

N, BAND, K, EMB = 384, 128, 4, 32
GATE = 256  # the shape gate held down: N > GATE stands in for N > 32768


@pytest.fixture
def small_gate(monkeypatch):
    """``knn.MAX_N`` and ``banded``'s copy at 256; ``knn`` refused."""
    monkeypatch.setattr(knn, "MAX_N", GATE)
    monkeypatch.setattr(banded, "MAX_N", GATE)

    def no_knn(*args, **kwargs):
        raise AssertionError("the XLA path's knn ran")

    monkeypatch.setattr(dgcnn, "knn", no_knn)
    monkeypatch.setattr(nn_layers, "knn", no_knn)
    calls = {"edge2": 0, "conv": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(dgcnn, "banded_knn_edge2",
                        counting("edge2", dgcnn.banded_knn_edge2))
    monkeypatch.setattr(nn_layers, "banded_edge_conv_eval",
                        counting("conv", nn_layers.banded_edge_conv_eval))
    return calls


def _block(seed: int = 7) -> np.ndarray:
    x = np.random.default_rng(seed).random((1, N, 9)).astype(np.float32)
    return np.round(x * 64) / 64


@pytest.fixture(scope="module")
def jax_banded():
    """The flax DGCNNSemSeg, the port's model on its weights, a block and
    the JAX package's banded logits at N = 384, band 128: exact (the
    exact pin) and AMP (its default), one jitted forward each."""
    fmodel, variables = flax_semseg_variables(emb_dims=EMB, k=K, n=128,
                                              randomize=False)
    model = DGCNNSemSeg(emb_dims=EMB, k=K, band=BAND, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    x = _block()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DGCNN_TPU_PALLAS", "1")
        mp.setenv("DGCNN_TPU_FAST_EXTRACT", str(BAND))
        mp.delenv(EXTRACT_ENV, raising=False)
        for mode in ("exact", "amp"):
            if mode == "exact":
                mp.setenv(EXACT_ENV, "1")
            else:
                mp.delenv(EXACT_ENV, raising=False)
            jax.clear_caches()
            fwd = jax.jit(lambda v, xb: fmodel.apply(v, xb, train=False))
            with jax.default_matmul_precision("float32"):
                out[mode] = np.asarray(fwd(variables, jnp.asarray(x)),
                                       dtype=np.float32)
    jax.clear_caches()
    return model, x, out


def test_amp_mode_takes_the_band_above_the_gate(small_gate):
    """Above the gate the AMP default holds where a band prunes the cloud
    (the banded kernels take any N) and not without one; training takes
    no band."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not knn.use_kernel(N)
    assert banded.banded_applicable(N, BAND)
    assert use_amp_eval(None, cuda, N, K, band=BAND)
    assert not use_amp_eval(None, cuda, N, K)
    assert not use_amp_eval(True, cpu, N, K, band=N)  # prunes nothing
    assert use_amp_eval(True, cpu, N, K, band=BAND)
    assert not use_amp_eval(None, cpu, N, K, band=BAND)


@needs_jax
@pytest.mark.parametrize("mode", ["exact", "amp"])
def test_semseg_banded_eval_above_the_gate_matches_jax(mode, jax_banded,
                                                       small_gate,
                                                       monkeypatch):
    """The DGCNNSemSeg eval at N = 384 > the gate with band 128 takes the
    banded kernels (two kernel 13 calls and one kernel 12, no knn) and
    matches the JAX package's banded forward in each mode."""
    model, x, out = jax_banded
    monkeypatch.delenv(EXTRACT_ENV, raising=False)
    monkeypatch.delenv(EXACT_ENV, raising=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), amp=mode == "amp").numpy()
    assert small_gate == {"edge2": 2, "conv": 1}
    want = out[mode]
    assert got.shape == want.shape and np.isfinite(got).all()
    if mode == "exact":
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-4 * scale
        return
    gap = np.abs(out["amp"] - out["exact"]).max()
    assert gap > 0
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.995
    assert np.abs(got - want).max() <= gap / 10


def test_semseg_training_above_the_gate_ignores_the_band(small_gate,
                                                         monkeypatch):
    """A training forward above the gate takes the XLA path whatever the
    band, as the JAX package's training does: its knn, no banded call."""
    calls = []
    monkeypatch.setattr(dgcnn, "knn",
                        lambda g, k: calls.append(g.shape[1])
                        or knn.knn_plain(g, k))
    monkeypatch.setattr(nn_layers, "knn",
                        lambda g, k: calls.append(g.shape[1])
                        or knn.knn_plain(g, k))
    model = DGCNNSemSeg(emb_dims=EMB, k=K, band=BAND, device="cpu")
    x = torch.from_numpy(_block())
    out = model(x, train=True, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, N, 13) and torch.isfinite(out).all()
    assert calls == [N, N, N]
    assert small_gate == {"edge2": 0, "conv": 0}


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


BANDED_FORMS = ["banded_edge_conv_eval v3", "banded_edge_conv_eval v2",
                "banded_edge_conv_eval exact", "banded_knn_edge2 v3",
                "banded_knn_edge2 v2", "banded_knn_edge2 exact"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 131072])
@pytest.mark.parametrize("form", BANDED_FORMS)
def test_banded_form_above_32768_matches_plain_on_cuda(form, n, cuda_device,
                                                       monkeypatch):
    """Each banded form (AMP v3 and v2, exact v1) at N = 65536 and 131072
    (B = 1, band 1024, k = 20) on integer points, each four times (v3
    classes whose lowest members lie past 65535), against its plain
    version on one PC1 order: bit-equal."""
    from test_torch_large_n import _env, _form_call

    _env(form, monkeypatch)
    got = _form_call(form, cuda_device, n, 20).cpu()
    want = _form_call(form, torch.device("cpu"), n, 20)
    assert torch.equal(got, want), form
