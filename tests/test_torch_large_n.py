"""The port's kNN kernels on clouds above 4096 points, where the register
buckets of the row-warp selection end and the shared row of
``csrc/knn_select.cuh`` (a row's scores in shared memory) and the tiled
selection take them, up to ``knn.MAX_N`` = 32768 points.

On the CPU, against the JAX package, which runs its Pallas kernels, AMP by
default, on every cloud whose N is a multiple of 128 (``use_pallas``):

- the packed keys of the v2 selection bit-equal to ``_pack_keys`` at N =
  4224 (the first multiple of 128 above 4096), 8192, 16384 and 32768,
  where the index field widens to 13, 14 and 15 bits, and the v2 lists
  their order;
- a DGCNNSemSeg AMP eval (kernels 6 twice, 1 and 2) at N = 4224 on flax
  weights carried across by ``convert.state_dict_from_flax``, unpinned and
  under the semseg CLI's v2 pin, and a kernel 3 AMP stage, against the
  Pallas kernels in interpret mode (``DGCNN_TPU_PALLAS=1``, the exact pin
  unset, float32 matmul precision).  The tolerances are
  ``tests/test_torch_amp_eval.py``'s: the same argmax, and the logits'
  max|diff| within a tenth of the JAX package's own AMP-vs-exact max|diff|
  (its exact forward: the XLA path it runs on the CPU); kernel 3's lists
  equal on >= 99% of rows, the others differing only at near ties of
  their AMP scores, max and min bit-equal and the sums within rel 1e-5 on
  those rows (integer points: every row);
- the mode switches: AMP at N = 8192.

The port's side is the plain versions, which CPU tensors take.  The JAX
caches are cleared before each test, since the Pallas kernels read the
variant when they trace.  The ``cuda``-marked tests hold each CUDA form at N
= 8192 against its plain version, the shared row bit-equal to the register
buckets and the tiled route at N <= 4096, and the stages of Co = 256 at N
= 4096 (DGCNNCls's and the fusion Net's stage 4); they skip without a
card.
"""
import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.convert import state_dict_from_flax
from dgcnn_tpu_torch.models import DGCNNSemSeg
from dgcnn_tpu_torch.ops.amp_select import (
    EXACT_ENV,
    EXTRACT_ENV,
    amp_scores,
    index_bits,
    pack_keys,
    use_amp_eval,
    use_amp_train,
    v2_indices,
)
from dgcnn_tpu_torch.ops.knn import (
    MAX_N,
    force_shared_rows,
    srow_count,
    use_kernel,
)
from dgcnn_tpu_torch.ops.edge2_kernel import knn_edge2
from dgcnn_tpu_torch.ops.knn_reduce_kernel import knn_reduce

try:  # the reference; a host with the card may lack it: the cuda tests
    import jax
    import jax.numpy as jnp

    from test_torch_amp_seg import (
        _edge2_args,
        _graph,
        _held_logits,
        _knn_edge2_jax,
        _np,
    )
    from test_torch_amp_train import _cloud, _feats, _same_rows
    from test_torch_port_semseg import flax_semseg_variables
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

F32 = "float32"
N = 4224  # the first multiple of 128 above the register buckets' 4096
SEG_K, SEG_EMB = 4, 32


@pytest.fixture(scope="module", autouse=True)
def amp_default():
    """The JAX package's AMP default for the whole module, its jit caches
    cleared when the module starts and ends."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DGCNN_TPU_PALLAS", "1")
        mp.delenv(EXACT_ENV, raising=False)
        mp.delenv(EXTRACT_ENV, raising=False)
        if jax is not None:
            jax.clear_caches()
        yield
        if jax is not None:
            jax.clear_caches()


@pytest.fixture(autouse=True)
def fresh_traces():
    """Each test traces the Pallas kernels anew: they read the variant
    (``DGCNN_TPU_EXTRACT``) when they trace, so a trace of one pin must
    not serve a test of another."""
    if jax is not None:
        jax.clear_caches()


# ------------------------------------------------------------ the keys
@needs_jax
@pytest.mark.parametrize("n", [4224, 8192, 16384, 32768])
def test_packed_keys_bit_equal_at_large_n(n):
    """The packed keys of 64 rows of AMP scores against an n-point cloud:
    bit-equal to ``_pack_keys`` (13 index bits up to 8192, 14 at 16384,
    15 at 32768),
    unique within a row, and ``v2_indices`` lists the largest first, in
    the JAX keys' order."""
    from dgcnn_tpu.ops.pallas_knn import _pack_keys, _scores

    x = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    with jax.default_matmul_precision(F32):
        scores = np.array(_scores(jnp.asarray(x[:64]), jnp.asarray(x),
                                  exact=False))
    want = np.asarray(_pack_keys(jnp.asarray(scores), n))
    got = pack_keys(torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(got, want)
    assert index_bits(n) == (15 if n > 16384 else 14 if n > 8192 else 13)
    assert all(len(np.unique(r)) == n for r in got)
    order = np.argsort(-want.astype(np.int64), axis=-1)[:, :20]
    np.testing.assert_array_equal(
        v2_indices(torch.from_numpy(scores)[None], 20)[0].numpy(), order)


# ------------------------------------------------------------ the modes
def test_modes_and_routes_at_large_n(monkeypatch):
    """``use_kernel`` takes N up to 32768, so the AMP default (and the
    AMP training step) runs at 8192 to 32768 points on the card, exact on
    the CPU and under the exact pin."""
    monkeypatch.delenv(EXACT_ENV, raising=False)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert MAX_N == 32768 and use_kernel(32768) and not use_kernel(32896)
    for mode in (use_amp_eval, use_amp_train):
        for n in (4224, 8192, 16384, 16512, 32768):
            assert mode(None, cuda, n, 20) and mode(True, cpu, n, 20)
            assert not mode(None, cpu, n, 20)
        monkeypatch.setenv(EXACT_ENV, "1")
        assert not mode(None, cuda, 8192, 20)
        monkeypatch.delenv(EXACT_ENV)


# ------------------------------------------------------------ the models
@pytest.fixture(scope="module")
def semseg_at_4224():
    """The flax DGCNNSemSeg, its weights, the port's model on them, and
    for each block of N points (uniform in the unit cube, and the same
    rounded to a 1/64 grid) the block and the JAX package's exact logits
    (its XLA path on the CPU)."""
    fmodel, variables = flax_semseg_variables(emb_dims=SEG_EMB, k=SEG_K,
                                              n=128, randomize=False)
    model = DGCNNSemSeg(emb_dims=SEG_EMB, k=SEG_K, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    x = np.random.default_rng(42).random((1, N, 9)).astype(np.float32)
    blocks = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("DGCNN_TPU_PALLAS")
        for name, xb in (("uniform", x), ("grid", np.round(x * 64) / 64)):
            with jax.default_matmul_precision(F32):
                blocks[name] = (xb, np.asarray(fmodel.apply(
                    variables, jnp.asarray(xb), train=False)))
    return fmodel, variables, model, blocks


@needs_jax
@pytest.mark.parametrize("block", ["grid", "uniform"])
@pytest.mark.parametrize("pin", [None, "v2"])
def test_dgcnn_semseg_amp_at_4224_matches_jax_amp(pin, block,
                                                   semseg_at_4224,
                                                   monkeypatch):
    """The AMP eval of a block of 4224 points (which the port ran exact
    before its kernels took N > 4096) against the JAX package's AMP
    forward, unpinned (kernels 6 and 1 in v3) and under the semseg CLI's
    v2 pin.  On the block rounded to a 1/64 grid the first stage's bf16x3
    scores are exact in both frameworks, so no near tie at the k-th
    neighbour flips a neighbourhood: the same argmax, and max|diff| within
    a tenth of the JAX package's AMP-vs-exact gap.  On the uniform block
    the two frameworks' sums of the score products in other orders flip
    such near ties, the more often the more points a block holds (the
    stage tests below hold the rows equal but at proven near ties), and
    so does the v2 keys' grid under the pin: there the argmax is held, as
    ``tests/test_torch_amp_seg.py`` holds DGCNNPartSeg on raw normal
    clouds, and >= 99% of the points within the tenth."""
    fmodel, variables, model, blocks = semseg_at_4224
    x, exact = blocks[block]
    if pin:
        monkeypatch.setenv(EXTRACT_ENV, pin)
    with jax.default_matmul_precision(F32):
        amp_j = np.asarray(fmodel.apply(variables, jnp.asarray(x),
                                        train=False))
    with torch.no_grad():
        amp_t = model(torch.from_numpy(x), amp=True)
    assert amp_t.dtype == torch.float32 and amp_t.shape == amp_j.shape
    amp_t = amp_t.numpy()
    gap = np.abs(amp_j - exact).max()
    if block == "grid" and not pin:
        _held_logits(amp_t, amp_j, gap)
        return
    # elsewhere the argmax, and >= 99% of the points within the tenth
    assert (amp_t.argmax(-1) == amp_j.argmax(-1)).mean() >= 0.995
    assert (np.abs(amp_t - amp_j).max(-1) <= gap / 10).mean() >= 0.99


def _near_ties(graph: torch.Tensor, k: int, rows) -> None:
    """Each (b, i) of ``rows``: its k + 1 best AMP scores over ``graph``
    hold two within 1e-5 of the row's score scale, a near tie that the two
    frameworks' score sums in other orders (or the v2 keys' grid) may
    break apart."""
    s = amp_scores(graph, graph)
    for b, i in rows:
        top = s[b, i].topk(k + 1).values
        gap = (top[:-1] - top[1:]).min().item()
        assert gap <= 1e-5 * s[b, i].abs().max().item(), (b, i, gap)


@needs_jax
@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_knn_edge2_amp_stage_at_4224(variant, monkeypatch):
    """Kernel 6's AMP form on the second block's bf16 graph (64 channels)
    at N = 4224, v3 and under the v2 pin, against ``fused_knn_edge2``:
    rows within one bf16 ulp on >= 99.9%, or on >= 99% with every other
    row a near tie of its AMP scores."""
    if variant == "v2":
        monkeypatch.setenv(EXTRACT_ENV, "v2")
    g = _graph("bf16-64", N, 81)[:1]
    args = [a[:1] if a.ndim == 3 else a for a in _edge2_args(N, 64, 64, 82)]
    want = _knn_edge2_jax(g, args, SEG_K, 0.2, True)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    got = knn_edge2(gt, *map(torch.from_numpy, args), SEG_K, amp=True)
    assert got.dtype == torch.bfloat16 and got.shape == (1, N, 64)
    w = torch.from_numpy(_np(want)).to(torch.bfloat16)
    near = (got.view(torch.int16).int()
            - w.view(torch.int16).int()).abs().amax(-1) <= 1
    frac = near.float().mean().item()
    if frac < 0.999:
        assert frac >= 0.99, frac
        _near_ties(gt, SEG_K, (~near).nonzero().tolist())


@needs_jax
@pytest.mark.parametrize("kind", ["random", "ints"])
def test_knn_reduce_amp_stage_at_4224(kind):
    """Kernel 3's AMP form (bf16x3 scores, v2 keys of 13 index bits, bf16
    rows, f32 sums) at N = 4224 against ``fused_knn_reduce(select_dtype=
    bf16)``."""
    from dgcnn_tpu.ops.pallas_knn import fused_knn_reduce

    ints = kind == "ints"
    g = _cloud(kind, 70 + ints, 3, b=1, n=N)
    a = _feats(kind, 72, (1, N, 16))
    with jax.default_matmul_precision(F32):
        want = fused_knn_reduce(jnp.asarray(g), jnp.asarray(a), 8,
                                select_dtype=jnp.bfloat16, interpret=True,
                                with_sumsq=True)
    gt = torch.from_numpy(g)
    got = knn_reduce(gt, torch.from_numpy(a), 8, amp=True)
    same = _same_rows(gt, got[0], want[0])
    assert same.mean() >= (1.0 if ints else 0.99), same.mean()
    for i, (gr, wr) in enumerate(zip(got[1:], want[1:])):
        gr, wr = gr.numpy(), np.asarray(wr)
        if i < 2:
            np.testing.assert_array_equal(gr[same], wr[same])
        else:
            rel = (np.linalg.norm(gr - wr, axis=-1)
                   / np.linalg.norm(wr, axis=-1).clip(1e-30))
            assert rel[same].max() <= 1e-5


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# each kNN form (the exact v1 of kernels 1 and 6 through the banded entry
# at band = N, the identity order, whose row route is theirs), and the
# idx-driven kernels 5, 7, 8, 2 and 9
KNN_FORMS = ["edge_conv_eval v3", "edge_conv_eval v2",
             "edge_conv_eval select-x", "edge_conv_eval exact v2",
             "edge_conv_eval exact", "knn_edge2 v3", "knn_edge2 v2",
             "knn_edge2 exact v2", "knn_edge2 exact",
             "banded_edge_conv_eval v2", "banded_knn_edge2 v2",
             "knn_reduce", "knn_reduce exact", "knn_reduce exact v2",
             "knn_reduce_xw", "knn_reduce_xw exact", "knn_sum",
             "knn_sum exact", "knn", "knn exact v2"]
IDX_FORMS = ["edge_reduce_bwd", "edge2_fwd", "edge2_bwd", "conv_pool",
             "edge_sum"]


def _edge2_ints(n: int, seed: int, b: int):
    """Integer a1/b1 (B, n, 64), power-of-two scales, integer shifts and a
    w2 with one power of two a column (test_torch_amp_seg's, C1 = C2 =
    64)."""
    rng = np.random.default_rng(seed)
    a1, b1 = (rng.integers(-3, 4, (b, n, 64)).astype(np.float32)
              for _ in range(2))
    w2 = np.zeros((64, 64), np.float32)
    w2[rng.integers(0, 64, 64), np.arange(64)] = rng.choice(
        np.float32([-2.0, -0.5, 0.5, 1.0, 2.0]), 64)
    return (a1, b1, np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), 16),
            rng.integers(-2, 3, 64).astype(np.float32), w2,
            np.tile(np.float32([1.0, -2.0, 0.5, 1.0]), 16),
            rng.integers(-2, 3, 64).astype(np.float32))


def _env(form: str, monkeypatch) -> None:
    monkeypatch.delenv(EXACT_ENV, raising=False)
    monkeypatch.delenv(EXTRACT_ENV, raising=False)
    if "v2" in form:
        monkeypatch.setenv(EXTRACT_ENV, "v2")
    if "exact" in form:
        monkeypatch.setenv(EXACT_ENV, "1")


def _form_call(form: str, dev, n: int, k: int, kind: str = "ints",
               rowwarp: bool = False, b: int = 1):
    """``form``'s wrapper on ``dev`` (CPU tensors take the plain version)
    at N = n: integer points, each four times, and integer weights (every
    product and sum exact), or standard normal ones (``kind`` "random");
    the same inputs on every device."""
    from dgcnn_tpu_torch.ops.banded import (
        banded_edge_conv_eval,
        banded_knn_edge2,
        sorted_order,
    )
    from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool
    from dgcnn_tpu_torch.ops.edge2_kernel import knn_edge2
    from dgcnn_tpu_torch.ops.edge2_reduce_kernel import edge2_bwd, edge2_fwd
    from dgcnn_tpu_torch.ops.edge_conv_kernel import edge_conv_eval
    from dgcnn_tpu_torch.ops.edge_reduce_bwd_kernel import edge_reduce_bwd
    from dgcnn_tpu_torch.ops.edge_sum_kernel import edge_sum
    from dgcnn_tpu_torch.ops.knn import knn, knn_plain
    from dgcnn_tpu_torch.ops.knn_reduce_kernel import knn_reduce_xw
    from dgcnn_tpu_torch.ops.knn_sum_kernel import knn_sum

    rng = np.random.default_rng(len(form) + n)
    name = form.split()[0]
    amp = "exact" not in form
    kw = {"rowwarp": True} if rowwarp else {}

    def t(a, bf16=False):
        v = torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        return v.to(torch.bfloat16) if bf16 else v

    def vals(shape, scale=1.0):
        if kind == "ints":
            return rng.integers(-3, 4, shape).astype(np.float32)
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def cloud(c, bf16=False):
        if kind == "ints":
            return t(np.concatenate([vals((b, n // 4, c))] * 4, axis=1),
                     bf16)
        return t(vals((b, n, c)), bf16)

    identity = torch.arange(n, device=dev).repeat(b, 1)

    def pc1(g):  # one PC1 order for both devices (ties: the CPU's)
        return sorted_order(g.float().cpu()).to(dev)
    if "edge_conv_eval" in name:
        cin, co = {"v3": (3, 64), "v2": (64, 128), "select-x": (128, 256),
                   "exact": (64, 64)}[form.split()[1]]
        if name == "banded_edge_conv_eval":  # its AMP form: Co <= 64 (B.1)
            co = 64
        g = cloud(cin, amp and cin > 3)
        args = (g, g, t(vals((cin, co), cin ** -0.5)),
                t(vals((cin, co), cin ** -0.5)),
                t(np.tile(np.float32([2.0, -1.0, 0.5, 1.0]), co // 4)),
                t(vals(co, 0.1)))
        if name == "banded_edge_conv_eval":
            return banded_edge_conv_eval(*args, k, 1024, order=pc1(g),
                                         amp=amp, **kw)
        if form == "edge_conv_eval exact" and rowwarp:
            return banded_edge_conv_eval(*args, k, n, order=identity,
                                         rowwarp=True)
        return edge_conv_eval(*args, k, amp=amp,
                              **(kw if amp or "v2" in form else {}))
    if "knn_edge2" in name:
        g = cloud(3) if "v3" in form else cloud(64, amp)
        e2 = [t(a) for a in _edge2_ints(n, 3, b)]
        if name == "banded_knn_edge2":
            return banded_knn_edge2(g, *e2, k, 1024, 0.25, order=pc1(g),
                                    amp=amp, **kw)
        if form == "knn_edge2 exact" and rowwarp:
            return banded_knn_edge2(g, *e2, k, n, 0.25, order=identity,
                                    rowwarp=True)
        return knn_edge2(g, *e2, k, 0.25, amp=amp,
                         **(kw if amp or "v2" in form else {}))
    if name == "knn_reduce":
        return knn_reduce(cloud(3), cloud(32), k, amp=amp,
                          **(kw if amp or "v2" in form else {}))
    if name == "knn_reduce_xw":
        return knn_reduce_xw(cloud(3), cloud(32), t(vals((32, 256), 0.2)),
                             k, amp=amp, **(kw if amp else {}))
    if name == "knn_sum":
        return knn_sum(cloud(3), t(vals((b, n, 9))), k, amp=amp, **kw)
    if name == "knn":
        return knn(cloud(3), k, **kw)
    idx = knn_plain(cloud(3).cpu(), k).int().to(dev)
    if name == "edge_reduce_bwd":
        a = cloud(64)
        ag = a[torch.arange(b, device=dev)[:, None, None], idx.long()]
        cts = [t(vals((b, n, 64))) for _ in range(4)]
        return edge_reduce_bwd(idx, a, ag.amax(2), ag.amin(2), *cts)
    if name == "conv_pool":
        xs = (cloud(64), cloud(128))
        return conv_pool(xs, t(vals((192, 64), 0.1)), t(vals(64, 0.1)),
                         t(vals(64, 0.1)))
    if name == "edge_sum":
        return edge_sum(t(vals((b, n, 18))), idx)
    e2 = [t(a) for a in _edge2_ints(n, 4, b)[:5]]
    out = edge2_fwd(*e2, idx, 0.25, amp=True)
    if name == "edge2_fwd":
        return out
    cts = [t(vals((b, n, 64))) for _ in range(4)]
    return edge2_bwd(*e2, idx, out[0], out[1], *cts, 0.25, amp=True)


def _tuple(v):
    return v if isinstance(v, tuple) else (v,)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 80])
@pytest.mark.parametrize("form", KNN_FORMS + IDX_FORMS)
def test_large_n_form_matches_plain_on_cuda(form, k, cuda_device,
                                            monkeypatch):
    """Each form at N = 8192 (the kNN forms on the tiled route at k = 20,
    on the shared row at k = 80) on integer duplicate points: the plain
    version's bits (kernels 5 and 8's float sums, whose order differs,
    within rel 1e-5 of their norm; kernel 2's mean row, whose LeakyReLU
    outputs are not exact, too, its max row bit-equal).  The banded forms
    take one PC1 order on both devices."""
    if form in IDX_FORMS and k == 80:
        pytest.skip("the idx-driven kernels take k = 20 here")
    _env(form, monkeypatch)
    got = _tuple(_form_call(form, cuda_device, 8192, k))
    want = _tuple(_form_call(form, torch.device("cpu"), 8192, k))
    for i, (gv, wv) in enumerate(zip(got, want)):
        gv = gv.cpu()
        if form == "conv_pool":
            assert torch.equal(gv[:, 0], wv[:, 0])
            assert (gv - wv).norm() <= 1e-5 * wv.norm(), (form, i)
        elif form in ("edge_reduce_bwd", "edge2_bwd") and (
                gv.is_floating_point()):
            assert (gv - wv).norm() <= 1e-5 * wv.norm(), (form, i)
        else:
            assert torch.equal(gv, wv), (form, i)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("form", [f for f in KNN_FORMS
                                  if not f.startswith("banded")])
def test_shared_row_bit_equal_to_register_rows_on_cuda(form, n, cuda_device,
                                                       monkeypatch):
    """The shared row (``force_shared_rows``, its launches counted by the
    launchers) gives the register buckets' bits on random clouds at k =
    20 and 80, and the tiled route's at k = 20 (the exact v1 of kernel 3,
    whose row route runs at k > 64 only: at k = 80)."""
    _env(form, monkeypatch)
    for k in (20, 80):
        if form in ("knn_reduce exact", "knn_reduce_xw exact") and k == 20:
            continue
        reg = _tuple(_form_call(form, cuda_device, n, k, "random", True, 2))
        before = srow_count()
        with force_shared_rows():
            srow = _tuple(_form_call(form, cuda_device, n, k, "random",
                                     True, 2))
        assert srow_count() > before, (form, k)
        assert all(torch.equal(a, b) for a, b in zip(srow, reg)), (form, k)
        if k == 20:
            tiled = _tuple(_form_call(form, cuda_device, n, k, "random",
                                      False, 2))
            assert all(torch.equal(a, b) for a, b in zip(srow, tiled))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 80])
def test_co256_stages_at_4096_on_cuda(k, cuda_device, monkeypatch):
    """DGCNNCls's and the Net's stage 4 (128 -> 256) at N = 4096, which
    raised before the kNN kernels took Co = 256 above 2048 points: the
    exact eval stage (kernel 1) and the training kernel 4 (Co = 256)
    against their plain versions on integer duplicates, in both modes."""
    _env("exact", monkeypatch)
    for form in ("edge_conv_eval exact", "knn_reduce_xw exact"):
        got = _tuple(_form_call(form, cuda_device, 4096, k, b=2))
        want = _tuple(_form_call(form, torch.device("cpu"), 4096, k, b=2))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), form
    _env("", monkeypatch)
    for form in ("edge_conv_eval select-x", "knn_reduce_xw"):
        got = _tuple(_form_call(form, cuda_device, 4096, k, b=2))
        want = _tuple(_form_call(form, torch.device("cpu"), 4096, k, b=2))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), form
