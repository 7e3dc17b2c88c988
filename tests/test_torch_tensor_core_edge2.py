"""The tensor-core redesigns of kernels 7 and 8's AMP forms, the training
two-conv block's forward and backward (``csrc/edge2_reduce_tc.cu``,
``csrc/edge2_bwd.cu``'s ``edge2_bwd_tc_kernel``, their shared z2 tile
``csrc/edge2_tc.cuh``): z2 = h1 w2, and the backward's dh1 and dW2, in
three TF32 terms (each f32 operand split into a TF32 hi and lo by
round-to-nearest, lo * lo dropped), each k8 step's three products into a
zeroed partial added into the f32 sum; each edge's dsel stored as bf16 and
pulled in f32.

On the CPU: the route decisions of both wrappers (``amp_route``, the C
entries they name) at every model's block shapes and off them; CPU
tensors on the plain versions whatever ``simt`` and ``rowwarp`` ask; a
plain version of the 3xTF32 z2 tile (used by these tests only) against
the JAX package's ``_edge2_fwd_call(..., exact=False, interpret=True)``
within rel 1e-5 of each row's norm; the max, min and tie tests as the two
kernels take them (the f32 chain on the candidates of a near tie, on a
block with one in every row): the chain's own ties, every (row, channel)
holding one; the bf16 dsel round-trip
and the pull over bf16 addends bit-equal to the f32 pull; and the route
carried through autograd (``Edge2Reduce``), a mismatch raising.

The ``cuda``-marked tests (no JAX; they skip without a card) mirror
``chip_smoke.py``'s phase 93: the new forms against their plain AMP
versions, the same bits over two calls, every launch on the tensor cores,
integer duplicate points exact.  Run them with ``PYTHONPATH=.:tests
python -m pytest --noconftest -m cuda tests/test_torch_tensor_core_edge2.py``.
"""
import functools
import os

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.ops import edge2_reduce_kernel as e2r
from dgcnn_tpu_torch.ops.amp_select import round_bf16
from dgcnn_tpu_torch.ops.edge2_reduce import edge2_reduce
from dgcnn_tpu_torch.ops.edge_reduce_bwd_kernel import (
    pull_sum,
    reverse_lists_plain,
    scatter_edges,
)
from dgcnn_tpu_torch.ops.graph import gather_neighbors

K = 20
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dgcnn_tpu_torch", "csrc")


# ------------------------------------------------------------ the routes
# (C1, C2, k, simt, rowwarp, route): DGCNNSemSeg's and DGCNNPartSeg's
# blocks (k = 20, 40), a user's k = 80, the tiled route's edges, the
# earlier form, and shapes off the tiled route
@pytest.mark.parametrize("c1,c2,k,simt,rowwarp,route", [
    (64, 64, 20, False, False, "tensor_core"),   # semseg blocks
    (64, 64, 40, False, False, "tensor_core"),   # partseg blocks
    (64, 64, 80, False, False, "tensor_core"),   # a user's --k 80
    (64, 64, 128, False, False, "tensor_core"),  # the longest tile row
    (16, 16, 6, False, False, "tensor_core"),    # phase 13's duplicates
    (60, 4, 1, False, False, "tensor_core"),
    (64, 64, 20, True, False, "simt"),           # the earlier form
    (64, 64, 40, True, False, "simt"),
    (64, 64, 129, False, False, "rowwarp"),      # k above the tile
    (64, 64, 129, True, False, "rowwarp"),
    (64, 72, 20, False, False, "rowwarp"),       # C2 above 64
    (64, 72, 20, True, False, "rowwarp"),
    (62, 64, 20, False, False, "rowwarp"),       # C1 not a multiple of 4
    (64, 64, 20, False, True, "rowwarp"),        # forced
    (64, 64, 20, True, True, "rowwarp"),
])
def test_amp_route(c1, c2, k, simt, rowwarp, route):
    assert e2r.amp_route(c1, c2, k, simt=simt, rowwarp=rowwarp) == route
    if not rowwarp:  # the backward's route: the same without the keyword
        assert e2r.amp_route(c1, c2, k, simt=simt) == route


def _source_entries() -> set:
    entries = set()
    for name in os.listdir(CSRC):
        if name.endswith(".cu"):
            with open(os.path.join(CSRC, name)) as f:
                entries |= {line.split("(")[0].split()[-1]
                            for line in f if line.startswith('extern "C"')}
    return entries


@pytest.mark.parametrize("simt,want_fwd,want_bwd", [
    (False, "dg_edge2_fwd_amp_tc", "dg_edge2_bwd_pull_amp_tc"),
    (True, "dg_edge2_fwd_amp", "dg_edge2_bwd_pull_amp"),
])
def test_simt_names_the_earlier_form(simt, want_fwd, want_bwd):
    """At the models' shapes the default names the tensor-core entries,
    ``simt`` the earlier form's (edge2_reduce.cu's and edge2_bwd.cu's
    tiled AMP instances); every named entry is one the sources define."""
    for k in (20, 40):
        route = e2r.amp_route(64, 64, k, simt=simt)
        assert e2r.fwd_entry(route, True) == want_fwd
        assert e2r.bwd_entry(route, True) == want_bwd
    entries = _source_entries()
    named = {e2r.fwd_entry(r, a) for r in ("tensor_core", "simt", "rowwarp")
             for a in (True, False) if (a or r != "tensor_core")}
    named |= {e2r.bwd_entry(r, True) for r in ("tensor_core", "simt")}
    named |= {e2r.bwd_entry(None, False), e2r.bwd_entry(None, False, True)}
    assert named <= entries, named - entries


def test_simt_refused_by_the_exact_form():
    """``simt`` names the AMP form's earlier form: the exact form refuses
    it before any launch."""
    a1, b1, s1, t1, w2, idx = _inputs(np.random.default_rng(0), 1, 64, 16,
                                      16, 4)
    with pytest.raises(ValueError, match="simt"):
        e2r.edge2_fwd(a1, b1, s1, t1, w2, idx, simt=True)
    mx, mn, _, _ = e2r.edge2_fwd(a1, b1, s1, t1, w2, idx)
    with pytest.raises(ValueError, match="simt"):
        e2r.edge2_bwd(a1, b1, s1, t1, w2, idx, mx, mn, mx, mx, mx, mx,
                      simt=True)


# ------------------------------------------------- inputs, plain versions
def _inputs(rng, b, n, c1, c2, k):
    """a1, b1, s1, t1, w2 (random normal, a BatchNorm-like s1 with some
    negative scales) and idx (B, N, k) int32 of one block."""
    a1 = torch.from_numpy(rng.standard_normal((b, n, c1)).astype(np.float32))
    b1 = torch.from_numpy(rng.standard_normal((b, n, c1)).astype(np.float32))
    s1 = torch.from_numpy((rng.uniform(0.5, 1.5, c1) * np.where(
        rng.random(c1) < 0.15, -1, 1)).astype(np.float32))
    t1 = torch.from_numpy((0.1 * rng.standard_normal(c1)).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((c1, c2))
                           / np.sqrt(c1)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(np.int32))
    return a1, b1, s1, t1, w2, idx


def _cts(rng, shape):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(4)]


def _h1(a1, b1, s1, t1, idx, slope):
    """Each edge's h1 (B, N, k, C1) as the kernels stage it: the selected
    a1 row rounded to bf16, then (a + b1) * s1 + t1 and the LReLU, each
    operation rounded."""
    z1 = (gather_neighbors(round_bf16(a1), idx.long())
          + b1[:, :, None]) * s1 + t1
    return torch.where(z1 >= 0, z1, slope * z1)


def _tf32_split(x: torch.Tensor):
    """(hi, lo) of f32 ``x`` as mma_tf32.cuh's split hands them to the
    tensor core: hi = x rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero), lo = x - hi (exact) rounded the same way."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = tf32(x)
    return hi, tf32(x - hi)


def tc_z2_plain(h1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The z2 tile of edge2_tc.cuh in plain torch: for each k8 step of the
    first-conv channels, lo*hi + hi*lo + hi*hi of the TF32 splits (exact
    products; their sum here in f64, rounded once, where the tensor core
    truncates within an MMA), added into the f32 sum step by step."""
    hh, hl = _tf32_split(h1)
    wh, wl = _tf32_split(w2)
    acc = torch.zeros(h1.shape[:-1] + (w2.shape[1],), dtype=torch.float32)
    for c0 in range(0, h1.shape[-1], 8):
        s = slice(c0, c0 + 8)
        part = (hl[..., s].double() @ wh[s].double()
                + hh[..., s].double() @ wl[s].double()
                + hh[..., s].double() @ wh[s].double())
        acc = acc + part.float()
    return acc


def fmaf_z2_plain(h1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """z2 as edge2_tile.cuh's fmaf chain forms it (the earlier tiled form
    and the row-warp route): one fused multiply-add a first-conv channel,
    ascending from zero, each rounded to f32 once (exact in f64 before
    the rounding: a product of two f32 values fits it)."""
    acc = torch.zeros(h1.shape[:-1] + (w2.shape[1],), dtype=torch.float32)
    for c in range(h1.shape[-1]):
        acc = (h1[..., c:c + 1].double() * w2[c].double()
               + acc.double()).float()
    return acc


def _reductions(z2):
    """max, min, sum and sum of squares over t, t ascending (the kernels'
    order of _rn adds)."""
    sm = torch.zeros_like(z2[:, :, 0])
    sq = torch.zeros_like(sm)
    for t in range(z2.shape[2]):
        sm = sm + z2[:, :, t]
        sq = sq + z2[:, :, t] * z2[:, :, t]
    return z2.amax(2), z2.amin(2), sm, sq


@functools.lru_cache(maxsize=None)
def _jax_fwd():
    """The JAX package's AMP kernel 7 in interpret mode, one jit for the
    cases (k = 20, slope 0.2)."""
    import jax

    from dgcnn_tpu.ops.pallas_knn import _edge2_fwd_call

    return jax.jit(functools.partial(_edge2_fwd_call, k=K, slope=0.2,
                                     exact=False, interpret=True))


def _row_rel(got, want) -> torch.Tensor:
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30))


@pytest.mark.parametrize("seed", [27, 28])
def test_tc_tile_plain_vs_pallas(seed):
    """The plain tensor-core tile's four reductions against kernel 7's TPU
    kernel with exact=False (f32 products at float32 precision) on the
    same idx: within rel 1e-5 of each row's norm; and against the f32
    product of the plain AMP version within the same."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    ins = _inputs(rng, 2, 256, 64, 64, K)
    h1 = _h1(*ins[:4], ins[5], 0.2)
    got = _reductions(tc_z2_plain(h1, ins[4]))
    with jax.default_matmul_precision("float32"):
        want = _jax_fwd()(*(jnp.asarray(t.numpy()) for t in ins))
    for g, w in zip(got, want):
        assert _row_rel(g, torch.from_numpy(np.array(w))).max() <= 1e-5
    for g, w in zip(got, e2r.edge2_fwd_amp_plain(*ins)):
        assert _row_rel(g, w).max() <= 1e-5


TOL = 2.0 ** -13  # edge2_tc.cuh's bound: TOL ||h1 row|| ||w2 column||


def _near_tie_block(seed):
    """One block whose every row holds a near tie: neighbours 0 and 1 of
    each row are a point and its partner, whose a1 row is the point's with
    one channel one bf16 step larger."""
    rng = np.random.default_rng(seed)
    a1, b1, s1, t1, w2, idx = _inputs(rng, 2, 256, 64, 64, K)
    a1 = round_bf16(a1)
    ch = torch.from_numpy(rng.integers(0, 64, 128))
    a1[:, 1::2] = a1[:, 0::2]
    a1[:, 2 * torch.arange(128) + 1, ch] *= 1 + 2.0 ** -7
    idx[..., 1] = idx[..., 0] ^ 1
    return a1, b1, s1, t1, w2, idx


def test_tie_tests_find_the_chains_ties():
    """Kernel 7's max and min and kernel 8's tie tests by edge2_tc.cuh's
    rule, emulated: within twice the row's bound (TOL ||h1 row|| ||w2
    column||) of the tile's extreme lie the chain's extreme edges; where
    one edge alone does, it is the extreme; where several do, the forward
    writes the tile z2 of the edge whose chain z2 is the extreme and the
    backward's ties are the candidates whose chain z2 equals it.  On a
    block with a near tie in every row (several candidates at about one in
    twenty outputs): the ties are the f32 chain's own, every (row, channel)
    holding one, and the tile's z2 is not the chain's (another order of
    sums)."""
    a1, b1, s1, t1, w2, idx = _near_tie_block(7)
    h1 = _h1(a1, b1, s1, t1, idx, 0.2)
    z_tc = tc_z2_plain(h1, w2)
    z_ch = fmaf_z2_plain(h1, w2)
    bound = TOL * h1.norm(dim=-1)[..., None] * w2.norm(dim=0)
    assert ((z_tc - z_ch).abs() <= bound / 8).all()
    lim = (2 * TOL * h1.norm(dim=-1).amax(2))[..., None] * w2.norm(dim=0)
    inf = torch.tensor(float("inf"))
    several = 0
    for sign in (1, -1):  # the max, then the min as the max of -z2
        tc, ch = sign * z_tc, sign * z_ch
        near = tc >= (tc.amax(2) - lim)[:, :, None]
        n = near.sum(2)
        several += int((n > 1).sum())
        pick = torch.where(near, ch, -inf).argmax(2, keepdim=True)
        ext = torch.where(n > 1, tc.gather(2, pick)[:, :, 0], tc.amax(2))
        window = tc >= (ext - lim)[:, :, None]
        best = torch.where(window, ch, -inf).amax(2, keepdim=True)
        ties = torch.where((window.sum(2) == 1)[:, :, None], window,
                           window & (ch == best))
        assert torch.equal(ties, ch == ch.amax(2, keepdim=True))
        assert int((ties.sum(2) == 0).sum()) == 0
    assert 0.02 * 2 * lim.numel() < several < 0.2 * 2 * lim.numel()
    assert (z_tc != z_ch).float().mean() > 0.1


# --------------------------------------------------------- bf16 and pull
def test_bf16_dsel_round_trip():
    """A bf16 value stored as bf16 and widened back is itself: the stored
    dsel of the tensor-core form has the earlier form's bits (each dsel
    rounded to bf16 before it was stored as f32)."""
    rng = np.random.default_rng(3)
    x = round_bf16(torch.from_numpy(
        rng.standard_normal(100_000).astype(np.float32) * 10.0 ** rng.integers(
            -30, 30, 100_000)))
    assert torch.equal(x.to(torch.bfloat16).float(), x)


def test_pull_over_bf16_addends_is_the_f32_pull():
    """The pull over bf16 addends widened to f32 equals the f32 pull of the
    same values bit for bit, and both an f32 np.add.at over the edges in
    ascending order (the reverse lists' order)."""
    rng = np.random.default_rng(4)
    b, n, k, c = 2, 128, K, 64
    idx = torch.from_numpy(rng.integers(0, n // 4, (b, n, k)).astype(
        np.int32))  # a quarter of the points receive every edge
    add = round_bf16(torch.from_numpy(rng.standard_normal(
        (b, n, k, c)).astype(np.float32)))
    got = pull_sum(idx, add.to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert torch.equal(got, pull_sum(idx, add))
    target = (idx.long() + n * torch.arange(b)[:, None, None]).reshape(-1)
    want = np.zeros((b * n, c), np.float32)
    np.add.at(want, target.numpy(), add.reshape(-1, c).numpy())
    assert np.array_equal(got.reshape(-1, c).numpy(), want)
    off, lst = reverse_lists_plain(idx)
    assert torch.equal(lst, torch.sort(target, stable=True).indices)
    assert torch.equal(got, scatter_edges(add, idx))


# --------------------------------------------------------- CPU tensors
@pytest.mark.parametrize("keywords", [{}, {"simt": True}, {"rowwarp": True},
                                      {"simt": True, "rowwarp": True}])
def test_cpu_takes_the_plain_versions(keywords):
    rng = np.random.default_rng(5)
    ins = _inputs(rng, 2, 128, 64, 64, K)
    got = e2r.edge2_fwd(*ins, 0.2, amp=True, **keywords)
    want = e2r.edge2_fwd_amp_plain(*ins, 0.2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cts = _cts(rng, (2, 128, 64))
    simt = {"simt": True} if keywords.get("simt") else {}
    grads = e2r.edge2_bwd(*ins, got[0], got[1], *cts, 0.2, amp=True, **simt)
    plain = e2r.edge2_bwd_amp_plain(*ins, got[0], got[1], *cts, 0.2)
    assert all(torch.equal(g, w) for g, w in zip(grads, plain))


# ------------------------------------------------------ the route carried
def test_route_carried_through_autograd():
    """``Edge2Reduce`` saves the AMP forward's route (the tensor-core one
    at the models' shapes, none in the exact mode) and hands it to the
    backward, whose gradients are the plain AMP backward's; a saved route
    whose z2 arithmetic differs from the backward's raises."""
    rng = np.random.default_rng(6)
    a1, b1, s1, t1, w2, idx = _inputs(rng, 2, 128, 64, 64, K)
    leaves = [t.clone().requires_grad_(True) for t in (a1, b1, s1, t1, w2)]
    out = edge2_reduce(*leaves, idx, 0.2, True)
    assert out[0].grad_fn.route == "tensor_core"
    cts = _cts(rng, (2, 128, 64))
    got = torch.autograd.grad(out, leaves, cts)
    want = e2r.edge2_bwd_amp_plain(a1, b1, s1, t1, w2, idx, out[0].detach(),
                                   out[1].detach(), *cts, 0.2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert edge2_reduce(*leaves, idx, 0.2, False)[0].grad_fn.route is None
    # a forward on the row-warp route (the fmaf chain) at these shapes: the
    # backward takes the tensor cores there and must refuse
    out = edge2_reduce(*leaves, idx, 0.2, True)
    out[0].grad_fn.route = "rowwarp"
    with pytest.raises(ValueError, match="tie tests"):
        torch.autograd.grad(out, leaves, cts)


@pytest.mark.parametrize("k,fwd_route,simt,raises", [
    (20, "tensor_core", False, False),
    (20, "simt", True, False),
    (20, "rowwarp", True, False),      # the fmaf chain on both sides
    (20, "simt", False, True),
    (20, "rowwarp", False, True),
    (20, "tensor_core", True, True),
    (129, "rowwarp", False, False),    # off the tiled route
    (129, "tensor_core", False, True),
])
def test_backward_route_mismatch_raises(k, fwd_route, simt, raises):
    rng = np.random.default_rng(k)
    ins = _inputs(rng, 1, 160, 16, 16, k)
    mx, mn, _, _ = e2r.edge2_fwd(*ins, 0.2, amp=True)
    cts = _cts(rng, (1, 160, 16))

    def run():
        return e2r.edge2_bwd(*ins, mx, mn, *cts, 0.2, amp=True, simt=simt,
                             fwd_route=fwd_route)

    if raises:
        with pytest.raises(ValueError, match="tie tests"):
            run()
    else:
        got = run()
        want = e2r.edge2_bwd_amp_plain(*ins, mx, mn, *cts, 0.2)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dup_ints(dev):
    """Phase 13's integer duplicate points (C1 = C2 = 16, k = 6, slope
    1/4, scales +-1 and 1/2, max/min cotangents multiples of 60): every
    operation exact, so the forms and the plain versions agree bit for
    bit."""
    from dgcnn_tpu_torch.ops.knn import knn_plain

    g = torch.Generator().manual_seed(12)

    def ints(*shape, lo=-2, hi=3):
        return torch.randint(lo, hi, shape, generator=g).float()

    base = [ints(2, 64, 3), ints(2, 64, 16)]
    graph, a1 = (torch.cat([t] * 4, dim=1) for t in base)
    b1, w2 = ints(2, 256, 16), ints(16, 16, lo=-1, hi=2)
    s1 = torch.where(ints(16) >= 0, 1.0, -0.5)
    _ = torch.where(ints(16) >= 0, 1.0, -1.0)
    t1 = ints(16)
    idx = knn_plain(graph, 6).int()
    cts = [60 * ints(2, 256, 16), 60 * ints(2, 256, 16), ints(2, 256, 16),
           ints(2, 256, 16)]
    return [t.to(dev) for t in (a1, b1, s1, t1, w2, idx)], [
        t.to(dev) for t in cts]


# (B, N, k): the semseg and partseg training blocks at a fraction of their
# batch, a user's k = 80
CUDA_CASES = [(4, 4096, 20), (4, 2048, 40), (1, 1024, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_tensor_core_forms_on_cuda(case, cuda_device):
    b, n, k = case
    rng = np.random.default_rng(n + k)
    ins = [t.to(cuda_device) for t in _inputs(rng, b, n, 64, 64, k)]
    fwd0, bwd0 = e2r.edge2_fwd.tc_launches, e2r.edge2_bwd.tc_launches
    got = e2r.edge2_fwd(*ins, 0.2, amp=True)
    again = e2r.edge2_fwd(*ins, 0.2, amp=True)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = e2r.edge2_fwd_amp_plain(*ins, 0.2)
    for g, w in zip(got, want):
        assert _row_rel(g, w).max() <= 1e-5
    cts = [t.to(cuda_device) for t in _cts(rng, (b, n, 64))]
    grads = e2r.edge2_bwd(*ins, got[0], got[1], *cts, 0.2, amp=True,
                          fwd_route="tensor_core")
    twice = e2r.edge2_bwd(*ins, got[0], got[1], *cts, 0.2, amp=True)
    assert all(torch.equal(g, a) for g, a in zip(grads, twice))
    assert e2r.edge2_fwd.tc_launches == fwd0 + 2
    assert e2r.edge2_bwd.tc_launches == bwd0 + 2
    dsel, *plain = e2r.edge2_bwd_amp_edges(*ins, *cts, 0.2)
    for g, w in zip(grads[1:], plain):
        assert (g - w).norm() <= 1e-5 * w.norm()
    want_da1 = scatter_edges(round_bf16(dsel), ins[5])
    tol = 1e-5 * want_da1.norm(dim=-1, keepdim=True)
    err = (grads[0] - want_da1).abs()
    mag = scatter_edges(dsel.abs(), ins[5])
    assert (err <= 2.0 ** -7 * mag + tol).all()
    assert (err > tol).float().mean() <= 1e-2


@pytest.mark.cuda
def test_tensor_core_forms_exact_on_integer_duplicates(cuda_device):
    ins, cts = _dup_ints(cuda_device)
    got = e2r.edge2_fwd(*ins, 0.25, amp=True)
    assert all(torch.equal(g, w) for g, w in zip(
        got, e2r.edge2_fwd_amp_plain(*ins, 0.25)))
    grads = e2r.edge2_bwd(*ins, got[0], got[1], *cts, 0.25, amp=True)
    assert all(torch.equal(g, w) for g, w in zip(
        grads, e2r.edge2_bwd_amp_plain(*ins, got[0], got[1], *cts, 0.25)))


@pytest.mark.cuda
def test_pull_bf16_on_cuda(cuda_device):
    rng = np.random.default_rng(8)
    b, n, k, c = 2, 4096, K, 64
    idx = torch.from_numpy(rng.integers(0, n, (b, n, k)).astype(
        np.int32)).to(cuda_device)
    add = round_bf16(torch.from_numpy(rng.standard_normal(
        (b, n, k, c)).astype(np.float32))).to(cuda_device)
    got = pull_sum(idx, add.to(torch.bfloat16))
    assert torch.equal(got, pull_sum(idx, add))
    assert torch.equal(got.cpu(), pull_sum(idx.cpu(), add.cpu()))
