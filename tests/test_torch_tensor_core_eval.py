"""The tensor-core redesigns of kernels 1 and 6's AMP forms, the eval kNN
stages (``csrc/edge_conv_amp_tc.cu``, ``csrc/knn_edge2_variant.cu``):
each tile's scores from bf16 ``mma.sync`` over the hi / lo operands (or
the bf16 graph itself), the v2 grid and keys on the same scores, and the
v3 list's first tile filled by the sorting network.

On the CPU: the Python route decisions, made from the shape before any
launch (``edge_conv_kernel.amp_route``, ``edge2_kernel.amp_route``), at
every model's stage shapes; the plain version of the tensor-core score
tile (``amp_select.tc_scores_plain``: bf16 operands, exact products, f32
sums k16 step by k16 step) against the JAX package's ``_scores(q, x,
exact=False)`` within 1e-5 of |q|^2 + |x|^2, equal points scoring the
same bits; the plain sorted fill (``v3_class_lists`` over one tile's
columns, the rest inserted) bit-equal to the column-by-column insertion
(``class_insert_plain``) over shuffled column orders; and CPU tensors on
the plain versions whatever ``simt`` and ``rowwarp`` ask.

The ``cuda``-marked tests (no JAX; they skip without a card) hold the new
forms on the card as ``chip_smoke.py``'s phase 91 does: within one bf16
ulp of the plain AMP version on >= 99.9% of rows, the same bits over two
calls, the route by the wrappers' counts, and the v3 lists of the sorting
network bit-equal to the insertions' with every class recounted.  Run
them with ``PYTHONPATH=.:tests python -m pytest --noconftest -m cuda
tests/test_torch_tensor_core_eval.py``.
"""
import functools

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.ops import edge2_kernel as e2
from dgcnn_tpu_torch.ops import edge_conv_kernel as ec
from dgcnn_tpu_torch.ops.amp_select import (
    class_insert_plain,
    tc_channels,
    tc_operands_plain,
    tc_scores_plain,
    v3_class_lists,
)


# (k, N, Co, Cg, bf16 graph, route): the DGCNNCls stages, DGCNNSemSeg's and
# DGCNNPartSeg's conv5, the fusion Net's stages (k = 32), the largest
# cloud, k above the tiled lists, graphs wider than the operands' limit,
# and shapes the kernel refuses
@pytest.mark.parametrize("k,n,co,cg,bf,route", [
    (20, 1024, 64, 3, False, "tensor"),       # cls stage 1
    (20, 1024, 64, 64, True, "tensor"),       # cls stage 2
    (20, 1024, 128, 64, True, "tensor"),      # cls stage 3
    (20, 1024, 256, 128, True, "tensor"),     # cls stage 4 (select-x)
    (20, 4096, 64, 64, True, "tensor"),       # semseg conv5
    (40, 2048, 64, 64, True, "tensor"),       # partseg conv5
    (32, 2048, 64, 3, False, "tensor"),       # the Net's stage 1
    (32, 2048, 256, 128, True, "tensor"),     # the Net's stage 4
    (20, 32768, 64, 3, False, "tensor"),      # the largest cloud
    (64, 256, 8, 1, False, "tensor"),         # the longest tiled list
    (20, 1024, 64, 384, True, "tensor"),      # the widest bf16 operands
    (20, 1024, 64, 128, False, "tensor"),     # the widest f32 ones (384)
    (20, 1024, 64, 129, False, "simt"),       # Kp 400
    (20, 1024, 64, 385, True, "simt"),
    (65, 1024, 64, 3, False, "rowwarp"),
    (80, 4096, 64, 64, True, "rowwarp"),
    (20, 1000, 64, 3, False, "none"),         # N not a multiple of 128
    (20, 65536, 64, 3, False, "none"),        # N above MAX_N
    (20, 1024, 257, 3, False, "none"),        # Co above MAX_CO
    (300, 256, 8, 3, False, "none"),          # k above N
])
def test_edge_conv_amp_route(k, n, co, cg, bf, route):
    assert ec.amp_route(k, n, co, cg, bf) == route


# (k, N, C1, C2, Cg, bf16 graph, route): DGCNNSemSeg's two blocks,
# DGCNNPartSeg's TransformNet and two blocks, the Net's block, the
# largest cloud, shapes off the tiled route, and refused ones
@pytest.mark.parametrize("k,n,c1,c2,cg,bf,route", [
    (20, 4096, 64, 64, 3, False, "tensor"),    # semseg block 1 (xyz)
    (20, 4096, 64, 64, 9, False, "tensor"),    # a 9-channel graph
    (20, 4096, 64, 64, 64, True, "tensor"),    # semseg block 2
    (40, 2048, 64, 128, 3, False, "tensor"),   # partseg TransformNet
    (40, 2048, 64, 64, 3, False, "tensor"),    # partseg block 1
    (40, 2048, 64, 64, 64, True, "tensor"),    # partseg block 2
    (32, 2048, 64, 64, 3, False, "tensor"),    # the Net's block
    (20, 32768, 64, 64, 3, False, "tensor"),   # the largest cloud
    (20, 4096, 64, 64, 129, False, "simt"),
    (65, 2048, 64, 64, 3, False, "rowwarp"),
    (20, 2048, 128, 64, 3, False, "rowwarp"),  # C1 above the tile's 64
    (20, 2048, 64, 129, 3, False, "none"),     # C2 above 128
    (20, 1000, 64, 64, 3, False, "none"),
    (20, 65536, 64, 64, 3, False, "none"),
])
def test_knn_edge2_amp_route(k, n, c1, c2, cg, bf, route):
    assert e2.amp_route(k, n, c1, c2, cg, bf) == route


@pytest.mark.parametrize("dtype,starts,rowwarp,simt,want", [
    (torch.float32, None, False, False, True),
    (torch.bfloat16, None, False, False, True),
    (torch.float32, "windows", False, False, False),  # kernels 12 and 13
    (torch.float32, None, True, False, False),
    (torch.bfloat16, None, False, True, False),
])
def test_tensor_core_launch_decision(dtype, starts, rowwarp, simt, want):
    """The wrappers' choice of the tensor-core form for a launch: over the
    cloud, unless the row-warp route or the earlier form is asked for."""
    graph = torch.zeros((1, 256, 64), dtype=dtype)
    w2 = torch.zeros((64, 64))
    assert ec._tensor(graph, 64, 20, True, starts, rowwarp, simt) == want
    assert e2._tensor(graph, w2, 20, True, starts, rowwarp, simt) == want
    assert not ec._tensor(graph, 64, 20, False, None, False, False)


@pytest.mark.parametrize("cg,bf,kp", [(3, False, 16), (9, False, 32),
                                      (64, False, 192), (128, False, 384),
                                      (64, True, 64), (3, True, 16),
                                      (128, True, 128)])
def test_tc_operands_layout(cg, bf, kp):
    """Kp channels; an f32 graph's [hi | hi | lo | 0..] against [hi | lo |
    hi | 0..], a bf16 graph's values and zeros on both sides."""
    rng = np.random.default_rng(cg)
    g = torch.from_numpy(rng.standard_normal((1, 8, cg)).astype(np.float32))
    if bf:
        g = g.to(torch.bfloat16)
    gq, gc = tc_operands_plain(g)
    assert tc_channels(cg, bf) == kp
    assert gq.shape == gc.shape == (1, 8, kp) and gq.dtype == torch.bfloat16
    if bf:
        assert torch.equal(gq, gc) and torch.equal(gc[..., :cg], g)
    else:
        hi = g.to(torch.bfloat16)
        lo = (g - hi.float()).to(torch.bfloat16)
        assert torch.equal(gq[..., :3 * cg], torch.cat([hi, hi, lo], -1))
        assert torch.equal(gc[..., :3 * cg], torch.cat([hi, lo, hi], -1))
    assert not gq[..., (cg if bf else 3 * cg):].float().any()


@functools.lru_cache(maxsize=None)
def _jax_amp_scores():
    """One jit of the JAX package's AMP scores of a cloud against itself
    (batched over clouds), shared by the cases."""
    import jax

    from dgcnn_tpu.ops.pallas_knn import _scores

    return jax.jit(jax.vmap(lambda x: _scores(x, x, exact=False)))


@pytest.mark.parametrize("cg,bf", [(3, False), (64, True)])
def test_tc_scores_plain_vs_jax(cg, bf):
    """The plain tensor-core scores against ``_scores(q, x, exact=False)``
    on seeded inputs (f32 xyz, bf16 features, each with every other point
    a copy of the one before): within 1e-5 of |q|^2 + |x|^2 (the f32 sums'
    orders differ), and a point and its copy the same bits in every row
    and column."""
    import jax.numpy as jnp

    rng = np.random.default_rng(90 + cg)
    x = rng.standard_normal((2, 256, cg)).astype(np.float32)
    x[:, 1::2] = x[:, ::2]
    g = torch.from_numpy(x)
    if bf:
        g = g.to(torch.bfloat16)
        jx = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
    else:
        jx = jnp.asarray(x)
    got = tc_scores_plain(g)
    want = torch.from_numpy(np.array(_jax_amp_scores()(jx)))
    sq = g.float().square().sum(-1)
    scale = sq[:, :, None] + sq[:, None, :]
    assert ((got - want).abs() <= 1e-5 * scale).all()
    assert torch.equal(got[:, :, 0::2], got[:, :, 1::2])
    assert torch.equal(got[:, 0::2], got[:, 1::2])


def _lists_of(vals, cnt, low, b, i):
    n = int((cnt[b, i] > 0).sum())
    return [[float(vals[b, i, c]), int(cnt[b, i, c]), int(low[b, i, c])]
            for c in range(n)]


@pytest.mark.parametrize("cg,bf,k", [(3, False, 20), (3, False, 40),
                                     (16, True, 20), (9, False, 64)])
def test_sorted_fill_is_the_insertions(cg, bf, k):
    """On integer clouds with repeated points (many tied classes) and on
    random ones: for each of 24 rows, the plain sorted fill (one tile of
    128 columns sorted into its classes, then the other columns inserted)
    and the insertion of every column one at a time, each over three
    shuffled column orders, give the same list as the whole row's k
    largest distinct scores with their counts and lowest members."""
    rng = np.random.default_rng(cg + k)
    if cg == 9:
        x = rng.standard_normal((1, 256, cg)).astype(np.float32)
    else:
        base = rng.integers(-3, 4, (1, 48, cg)).astype(np.float32)
        x = base[:, rng.integers(0, 48, 256)]
    g = torch.from_numpy(x)
    if bf:
        g = g.to(torch.bfloat16)
    scores = tc_scores_plain(g)
    vals, cnt, low = v3_class_lists(scores, k)
    for i in range(0, 256, 11)[:24]:
        want = _lists_of(vals, cnt, low, 0, i)
        row = scores[0, i]
        for seed in range(3):
            perm = np.random.default_rng(seed).permutation(256)
            serial = class_insert_plain([], row[perm].tolist(), perm, k)
            assert serial == want
            # the first tile's columns ascending, as a tile holds them
            tile, rest = np.sort(perm[:128]), perm[128:]
            tv, tc, tl = v3_class_lists(row[tile][None, None], k)
            first = [[e[0], e[1], int(tile[e[2]])]
                     for e in _lists_of(tv, tc, tl, 0, 0)]
            assert class_insert_plain(first, row[rest].tolist(), rest,
                                      k) == want


def test_class_lists_plain_recount():
    """``class_lists`` on the CPU: both fills the same, every class's
    recount its count, its first counted column its lowest member."""
    rng = np.random.default_rng(3)
    base = rng.integers(-2, 3, (2, 40, 3)).astype(np.float32)
    g = torch.from_numpy(base[:, rng.integers(0, 40, 256)].copy())
    got = ec.class_lists(g, 20)
    again = ec.class_lists(g, 20, serial=True)
    for key in got:
        assert torch.equal(got[key], again[key])
    present = got["counts"] > 0
    assert torch.equal(got["recount"], got["counts"])
    assert torch.equal(got["relow"][present], got["lows"][present])
    assert (got["counts"] > 1).any()


def _stage(rng, b, n, cin, co, bf):
    x = torch.from_numpy(rng.standard_normal((b, n, cin)).astype(np.float32))
    if bf:
        x = x.to(torch.bfloat16)
    ws = [torch.from_numpy((rng.standard_normal((cin, co))
                            / cin ** 0.5).astype(np.float32))
          for _ in range(2)]
    s = torch.from_numpy(rng.random(co).astype(np.float32) - 0.2)
    t = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
    return x, (*ws, s, t)


def _block(rng, b, n, cg, bf):
    g = torch.from_numpy(rng.standard_normal((b, n, cg)).astype(np.float32))
    if bf:
        g = g.to(torch.bfloat16)
    f = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((b, n, 64), (b, n, 64))]
    aff = [torch.from_numpy(v.astype(np.float32)) for v in (
        rng.random(64) + 0.5, rng.standard_normal(64) / 8,
        rng.standard_normal((64, 64)) / 8, rng.random(64),
        rng.standard_normal(64) / 8)]
    return g, (*f, *aff)


@pytest.mark.parametrize("keywords", [{}, {"simt": True},
                                      {"rowwarp": True},
                                      {"simt": True, "rowwarp": True}])
@pytest.mark.parametrize("cin,co,bf", [(3, 64, False), (64, 128, True)])
def test_edge_conv_amp_cpu_takes_the_plain_version(keywords, cin, co, bf):
    rng = np.random.default_rng(cin)
    x, args = _stage(rng, 2, 256, cin, co, bf)
    got = ec.edge_conv_eval(x, x, *args, 20, amp=True, **keywords)
    assert torch.equal(got, ec.edge_conv_eval_amp_plain(x, x, *args, 20))


@pytest.mark.parametrize("keywords", [{}, {"simt": True},
                                      {"rowwarp": True}])
@pytest.mark.parametrize("cg,bf", [(3, False), (64, True)])
def test_knn_edge2_amp_cpu_takes_the_plain_version(keywords, cg, bf):
    rng = np.random.default_rng(cg)
    g, args = _block(rng, 2, 256, cg, bf)
    got = e2.knn_edge2(g, *args, 20, amp=True, **keywords)
    assert torch.equal(got, e2.knn_edge2_amp_plain(g, *args, 20))


@pytest.mark.parametrize("fn", ["edge_conv_eval", "knn_edge2"])
def test_simt_names_the_amp_form(fn):
    """``simt`` asks for the AMP form's earlier form: the exact form on a
    CUDA tensor refuses it before any launch (a meta tensor stands in)."""
    meta = torch.device("meta")
    if fn == "edge_conv_eval":
        x = torch.empty((1, 256, 3), device=meta)
        w = torch.empty((3, 64), device=meta)
        v = torch.empty(64, device=meta)
        with pytest.raises(ValueError, match="simt"):
            ec.edge_conv_eval(x, x, w, w, v, v, 20, simt=True)
    else:
        g = torch.empty((1, 256, 3), device=meta)
        a = torch.empty((1, 256, 64), device=meta)
        w2 = torch.empty((64, 64), device=meta)
        v = torch.empty(64, device=meta)
        with pytest.raises(ValueError, match="simt"):
            e2.knn_edge2(g, a, a, v, v, w2, v, v, 20, simt=True)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulp_rows(got, want) -> float:
    d = (got.view(torch.int16).int()
         - want.to(torch.bfloat16).view(torch.int16).int()).abs()
    return (d.amax(-1) <= 1).float().mean().item()


# (B, N, Cin, Co, bf16 input, k): the DGCNNCls stages, conv5 of the seg
# models
STAGE_CASES = [(4, 1024, 3, 64, False, 20), (4, 1024, 64, 64, True, 20),
               (4, 1024, 64, 128, True, 20), (4, 1024, 128, 256, True, 20),
               (2, 4096, 64, 64, True, 20), (2, 2048, 64, 64, True, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STAGE_CASES)
def test_edge_conv_amp_tensor_core_on_cuda(case, cuda_device):
    b, n, cin, co, bf, k = case
    rng = np.random.default_rng(n + cin + co)
    x, args = _stage(rng, b, n, cin, co, bf)
    x, args = x.to(cuda_device), [a.to(cuda_device) for a in args]
    before = ec.edge_conv_eval.tc_launches
    got = ec.edge_conv_eval(x, x, *args, k, amp=True)
    again = ec.edge_conv_eval(x, x, *args, k, amp=True)
    old = ec.edge_conv_eval(x, x, *args, k, amp=True, simt=True)
    assert ec.edge_conv_eval.tc_launches == before + 2
    assert torch.equal(got, again)
    want = ec.edge_conv_eval_amp_plain(x, x, *args, k)
    assert _ulp_rows(got, want) >= 0.999
    assert _ulp_rows(old, want) >= 0.999


# (B, N, Cg, bf16 graph, k): DGCNNSemSeg's and DGCNNPartSeg's blocks
BLOCK_CASES = [(2, 4096, 3, False, 20), (2, 4096, 64, True, 20),
               (2, 2048, 3, False, 40), (2, 2048, 64, True, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_knn_edge2_amp_tensor_core_on_cuda(case, cuda_device):
    b, n, cg, bf, k = case
    rng = np.random.default_rng(n + cg)
    g, args = _block(rng, b, n, cg, bf)
    g, args = g.to(cuda_device), [a.to(cuda_device) for a in args]
    before = e2.knn_edge2.tc_launches
    got = e2.knn_edge2(g, *args, k, amp=True)
    again = e2.knn_edge2(g, *args, k, amp=True)
    assert e2.knn_edge2.tc_launches == before + 2
    assert torch.equal(got, again)
    want = e2.knn_edge2_amp_plain(g, *args, k)
    assert _ulp_rows(got, want) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("cg,bf,k,repeat", [(3, False, 20, 32),
                                            (64, True, 40, 32),
                                            (9, False, 20, 1)])
def test_class_lists_on_cuda(cg, bf, k, repeat, cuda_device):
    """The sorting network's lists bit-equal to the insertions', every class
    recounted by the consumers' second scoring."""
    g = torch.Generator().manual_seed(cg)
    x = torch.randint(-3, 4, (2, 2048 // repeat, cg), generator=g).float()
    if repeat == 1:
        x = torch.randn((2, 2048, cg), generator=g)
    x = x.repeat(1, repeat, 1).to(torch.bfloat16 if bf else torch.float32)
    x = x.to(cuda_device).contiguous()
    got = ec.class_lists(x, k)
    ser = ec.class_lists(x, k, serial=True)
    for key in ("values", "counts", "lows"):
        assert torch.equal(got[key], ser[key])
    present = got["counts"] > 0
    assert torch.equal(got["recount"], got["counts"])
    assert torch.equal(got["relow"][present], got["lows"][present])
