"""The tensor-core redesigns of kernel 15's AMP form
(``csrc/attention_bwd_wgmma.cu``: wgmma and TMA, two element passes) and of
kernel 3's and 4's AMP scores (``csrc/knn_reduce.cu``: bf16 ``mma.sync``
over the hi / lo operands in both of the selection's passes).

On the CPU: the Python route decisions, made from the shape before any
launch (``attention.amp_bwd_route``, ``knn_reduce_kernel.amp_route``), the
scratch sizes the wrappers hand the kernels, that CPU tensors take the
plain versions whatever the route keywords ask (``earlier``, ``simt``,
``rowwarp``), and Delta of the plain backward as the sum over the
rebuilt p.

The ``cuda``-marked tests (no JAX; they skip without a card) hold the new
forms on the card as ``chip_smoke.py``'s phases 87 and 89 do: kernel 15's
dq, dk and dv within one bf16 ulp of the row's rms of the plain version
on >= 99.9% of rows and every value within one step, Delta the earlier
form's bits, the same bits over two calls, d = 512 on the earlier form;
kernel 3's and 4's idx rows equal to the plain version's on >= 95% of
rows, max and min on those rows bit-equal, the same bits over two calls,
and the earlier form (``simt=True``) beside them.
"""
import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.ops import attention as attn
from dgcnn_tpu_torch.ops import knn_reduce_kernel as kr
from dgcnn_tpu_torch.ops.amp_select import round_bf16


@pytest.mark.parametrize("d,route", [(128, "wgmma"), (256, "wgmma"),
                                     (512, "mma"), (64, "none"),
                                     (384, "none")])
def test_attention_bwd_route(d, route):
    assert attn.amp_bwd_route(d) == route


@pytest.mark.parametrize("k,n,co,cg,route", [
    (20, 1024, 64, 3, "tensor"),      # DGCNNCls
    (20, 1024, 256, 128, "tensor"),   # its stage 4 (Co = 256)
    (20, 4096, 64, 9, "tensor"),      # DGCNNSemSeg
    (40, 2048, 64, 64, "tensor"),     # DGCNNPartSeg
    (32, 2048, 64, 64, "tensor"),     # the fusion Net
    (20, 32768, 64, 3, "tensor"),     # the largest cloud
    (64, 256, 8, 1, "tensor"),        # the longest tiled list
    (20, 1024, 64, 129, "simt"),      # wider than the v2 grid's rows hold
    (65, 256, 8, 3, "rowwarp"),
    (80, 2048, 64, 64, "rowwarp"),
    (20, 1000, 64, 3, "none"),        # N not a multiple of 128
    (20, 65536, 64, 3, "none"),       # N above MAX_N
    (20, 1024, 257, 3, "none"),       # Co above MAX_CO
    (300, 256, 8, 3, "none"),         # k above N
])
def test_knn_reduce_amp_route(k, n, co, cg, route):
    assert kr.amp_route(k, n, co, cg) == route


@pytest.mark.parametrize("cg,floats", [(1, 8), (2, 8), (3, 9), (9, 27),
                                       (64, 192), (128, 384)])
def test_amp_operand_floats(cg, floats):
    """Each score operand's scratch a point: 3 Cg f32, or Kp = 3 Cg padded
    to 16 bf16 channels where that is more (Cg = 1, 2)."""
    assert kr.amp_operand_floats(cg) == floats
    assert 4 * floats >= 2 * ((3 * cg + 15) // 16 * 16)


@pytest.mark.parametrize("b,h,nq,nk", [(64, 2, 2048, 2048), (2, 2, 300, 200),
                                       (1, 1, 1, 1)])
def test_attention_bwd_scratch_bytes(b, h, nq, nk):
    """Over Nq to 128 rows: each row's record (16 bytes), its keep bits
    over Nk to 64 keys, its bf16 dS^T column: 1 GiB and 64 MB of bits at
    the Net's call."""
    nqa, nkp = -(-nq // 128) * 128, -(-nk // 64) * 64
    want = b * h * (nqa * 16 + nqa * nkp // 8 + nkp * nqa * 2)
    assert attn._bwd_wgmma_scratch_bytes(b, h, nq, nk) == want
    assert want % 16 == 0


def _bf16(shape, rng):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


@pytest.mark.parametrize("keywords", [{}, {"earlier": True}])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_attention_bwd_cpu_takes_the_plain_version(keywords, rate):
    rng = np.random.default_rng(2)
    q, k, v, do = (_bf16((1, 2, 40, 128), rng) for _ in range(4))
    seed = torch.tensor([3], dtype=torch.int64)
    sc = 128 ** -0.5
    _, m, l = attn.attention_amp_train_plain(q, k, v, sc, rate, seed)
    got = attn._attention_bwd_amp(q, k, v, m, l, seed, do, sc, rate,
                                  **keywords)
    want = attn._attention_amp_bwd_plain(q, k, v, m, l, seed, do, sc, rate)
    assert len(got) == 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    three = attn.attention_bwd_amp(q, k, v, m, l, seed, do, sc, rate,
                                   **keywords)
    assert len(three) == 3 and all(torch.equal(a, b)
                                   for a, b in zip(three, want))
    plain = attn.attention_amp_bwd_plain(q, k, v, m, l, seed, do, sc, rate)
    assert len(plain) == 3 and all(torch.equal(a, b)
                                   for a, b in zip(plain, want))


def test_plain_delta_is_the_sum_over_the_rebuilt_p():
    """Delta_i = sum_j dp_ij p_ij over the f32 p rebuilt from (m, l), the
    dropped entries' dp zero and the kept ones' scaled: in f64 from the
    same bf16 inputs and mask, within f32 rounding of the row's terms."""
    rng = np.random.default_rng(4)
    q, k, v, do = (_bf16((1, 1, 24, 128), rng) for _ in range(4))
    seed = torch.tensor([11], dtype=torch.int64)
    sc, rate = 128 ** -0.5, 0.5
    _, m, l = attn.attention_amp_train_plain(q, k, v, sc, rate, seed)
    delta = attn._attention_amp_bwd_plain(q, k, v, m, l, seed, do, sc,
                                          rate)[3]
    keep = attn.dropout_mask_plain((1, 1, 24, 24), seed, rate).double()
    s = q.double() @ k.double().transpose(2, 3) * sc
    p = torch.exp(s - m.double()[..., None]) / l.double()[..., None]
    dp = keep * (do.double() @ v.double().transpose(2, 3)) / (1 - rate)
    want = (dp * p).sum(-1)
    terms = (dp * p).abs().sum(-1)
    assert ((delta.double() - want).abs() <= 1e-5 * terms + 1e-30).all()


@pytest.mark.parametrize("keywords", [{}, {"simt": True},
                                      {"rowwarp": True}])
def test_knn_reduce_amp_cpu_takes_the_plain_version(keywords):
    rng = np.random.default_rng(5)
    graph = torch.from_numpy(rng.standard_normal((2, 256, 3))
                             .astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((2, 256, 16))
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 256, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    got = kr.knn_reduce(graph, a, 20, amp=True, **keywords)
    want = kr.knn_reduce_amp_plain(graph, a, 20)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    got = kr.knn_reduce_xw(graph, x, w, 20, amp=True, **keywords)
    want = kr.knn_reduce_xw_amp_plain(graph, x, w, 20)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rms_ulp_rows(got, want) -> float:
    """The share of rows whose values all lie within one bf16 ulp of
    ``want``'s, the ulp of the larger of |value| and the row's rms."""
    w = want.float()
    mag = torch.maximum(w.abs(), w.square().mean(-1, keepdim=True).sqrt())
    ulps = (got.float() - w).abs() / torch.exp2(torch.floor(torch.log2(mag))
                                                - 7)
    return (ulps.amax(-1) <= 1).float().mean().item()


def _largest_steps(got, want) -> float:
    """The largest distance in bf16 steps: one ulp of the value, floored at
    2^-8 of its row's norm."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
    floor = 2.0 ** -8 * w.norm(dim=-1, keepdim=True)
    return ((got.float() - w).abs() / torch.maximum(ulp, floor)).max().item()


def _heads(b, h, n, d, dev, g):
    x = torch.randn((b, n, h * d), generator=g).to(torch.bfloat16).to(dev)
    return x.view(b, n, h, d).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", [(2, 2, 2048, 2048, 256),
                                  (2, 4, 2048, 2048, 128),
                                  (2, 2, 300, 200, 256),
                                  (2, 2, 300, 200, 128)])
def test_attention_bwd_wgmma_on_cuda(case, rate, cuda_device):
    b, h, nq, nk, d = case
    g = torch.Generator().manual_seed(nq + d)
    q, do = (_heads(b, h, nq, d, cuda_device, g) for _ in range(2))
    k, v = (_heads(b, h, nk, d, cuda_device, g) for _ in range(2))
    seed = torch.tensor([9], dtype=torch.int64, device=cuda_device)
    sd, sc = (seed if rate else None), d ** -0.5
    _, m, l = attn.attention_fwd_amp(q, k, v, sc, rate, sd, True)
    before = attn.attention_bwd_amp.wgmma_launches
    got = attn._attention_bwd_amp(q, k, v, m, l, sd, do, sc, rate)
    again = attn._attention_bwd_amp(q, k, v, m, l, sd, do, sc, rate)
    old = attn._attention_bwd_amp(q, k, v, m, l, sd, do, sc, rate,
                                  earlier=True)
    want = attn.attention_amp_bwd_plain(q, k, v, m, l, sd, do, sc, rate)
    assert attn.attention_bwd_amp.wgmma_launches == before + 2
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    for a, w in zip(got[:3], want):
        assert _rms_ulp_rows(a, w) >= 0.999
        assert _largest_steps(a, w) <= 1
    rel = (got[3] - old[3]).abs() / old[3].abs().clamp(min=1e-30)
    assert rel.max().item() <= 1e-6


@pytest.mark.cuda
def test_attention_bwd_d512_takes_the_earlier_form_on_cuda(cuda_device):
    g = torch.Generator().manual_seed(6)
    q, k, v, do = (_heads(1, 1, 256, 512, cuda_device, g) for _ in range(4))
    _, m, l = attn.attention_fwd_amp(q, k, v, 512 ** -0.5, with_stats=True)
    before = attn.attention_bwd_amp.wgmma_launches
    got = attn.attention_bwd_amp(q, k, v, m, l, None, do, 512 ** -0.5)
    assert attn.attention_bwd_amp.wgmma_launches == before
    want = attn.attention_amp_bwd_plain(q, k, v, m, l, None, do,
                                        512 ** -0.5)
    assert all(_rms_ulp_rows(a, w) >= 0.999 for a, w in zip(got, want))


# (B, N, Cg, Co, k): the DGCNNCls, DGCNNSemSeg, DGCNNPartSeg and Net
# training stages, Co = 256 and the largest cloud
KNN_CASES = [(4, 1024, 3, 64, 20), (4, 1024, 128, 256, 20),
             (2, 4096, 9, 64, 20), (2, 2048, 64, 64, 40),
             (4, 2048, 64, 64, 32), (1, 32768, 3, 64, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KNN_CASES)
def test_knn_reduce_tensor_core_scores_on_cuda(case, cuda_device):
    b, n, cg, co, k = case
    g = torch.Generator().manual_seed(n + cg)
    graph = torch.randn((b, n, cg), generator=g).to(cuda_device)
    a = torch.randn((b, n, co), generator=g).to(cuda_device)
    before = kr.knn_reduce.tc_launches
    got = kr.knn_reduce(graph, a, k, amp=True)
    again = kr.knn_reduce(graph, a, k, amp=True)
    old = kr.knn_reduce(graph, a, k, amp=True, simt=True)
    assert kr.knn_reduce.tc_launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = kr.knn_reduce_amp_plain(graph, a, k)
    for out in (got, old):
        same = (out[0] == want[0]).all(-1)
        assert same.float().mean().item() >= 0.95
        assert all(torch.equal(x[same], y[same])
                   for x, y in zip(out[1:3], want[1:3]))


@pytest.mark.cuda
def test_knn_reduce_xw_tensor_core_scores_on_cuda(cuda_device):
    g = torch.Generator().manual_seed(7)
    graph = torch.randn((4, 1024, 128), generator=g).to(cuda_device)
    x = torch.randn((4, 1024, 128), generator=g).to(cuda_device)
    w = (torch.randn((128, 256), generator=g) / 16).to(cuda_device)
    before = kr.knn_reduce_xw.tc_launches
    got = kr.knn_reduce_xw(graph, x, w, 20, amp=True)
    assert kr.knn_reduce_xw.tc_launches == before + 1
    rows = round_bf16(kr.xw_project(round_bf16(x), w))
    want = kr.knn_reduce_amp_plain(graph, rows, 20)
    same = (got[0] == want[0]).all(-1)
    assert same.float().mean().item() >= 0.95
    assert all(torch.equal(x_[same], y[same])
               for x_, y in zip(got[1:3], want[1:3]))
