"""The tensor-core routes of kernel 2's AMP form (``csrc/conv_pool_wgmma.cu``)
and kernel 14's AMP forms (``csrc/attention_fwd_wgmma.cu``): wgmma on
tiles that TMA streams into shared memory.

On the CPU: the Python route decisions, made from the shape before any
launch (``conv_pool_kernel.amp_route``, ``attention.amp_route``): which
shapes take the wgmma forms, which the earlier ones, and which raise; and
that CPU tensors take the plain versions whatever the route keywords ask.

The ``cuda``-marked tests (no JAX; they skip without a card) hold the new
forms on the card: kernel 2's at the models' shapes within rel 1e-5 of its
plain version (of each element's |value| plus the output's rms), the same
bits over two calls, beside the earlier form; kernel 14's m and l
bit-equal to the earlier form's (its score sequence and sums, from which
kernel 15 rebuilds p) at d = 128 and 256, ragged and on the heads view, o
within one bf16 ulp of the row's rms on >= 99.9% of rows (its P V runs
one chain into o), its training form at rate 0 the evaluation form's
bits, and d = 512 on the earlier form.
"""
import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.ops import attention as attn
from dgcnn_tpu_torch.ops.conv_pool_kernel import (
    amp_route,
    conv_pool,
    conv_pool_amp_plain,
)

# (B, N, input widths) of every model's conv_pool in AMP (E = 1024)
POOL_SHAPES = [(64, 1024, (64, 64, 128, 256)),   # DGCNNCls conv5
               (16, 4096, (192,)),               # DGCNNSemSeg conv6
               (16, 2048, (128,)),               # TransformNet conv3
               (16, 2048, (192,))]               # DGCNNPartSeg conv6


@pytest.mark.parametrize("widths", [s[2] for s in POOL_SHAPES]
                         + [(64,), (256,), (64, 64), (128, 64, 192, 64)])
def test_models_pool_shapes_take_wgmma(widths):
    assert amp_route(widths, 1024) == "wgmma"
    assert amp_route(widths, 512) == "wgmma"
    assert amp_route(widths, 1024, aligned=False) == "simt"


@pytest.mark.parametrize("widths,e,route", [
    ((60,), 1024, "simt"),          # not a whole 64-channel chunk
    ((64, 68), 1024, "simt"),
    ((32,), 1024, "simt"),
    ((64,), 1020, "simt"),          # E not a multiple of 8
    ((64,), 12, "simt"),
    ((3,), 1024, "none"),           # the AMP form takes multiples of 4
    ((64,), 1022, "none"),
    ((64,) * 5, 1024, "none"),      # at most four inputs
    ((256, 256, 192), 1024, "simt"),  # more of W than shared memory holds
    ((), 1024, "none"),
])
def test_other_pool_shapes_route(widths, e, route):
    assert amp_route(widths, e) == route


@pytest.mark.parametrize("keywords", [{}, {"simt": True}])
def test_pool_cpu_takes_the_plain_version(keywords):
    """CPU tensors take conv_pool_amp_plain whatever the route keywords."""
    rng = np.random.default_rng(0)
    xs = tuple(torch.from_numpy(rng.standard_normal((2, 256, c))
                                .astype(np.float32)).to(torch.bfloat16)
               for c in (64, 128))
    w = torch.from_numpy(rng.standard_normal((192, 64)).astype(np.float32))
    s, t = torch.ones(64), torch.zeros(64)
    got = conv_pool(xs, w, s, t, amp=True, **keywords)
    assert torch.equal(got, conv_pool_amp_plain(xs, w, s, t))


@pytest.mark.parametrize("d,route", [(128, "wgmma"), (256, "wgmma"),
                                     (512, "mma"), (64, "none"),
                                     (384, "none")])
def test_attention_amp_route(d, route):
    assert attn.amp_route(d) == route


@pytest.mark.parametrize("earlier", [False, True])
def test_attention_amp_cpu_takes_the_plain_version(earlier):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 128))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    o, m, l = attn.attention_fwd_amp(q, k, v, 128 ** -0.5, earlier=earlier)
    assert m is None and l is None
    assert torch.equal(o, attn.attention_amp_plain(q, k, v, 128 ** -0.5))


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool_inputs(b, n, widths, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    xs = tuple(torch.randn((b, n, c), generator=g).to(torch.bfloat16)
               .to(dev) for c in widths)
    c = sum(widths)
    w = (torch.randn((c, 1024), generator=g) / c ** 0.5).to(dev)
    sign = torch.where(torch.rand(1024, generator=g) < 0.2, -1.0, 1.0)
    s = (sign * (0.5 + torch.rand(1024, generator=g))).to(dev)
    t = (0.1 * torch.randn(1024, generator=g)).to(dev)
    return xs, w, s, t


@pytest.mark.cuda
@pytest.mark.parametrize("shape", POOL_SHAPES + [(64, 1000,
                                                  (64, 64, 128, 256))])
def test_pool_wgmma_matches_plain_on_cuda(shape, cuda_device):
    b, n, widths = shape
    xs, w, s, t = _pool_inputs(b, n, widths, cuda_device)
    mean = len(widths) > 1
    before = conv_pool.wgmma_launches
    got = conv_pool(xs, w, s, t, with_mean=mean, amp=True)
    again = conv_pool(xs, w, s, t, with_mean=mean, amp=True)
    earlier = conv_pool(xs, w, s, t, with_mean=mean, amp=True, simt=True)
    want = conv_pool_amp_plain(xs, w, s, t, with_mean=mean)
    assert conv_pool.wgmma_launches == before + 2
    scale = want.pow(2).mean().sqrt()
    for out in (got, earlier):
        assert ((out - want).abs() <= 1e-5 * (want.abs() + scale)).all()
    assert torch.equal(got, again)


def _ulp_rows(got, want) -> float:
    """The share of rows whose values all lie within one bf16 ulp of
    ``want``'s, the ulp of the larger of |value| and the row's rms."""
    w = want.float()
    mag = torch.maximum(w.abs(), w.square().mean(-1, keepdim=True).sqrt())
    ulps = (got.float() - w).abs() / torch.exp2(torch.floor(torch.log2(mag))
                                                - 7)
    return (ulps.amax(-1) <= 1).float().mean().item()


def _heads(b, h, n, d, dev, g):
    x = torch.randn((b, n, h * d), generator=g).to(torch.bfloat16).to(dev)
    return x.view(b, n, h, d).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("case", [(2, 2, 2048, 2048, 256),
                                  (2, 4, 2048, 2048, 128),
                                  (2, 2, 300, 333, 256),
                                  (3, 2, 1000, 1000, 128)])
def test_attention_wgmma_against_the_earlier_form_on_cuda(case, rate,
                                                           cuda_device):
    b, h, nq, nk, d = case
    g = torch.Generator().manual_seed(nq + d)
    q = _heads(b, h, nq, d, cuda_device, g)
    k, v = (_heads(b, h, nk, d, cuda_device, g) for _ in range(2))
    seed = torch.tensor([7], dtype=torch.int64, device=cuda_device)
    before = attn.fused_attention.wgmma_launches
    new = attn.attention_fwd_amp(q, k, v, d ** -0.5, rate, seed,
                                 with_stats=True)
    old = attn.attention_fwd_amp(q, k, v, d ** -0.5, rate, seed,
                                 with_stats=True, earlier=True)
    assert attn.fused_attention.wgmma_launches == before + 1
    assert torch.equal(new[1], old[1]) and torch.equal(new[2], old[2])
    assert _ulp_rows(new[0], old[0]) >= 0.999
    if rate == 0.0:
        assert torch.equal(attn.attention_fwd_amp(q, k, v, d ** -0.5)[0],
                           new[0])


@pytest.mark.cuda
def test_attention_d512_takes_the_earlier_form_on_cuda(cuda_device):
    g = torch.Generator().manual_seed(5)
    q, k, v = (_heads(1, 1, 256, 512, cuda_device, g) for _ in range(3))
    before = attn.fused_attention.wgmma_launches
    o = attn.attention_fwd_amp(q, k, v, 512 ** -0.5)[0]
    assert attn.fused_attention.wgmma_launches == before
    want = attn.attention_amp_plain(q, k, v, 512 ** -0.5)
    assert _ulp_rows(o, want) >= 0.999
