"""A/B timing of kernel 3 (``dg_knn_reduce``), kernel 8
(``dg_edge2_bwd``), kernel 1 (``dg_edge_conv_eval``), kernel 6
(``dg_knn_edge2``), kernel 5 (``dg_edge_reduce_bwd``), kernel 7
(``dg_edge2_fwd``), kernel 11 (``dg_knn_idx``), kernel 12
(``dg_banded_edge_conv_eval``), kernel 13 (``dg_banded_knn_edge2``),
kernel 10 (``dg_knn_sum``) or kernel 9 (``dg_edge_sum``) against its
earlier form on one card (the row-warp form; kernel 9's: one thread an
output).  (Kernel 2's A/B is ``tools/pool_ab.py``.)

Builds the kernel's source (``csrc/knn_reduce.cu``, ``csrc/edge2_bwd.cu``,
``csrc/edge_conv_eval.cu``, ``csrc/knn_edge2.cu``,
``csrc/edge_reduce_bwd.cu``, ``csrc/edge2_reduce.cu``,
``csrc/knn_idx.cu``, ``csrc/knn_sum.cu`` or ``csrc/edge_sum.cu``) into a
library of
its own, and for kernels 3, 8, 5 and 7 their earlier form
(``tools/reduce_forms/*_rowwarp.cu``) into another (one ``nvcc`` a form,
all started together; the kNN forms link ``csrc/edge_conv_eval.cu`` and
``csrc/project.cu`` for the squared norms and the projection).  Kernel 5
also builds a probe, ``tools/reduce_forms/edge_reduce_bwd_store.cu``: the
earlier form with its global atomicAdd replaced by a plain store (its da
is wrong and is not held to anything), which shows what the atomics cost.  Kernels 1,
6, 12 and 13 keep their row-warp form in ``csrc/`` for k > 64: the banded
entries' row-warp route (``dg_banded_edge_conv_eval_rowwarp`` /
``dg_banded_knn_edge2_rowwarp``) is the row-warp side of their A/B, for
kernels 1 and 6 at band = N, tile 128 and window starts 0, which is that
form over the whole cloud.  Kernel 11 keeps its row-warp form as its k >
64 route, and the row-warp side of its A/B is the same library's
``dg_knn_idx_rowwarp`` (that route at any k; the kernel links
``csrc/edge_conv_eval.cu`` and ``csrc/project.cu`` for the squared norms).
So do kernel 10 (``dg_knn_sum_rowwarp``, linked as kernel 11) and kernel 9,
whose earlier form is its route for wide rows and long lists
(``dg_edge_sum_per_output``, one thread an output, at any shape).
Then times the forms at every cell's shapes in the order a b b a, as
device times (calls queued behind a sleep of the card,
``project_ab.device_ms``), and holds them to each other:

- ``--kernel knn_reduce``: B=32 at the DGCNNCls stages (N=1024, k=20, Cg
  3 / 64 / 64 / 128, Co 64 / 64 / 128 / 256), DGCNNSemSeg (N=4096, k=20),
  DGCNNPartSeg (N=2048, k=40) and the fusion Net (N=2048, k=32), Cg 3 / 64
  / 64 at Co 64; idx, amax, amin, asum and asumsq bit-equal between the
  forms, and at k = 65 (the row-warp route of both) too.
- ``--kernel edge2_bwd``: B=32, C1 = C2 = 64 at the semseg (N=4096, k=20)
  and partseg (N=2048, k=40) shapes, amax/amin from ``edge2_fwd``; db1
  bit-equal between the forms (and on an integer case whose z2 ties, so
  that the tie counts enter it); dW2, ds1 and dt1 within rel 1e-5 of the
  earlier form's and the same bits over two calls; da1 within rel 1e-5 of
  each row's norm.  The form "kernel" is the
  library's atomic da1 (``dg_edge2_bwd``), "pull" its pull route
  (``dg_edge2_bwd_pull``), whose da1 must also be the same bits over two
  calls.
- ``--kernel edge_conv_eval``: the eval stages of DGCNNCls (B=64,
  N=1024, k=20, (Cg, Cin -> Co) = (3, 3 -> 64), (64, 64 -> 64), (64, 64
  -> 128), (128, 128 -> 256)), the semseg and partseg conv5 (B=16, 64 ->
  64; N=4096 k=20 and N=2048 k=40) and the Net's four stages (B=16,
  N=2048, k=32); every output bit-equal between the forms, at k = 65 (the
  row-warp route of both) and on integer duplicate-points clouds whose
  k-th boundary falls inside ties too.
- ``--kernel knn_edge2``: the two-conv blocks of semseg (B=16, N=4096,
  k=20, Cg 3 and 64, C1 = C2 = 64), partseg (N=2048, k=40: the
  TransformNet's Cg=3 C1=64 C2=128 and the blocks at Cg 3 and 64) and the
  Net's TransformNet (N=2048, k=32, C2=128); bit-equal as kernel 1.
- ``--kernel edge_reduce_bwd``: B=32 at the DGCNNCls training stages
  (N=1024, k=20, Co 64 / 64 / 128 / 256 on kNN graphs of Cg 3 / 64 / 64 /
  128), semseg (N=4096, k=20, Co 64; three such calls a step), partseg
  (N=2048, k=40, Co 64; three a step) and the fusion Net's training stages
  (N=2048, k=32, Co as cls); the earlier forms and the probe take a zeroed
  da (the zeroing is timed with them, as the earlier wrapper paid it), the
  kernel writes every element; da within rel 1e-5 of each row's norm of
  the earlier form's, and exact against it and the plain version on
  integer duplicate points.  The form "kernel" is the library's slices
  route (``dg_edge_reduce_bwd``), "pull" its pull route
  (``dg_edge_reduce_bwd_pull``, the reverse lists built in each call),
  whose da must also be the same bits over two calls.
- ``--kernel edge2_fwd``: B=32, C1 = C2 = 64 at the semseg (N=4096, k=20)
  and partseg (N=2048, k=40) shapes, on the kernel's tiled route; C2 = 128
  and k = 129 (its row-warp route); and integer duplicate points whose
  k-th and (k+1)-th scores tie; all four outputs bit-equal between the
  forms.
- ``--kernel knn_idx``: C = 3 at the partseg TransformNet's graph (B=32,
  N=2048, k=40), the fusion Net training's (B=32, N=2048, k=32) and N =
  4096 (B=8, k=40), and k = 65 (the row-warp route of both); idx identical
  between the forms and over two calls, and on integer duplicate points
  whose k-th and (k+1)-th scores tie.
- ``--kernel knn_sum``: C = 3 and Ca = 9 (the HOG's centred clouds and
  their moments) at the fusion Net's eval (B=16) and training (B=32)
  graphs, N=2048, k=32; k = 40 (the tiled route's two-slot lists) and k =
  65 (the row-warp route of both); idx and the sums bit-equal between the
  forms and over two calls, and on integer duplicate points whose k-th and
  (k+1)-th scores tie.
- ``--kernel edge_sum``: the HOG's votes (Co = 18) over kernel 11's
  neighbours of a random cloud at the Net's eval (B=16) and training (B=32)
  shapes, N=2048, k=32; the generic instances at k = 40 and at Co = 9 (one
  channel a lane), Co = 80 (the earlier form on both sides), and repeated
  indices at k = 1, 32 and 40; the sums bit-equal between the forms and to
  ``edge_sum_plain``.
- ``--kernel banded_edge_conv_eval`` / ``banded_knn_edge2``: the banded
  eval stages (B=16) of partseg (N=2048, k=40, band 512) and semseg
  (N=4096, k=20, band 1024), kernel 12 at conv5 (64 -> 64), kernel 13 at
  the two blocks (Cg 3 and 64, C1 = C2 = 64), on clouds in their PC1
  order with the window starts of the models, and k = 65 (the row-warp
  route of both); every output bit-equal between the forms, on integer
  duplicate-points clouds whose k-th boundary falls inside ties within a
  window too.

``--root DIR`` builds the kernel's source from another checkout (its
``dgcnn_tpu_torch/csrc``), the earlier form from this one; ``--form
NAME=PATH`` adds another source of the same C entry, held and timed like
the kernel (the order is then a b c ... c b a).  Prints the
card's name and power limit, ptxas's registers and spills for each form,
one line a shape and form, and last one JSON object with every reading.
Exits non-zero without a CUDA card or when a check fails.

    python -m dgcnn_tpu_torch.tools.reduce_ab --kernel
        knn_reduce|edge2_bwd|edge_conv_eval|knn_edge2|edge_reduce_bwd|
        edge2_fwd|knn_idx|banded_edge_conv_eval|banded_knn_edge2|knn_sum|
        edge_sum [--root DIR] [--form NAME=PATH ...]
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import glob
import hashlib
import json
import os
import subprocess
import sys

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.tools.attention_ab import _ptxas_summary
from dgcnn_tpu_torch.tools.project_ab import device_ms

_HERE = os.path.dirname(os.path.abspath(__file__))
_FORMS_DIR = os.path.join(_HERE, "reduce_forms")
SOURCES = {"knn_reduce": "knn_reduce.cu", "edge2_bwd": "edge2_bwd.cu",
           "edge_conv_eval": "edge_conv_eval.cu", "knn_edge2": "knn_edge2.cu",
           "edge_reduce_bwd": "edge_reduce_bwd.cu",
           "edge2_fwd": "edge2_reduce.cu", "knn_idx": "knn_idx.cu",
           "banded_edge_conv_eval": "edge_conv_eval.cu",
           "banded_knn_edge2": "knn_edge2.cu", "knn_sum": "knn_sum.cu",
           "edge_sum": "edge_sum.cu"}
# the sources a form links: launch_sqnorm, dg_cuda_error_string and
# launch_project
HELPERS = {"knn_reduce": ("edge_conv_eval.cu", "project.cu"),
           "edge2_bwd": ("reverse_lists.cu",),
           "edge_conv_eval": ("project.cu",),
           "knn_edge2": ("edge_conv_eval.cu", "project.cu"),
           "edge_reduce_bwd": ("reverse_lists.cu",), "edge2_fwd": (),
           "knn_idx": ("edge_conv_eval.cu", "project.cu"),
           "banded_edge_conv_eval": ("project.cu",),
           "banded_knn_edge2": ("edge_conv_eval.cu", "project.cu"),
           "knn_sum": ("edge_conv_eval.cu", "project.cu"), "edge_sum": ()}
# probe forms built beside the earlier one (never on any path)
PROBES = {"edge_reduce_bwd": {"store": "edge_reduce_bwd_store.cu"}}
# the kernels whose earlier form is an entry of their own library: the
# row-warp route at any shape (for kernels 1 and 6 the banded entry's, at
# band = N), kernel 9's one thread an output
EARLIER_ENTRY = {"edge_conv_eval": "dg_banded_edge_conv_eval_rowwarp",
                 "knn_edge2": "dg_banded_knn_edge2_rowwarp",
                 "knn_idx": "dg_knn_idx_rowwarp",
                 "banded_edge_conv_eval": "dg_banded_edge_conv_eval_rowwarp",
                 "banded_knn_edge2": "dg_banded_knn_edge2_rowwarp",
                 "knn_sum": "dg_knn_sum_rowwarp",
                 "edge_sum": "dg_edge_sum_per_output"}
# the kernels whose library also holds their pull route (the kernel's own
# route, da / da1 without float atomics): a form of the A/B beside the
# library's entry (kernel 5: its slices route; kernel 8: its atomic da1)
PULL_ENTRY = {"edge_reduce_bwd": "dg_edge_reduce_bwd_pull",
              "edge2_bwd": "dg_edge2_bwd_pull"}
# ptxas lines worth printing: the kernel's own instances
PTXAS_KEYS = {"knn_reduce": ("reduce",),
              "edge2_bwd": ("bwd", "partial", "pull"),
              "edge_conv_eval": ("select_kernel", "edge_conv_eval"),
              "knn_edge2": ("knn_edge2",),
              "edge_reduce_bwd": ("edge_reduce_bwd",),
              "edge2_fwd": ("edge2_fwd",), "knn_idx": ("knn_idx",),
              "banded_edge_conv_eval": ("select_kernel", "edge_conv_eval"),
              "banded_knn_edge2": ("knn_edge2",), "knn_sum": ("knn_sum",),
              "edge_sum": ("edge_sum",)}
TB = 32
# (cell, N, k, [(Cg, Co), ...])
KNN_SHAPES = [
    ("cls", 1024, 20, [(3, 64), (64, 64), (64, 128), (128, 256)]),
    ("seg", 4096, 20, [(3, 64), (64, 64), (64, 64)]),
    ("part", 2048, 40, [(3, 64), (64, 64), (64, 64)]),
    ("net", 2048, 32, [(3, 64), (64, 64), (64, 64)]),
    ("row-warp route k=65", 1024, 65, [(64, 64)]),
]
# (cell, N, k)
EDGE2_SHAPES = [("seg", 4096, 20), ("part", 2048, 40)]
# (cell, B, N, k, [(Cg, Cin, Co), ...]): kernel 1 at the eval cells' stages
EVAL_STAGES = [(3, 3, 64), (64, 64, 64), (64, 64, 128), (128, 128, 256)]
EDGE_CONV_SHAPES = [
    ("cls", 64, 1024, 20, EVAL_STAGES),
    ("seg conv5", 16, 4096, 20, [(64, 64, 64)]),
    ("part conv5", 16, 2048, 40, [(64, 64, 64)]),
    ("net", 16, 2048, 32, EVAL_STAGES),
    ("row-warp route k=65", 4, 1024, 65, [(64, 64, 64)]),
]
# (cell, B, N, k, [(Cg, C1, C2), ...]): kernel 6 at the eval cells' blocks
KNN_EDGE2_SHAPES = [
    ("seg", 16, 4096, 20, [(3, 64, 64), (64, 64, 64)]),
    ("part", 16, 2048, 40, [(3, 64, 128), (3, 64, 64), (64, 64, 64)]),
    ("net TransformNet", 16, 2048, 32, [(3, 64, 128)]),
    ("row-warp route k=65", 4, 1024, 65, [(64, 64, 64)]),
]
# (cell, N, k, [(Cg, Co), ...]): kernel 5 at the training cells' stages
CLS_STAGES = [(3, 64), (64, 64), (64, 128), (128, 256)]
BWD_SHAPES = [
    ("cls", 1024, 20, CLS_STAGES),
    ("seg", 4096, 20, [(64, 64)]),
    ("part", 2048, 40, [(64, 64)]),
    ("net train", 2048, 32, CLS_STAGES),
]
# (cell, N, k, C2): kernel 7 at the semseg and partseg training shapes
# (C1 = C2 = 64, the tiled route) and outside its tiled route
FWD_SHAPES = [("seg", 4096, 20, 64), ("part", 2048, 40, 64),
              ("row-warp route C2=128", 1024, 20, 128),
              ("row-warp route k=129", 1024, 129, 64)]
# (cell, B, N, k): kernel 11 at the TransformNets' graphs (C = 3)
KNN_IDX_SHAPES = [("part", TB, 2048, 40), ("net train", TB, 2048, 32),
                  ("N=4096", 8, 4096, 40), ("row-warp route k=65", TB, 1024,
                                             65)]
# (cell, B, N, k): kernel 10 at the HOG's graphs (C = 3, Ca = 9)
KNN_SUM_SHAPES = [("net eval", 16, 2048, 32), ("net train", TB, 2048, 32),
                  ("two-slot lists k=40", 16, 2048, 40),
                  ("row-warp route k=65", 16, 2048, 65)]
# (cell, B, N, Co, k): kernel 9 at the HOG's votes (Co = 18) and beside
EDGE_SUM_SHAPES = [("net eval", 16, 2048, 18, 32),
                   ("net train", TB, 2048, 18, 32),
                   ("generic k=40", 16, 2048, 18, 40),
                   ("one channel a lane Co=9", 16, 2048, 9, 32),
                   ("earlier form Co=80", 4, 2048, 80, 32)]
# (cell, B, N, k, band, [dims, ...]): kernels 12 and 13 at the banded eval
# stages (dims as kernels 1 and 6 take them)
BANDED_SHAPES = {
    "banded_edge_conv_eval": [
        ("part conv5", 16, 2048, 40, 512, [(64, 64, 64)]),
        ("seg conv5", 16, 4096, 20, 1024, [(64, 64, 64)]),
        ("row-warp route k=65", 4, 1024, 65, 256, [(64, 64, 64)])],
    "banded_knn_edge2": [
        ("part", 16, 2048, 40, 512, [(3, 64, 64), (64, 64, 64)]),
        ("seg", 16, 4096, 20, 1024, [(3, 64, 64), (64, 64, 64)]),
        ("row-warp route k=65", 4, 1024, 65, 256, [(64, 64, 64)])],
}


def build(kernel: str, root: str,
          extra: dict[str, str]) -> dict[str, tuple[str, list[str]]]:
    """Compiles the kernel, its earlier form and the ``extra`` sources into
    ``build/reduce_ab/``; returns each form's library path and ptxas's
    lines."""
    csrc = os.path.join(root, "dgcnn_tpu_torch", "csrc")
    forms = {"kernel": os.path.join(csrc, SOURCES[kernel])}
    if kernel not in EARLIER_ENTRY:
        forms["earlier"] = os.path.join(
            _FORMS_DIR, SOURCES[kernel][:-3] + "_rowwarp.cu")
    forms.update({name: os.path.join(_FORMS_DIR, src)
                  for name, src in PROBES.get(kernel, {}).items()})
    forms.update(extra)
    helpers = [os.path.join(_build.CSRC, h) for h in HELPERS[kernel]]
    out_dir = os.path.join(_build.BUILD_DIR, "reduce_ab")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, src in forms.items():
        inc = (_build.CSRC if os.path.dirname(src) == _FORMS_DIR
               else os.path.dirname(src))
        h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
        for path in [src] + helpers + sorted(
                glob.glob(os.path.join(inc, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        lib = os.path.join(out_dir, f"{kernel}_{name}_{h.hexdigest()[:16]}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", inc, "-I", _build.CSRC,
             "-shared", src, *helpers, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {forms[name]}:\n{log}")
        built[name] = (lib, [ln for ln in _ptxas_summary(log)
                             if any(key in ln for key in PTXAS_KEYS[kernel])])
    if kernel in EARLIER_ENTRY:  # the row-warp form: the kernel library's
        built = {"kernel": built["kernel"], "earlier": built["kernel"],
                 **{n: f for n, f in built.items() if n != "kernel"}}
    if kernel in PULL_ENTRY and hasattr(ctypes.CDLL(built["kernel"][0]),
                                        PULL_ENTRY[kernel]):
        built["pull"] = built["kernel"]
    return built


def _entry(lib: str, kernel: str, name: str):
    """The form's C entry of the kernel and, for kernel 8, its tile count
    (None where the form has none).  The row-warp form of kernels 1, 6, 12
    and 13 is their banded entry's row-warp route, that of kernel 11 its
    row-warp route."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll = ctypes.CDLL(lib)
    if kernel in ("knn_idx", "knn_sum", "edge_sum"):
        fn = getattr(dll, EARLIER_ENTRY[kernel] if name == "earlier" else
                     "dg_" + kernel)
        nptr, nint = (5, 5) if kernel == "knn_sum" else (3, 4)
        fn.argtypes = [p] * nptr + [i] * nint + [p]
        fn.restype = i
        return fn, None
    if kernel in EARLIER_ENTRY:
        banded = name == "earlier" or kernel.startswith("banded_")
        fn = getattr(dll, EARLIER_ENTRY[kernel] if name == "earlier" else
                     "dg_" + kernel)
        nptr = 8 if kernel.endswith("edge_conv_eval") else 10
        fn.argtypes = [p] * (nptr + banded) + [i] * (6 + 2 * banded) + [f, p]
        fn.restype = i
        return fn, None
    tiles = None
    if kernel == "knn_reduce":
        fn = dll.dg_knn_reduce
        fn.argtypes = [p] * 8 + [i] * 5 + [p]
    elif kernel == "edge_reduce_bwd":
        pull = name == "pull"
        fn = getattr(dll, PULL_ENTRY[kernel] if pull else
                     "dg_edge_reduce_bwd")
        fn.argtypes = [p] * (11 if pull else 9) + [i] * 4 + [p]
    elif kernel == "edge2_fwd":
        fn = dll.dg_edge2_fwd
        fn.argtypes = [p] * 10 + [i] * 5 + [f, p]
    else:
        pull = name == "pull"
        fn = getattr(dll, PULL_ENTRY[kernel] if pull else "dg_edge2_bwd")
        fn.argtypes = [p] * (18 if pull else 16) + [i] * 6 + [f, p]
        tiles = getattr(dll, "dg_edge2_bwd_tiles", None)
        if tiles is not None:
            tiles.argtypes = [i] * 5
            tiles.restype = i
    fn.restype = i
    return fn, tiles


def _call(fn, *args) -> None:
    rc = fn(*args)
    if rc:
        raise RuntimeError(f"CUDA error {rc}")


def run_knn(entries: dict, result: dict, order: list[str]) -> list[str]:
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = _build.ptr
    bad = []
    for cell, n, k, stages in KNN_SHAPES:
        for cg, co in stages:
            graph = torch.randn((TB, n, cg), generator=g).to(dev)
            a = torch.randn((TB, n, co), generator=g).to(dev)
            outs = {}
            for name in order:
                idx = torch.empty((TB, n, k), device=dev, dtype=torch.int32)
                red = [torch.empty((TB, n, co), device=dev) for _ in range(4)]
                sq = torch.empty((TB * n,), device=dev)
                fn = entries[name][0]
                stream = _build.stream_of(graph)
                args = (p(graph), p(a), p(sq), p(idx), *map(p, red), TB, n,
                        cg, co, k, stream)
                ms = device_ms(lambda: _call(fn, *args), reps=5, rounds=5)
                outs[name] = (idx, *red)
                key = f"{cell} N={n} k={k} Cg={cg} Co={co}"
                result["forms"][name]["ms"].setdefault(key, []).append(ms)
                print(f"{name} {key} ms {ms:.4f}", flush=True)
            same = all(torch.equal(x, y) for name in outs
                       for x, y in zip(outs[name], outs["earlier"]))
            result["checks"].append({"shape": key, "bit_equal": same})
            print(f"{key}: idx and reductions bit-equal {same}", flush=True)
            if not same:
                bad.append(key)
            del graph, a, outs
            torch.cuda.empty_cache()
    return bad


def _edge2_inputs(g, n: int, k: int, dev, integer: bool = False):
    from dgcnn_tpu_torch.ops.edge2_reduce_kernel import edge2_fwd
    from dgcnn_tpu_torch.ops.knn import knn_plain

    b, c = (2, 64) if integer else (TB, 64)
    if integer:
        # small integers: z2 is exact, and duplicate points tie
        pts = torch.randint(0, 3, (b, n, 3), generator=g).float()
        idx = knn_plain(pts, k).int()
        a1 = torch.randint(-2, 3, (b, n, c), generator=g).float()
        b1 = torch.randint(-2, 3, (b, n, c), generator=g).float()
        s1 = torch.ones(c)
        t1 = torch.zeros(c)
        w2 = torch.randint(-1, 2, (c, c), generator=g).float()
    else:
        idx = torch.randint(0, n, (b, n, k), generator=g, dtype=torch.int32)
        a1, b1 = (torch.randn((b, n, c), generator=g) for _ in range(2))
        s1 = 1 + 0.1 * torch.randn(c, generator=g)
        t1 = 0.1 * torch.randn(c, generator=g)
        w2 = torch.randn((c, c), generator=g) / 8
    tin = [t.to(dev).contiguous() for t in (a1, b1, s1, t1, w2)]
    idx = idx.to(dev).contiguous()
    amax, amin, _, _ = edge2_fwd(*tin, idx)
    cts = [torch.randn((b, n, c), generator=g).to(dev) for _ in range(4)]
    return tin, idx, [amax, amin, *cts]


def _list_ints(b: int, n: int, k: int) -> int:
    """The int32 scratch of the reverse lists (csrc/reverse_lists.cuh)."""
    return 2 * b * n + 1 + 2 * b * n * k


def _row_rel(got, want) -> float:
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30)).max().item()


def run_edge2(entries: dict, result: dict, order: list[str]) -> list[str]:
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = _build.ptr
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bad = []

    def launch(name, tin, idx, feats, n, k):
        fn, tiles_fn = entries[name]
        b = idx.shape[0]
        c1, c2 = tin[4].shape
        if tiles_fn is not None:
            tiles = tiles_fn(b, n, c1, c2, k)
            g_blocks = min(tiles, 2 * sms)
        else:  # the row-warp form's own rule
            g_blocks = min((b * n + 7) // 8, 4 * sms)
        width = c1 * c2 + 2 * c1
        part = torch.empty((g_blocks, width), device=dev)
        dflat = torch.empty((width,), device=dev)
        da1 = torch.zeros_like(tin[0])
        db1 = torch.empty_like(tin[0])
        scratch = []
        if name == "pull":  # each edge's addend and the reverse lists
            scratch = [torch.empty((b * n * k * c1,), device=dev),
                       torch.empty((_list_ints(b, n, k),), device=dev,
                                   dtype=torch.int32)]
        args = (p(idx), *map(p, tin), *map(p, feats), p(da1), p(db1),
                p(part), p(dflat), *map(p, scratch), b, n, c1, c2, k,
                g_blocks, 0.2, _build.stream_of(idx))

        def call(keep=(part, scratch)):  # alive as long as the call
            if name != "pull":  # the atomic forms add into a zeroed da1
                da1.zero_()
            _call(fn, *args)
        return call, da1, db1, dflat

    cases = [(cell, n, k, False) for cell, n, k in EDGE2_SHAPES]
    cases.append(("integer ties", 256, 20, True))
    for cell, n, k, integer in cases:
        tin, idx, feats = _edge2_inputs(g, n, k, dev, integer)
        outs, key = {}, f"{cell} N={n} k={k} C1=C2=64"
        for name in order:
            call, da1, db1, dflat = launch(name, tin, idx, feats, n, k)
            if not integer:
                ms = device_ms(call, reps=5, rounds=5)
                result["forms"][name]["ms"].setdefault(key, []).append(ms)
                print(f"{name} {key} ms {ms:.4f}", flush=True)
            call()
            first = dflat.clone(), da1.clone()
            call()
            torch.cuda.synchronize()
            outs[name] = (da1.clone(), db1.clone(), dflat.clone(),
                          torch.equal(first[0], dflat),
                          torch.equal(first[1], da1))
        old = outs["earlier"]
        for name, new in outs.items():
            if name == "earlier":
                continue
            dw_rel = ((new[2] - old[2]).norm() / old[2].norm()).item()
            check = {"shape": key, "form": name,
                     "db1_bit_equal": torch.equal(new[1], old[1]),
                     "dflat_rel": dw_rel,
                     "dflat_same_bits_over_calls": new[3],
                     "da1_row_rel": _row_rel(new[0], old[0]),
                     "da1_same_bits_over_calls": new[4]}
            result["checks"].append(check)
            print(f"{key}: {json.dumps(check)}", flush=True)
            if not (check["db1_bit_equal"] and dw_rel <= 1e-5 and new[3]
                    and check["da1_row_rel"] <= 1e-5
                    and (new[4] or name != "pull")):
                bad.append(f"{key} {name}")
        del tin, idx, feats, outs
        torch.cuda.empty_cache()
    return bad


def _eval_inputs(kernel: str, g, b: int, n: int, dims, integer=False):
    """The inputs of kernel 1 (dims = (Cg, Cin, Co); graph = x where Cg =
    Cin, as in the models) or kernel 6 (dims = (Cg, C1, C2)), the scratch
    shapes and the output shape.  ``integer``: small integers on a cloud
    of duplicate points, so that the k-th boundary falls inside ties."""
    def ints(*shape, lo=-2, hi=3):
        return torch.randint(lo, hi, shape, generator=g).float()

    if kernel == "edge_conv_eval":
        cg, cin, co = dims
        if integer:
            base = ints(b, 200, 3, lo=-4, hi=5)
            pick = torch.randint(0, 200, (b, n), generator=g)
            graph = torch.gather(base, 1, pick[..., None].expand(b, n, 3))
            x = ints(b, n, cin, lo=-3, hi=4)
            wcat = ints(cin, 2 * co)
            scale = torch.tensor([2.0, -1.0, 0.5, 1.0] * (co // 4))
            bias = ints(co)
        else:
            x = torch.randn((b, n, cin), generator=g)
            graph = x if cg == cin else torch.randn((b, n, cg), generator=g)
            wcat = torch.randn((cin, 2 * co), generator=g) / cin ** 0.5
            sign = torch.where(torch.rand(co, generator=g) < 0.2, -1.0, 1.0)
            scale = sign * (0.5 + torch.rand(co, generator=g))
            bias = 0.1 * torch.randn(co, generator=g)
        ins = [graph, x, wcat, scale, bias]
        return ins, [(b * n, 2 * co), (b * n,)], (b, n, co)
    cg, c1, c2 = dims
    if integer:
        graph, a1 = (torch.cat([ints(b, n // 4, c)] * 4, dim=1)
                     for c in (cg, c1))
        b1, w2 = ints(b, n, c1), ints(c1, c2, lo=-1, hi=2)
        s1 = torch.where(ints(c1) >= 0, 1.0, -0.5)
        s2 = torch.where(ints(c2) >= 0, 1.0, -1.0)
        t1, t2 = ints(c1), ints(c2)
    else:
        graph = torch.randn((b, n, cg), generator=g)
        a1, b1 = (torch.randn((b, n, c1), generator=g) for _ in range(2))
        w2 = torch.randn((c1, c2), generator=g) / c1 ** 0.5
        s1, s2 = (torch.where(torch.rand(c, generator=g) < 0.2, -1.0, 1.0)
                  * (0.5 + torch.rand(c, generator=g)) for c in (c1, c2))
        t1, t2 = (0.1 * torch.randn(c, generator=g) for c in (c1, c2))
    ins = [graph, a1, b1, w2, s1, t1, s2, t2]
    return ins, [(b * n,)], (b, n, c2)


def run_eval(kernel: str, entries: dict, result: dict,
             order: list[str]) -> list[str]:
    """Kernel 1 or 6: every form at every cell's shapes (timed), then on
    the integer duplicate-points cases; every output must be the row-warp
    form's bits."""
    from dgcnn_tpu_torch.ops.knn import pairwise_neg_sqdist

    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = _build.ptr
    shapes = (EDGE_CONV_SHAPES if kernel == "edge_conv_eval"
              else KNN_EDGE2_SHAPES)
    cases = [(f"{cell} B={b} N={n} k={k} dims={dims}", b, n, k, dims, False)
             for cell, b, n, k, stages in shapes for dims in stages]
    int_dims = ([(3, 8, 64)] if kernel == "edge_conv_eval"
                else [(3, 64, 128), (3, 64, 64)])
    cases += [(f"integer duplicates N={n} k={k} dims={dims}", 2, n, k, dims,
               True) for dims in int_dims for n, k in ((256, 40), (1024, 20))]
    bad = []
    for key, b, n, k, dims, integer in cases:
        slope = 0.25 if integer else 0.2
        ins, scratch_shapes, out_shape = _eval_inputs(kernel, g, b, n, dims,
                                                      integer)
        ins = [t.to(dev).contiguous() for t in ins]
        if integer:  # the case must put the k-th boundary inside ties
            top = pairwise_neg_sqdist(ins[0]).topk(k + 1, dim=-1).values
            ties = int((top[..., k - 1] == top[..., k]).sum())
            print(f"{key}: rows whose k-th neighbour ties the (k+1)-th "
                  f"{ties}", flush=True)
            if not ties:
                bad.append(f"{key}: no tie at the k-th boundary")
        starts = torch.zeros((n // 128,), device=dev, dtype=torch.int32)
        outs = {}
        for name in order:
            fn = entries[name][0]
            out = torch.empty(out_shape, device=dev)
            scratch = [torch.empty(sh, device=dev) for sh in scratch_shapes]
            ints_ = (b, n, dims[0], dims[1], dims[2], k)
            stream = _build.stream_of(out)
            if name == "earlier":  # band = N, tile 128, starts 0
                args = (*map(p, ins), p(starts), *map(p, scratch), p(out),
                        *ints_, 128, n, slope, stream)
            else:
                args = (*map(p, ins), *map(p, scratch), p(out), *ints_,
                        slope, stream)
            if integer:
                _call(fn, *args)
            else:
                ms = device_ms(lambda: _call(fn, *args), reps=5, rounds=5)
                result["forms"][name]["ms"].setdefault(key, []).append(ms)
                print(f"{name} {key} ms {ms:.4f}", flush=True)
            torch.cuda.synchronize()
            outs[name] = out
        same = all(torch.equal(out, outs["earlier"]) for out in outs.values())
        finite = bool(torch.isfinite(outs["earlier"]).all())
        result["checks"].append({"shape": key, "bit_equal": same,
                                 "finite": finite})
        print(f"{key}: outputs bit-equal {same}, finite {finite}",
              flush=True)
        if not (same and finite):
            bad.append(key)
        del ins, outs
        torch.cuda.empty_cache()
    return bad


def run_banded(kernel: str, entries: dict, result: dict,
               order: list[str]) -> list[str]:
    """Kernel 12 or 13: every form at the banded eval stages (timed), on
    clouds sorted by their PC1 key with the models' window starts, then on
    integer duplicate-points clouds; every output must be the row-warp
    form's bits."""
    from dgcnn_tpu_torch.ops.banded import (
        band_tile,
        sort_rows,
        sorted_order,
        window_starts,
    )
    from dgcnn_tpu_torch.ops.knn import pairwise_neg_sqdist

    base = kernel.removeprefix("banded_")
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = _build.ptr
    cases = [(f"{cell} B={b} N={n} k={k} band {band} dims={dims}", b, n, k,
              band, dims, False)
             for cell, b, n, k, band, stages in BANDED_SHAPES[kernel]
             for dims in stages]
    int_dims = ([(3, 8, 64)] if base == "edge_conv_eval"
                else [(3, 64, 128), (3, 64, 64)])
    cases += [(f"integer duplicates N={n} k={k} band {band} dims={dims}", 2,
               n, k, band, dims, True) for dims in int_dims
              for n, k, band in ((1024, 20, 256), (2048, 40, 512))]
    bad = []
    for key, b, n, k, band, dims, integer in cases:
        slope = 0.25 if integer else 0.2
        ins, scratch_shapes, out_shape = _eval_inputs(base, g, b, n, dims,
                                                      integer)
        ins = [t.to(dev).contiguous() for t in ins]
        # the per-point inputs in the graph's PC1 order, as the wrapper
        # hands them to the kernel
        srt = sorted_order(ins[0])
        for i in ((0, 1) if base == "edge_conv_eval" else (0, 1, 2)):
            ins[i] = sort_rows(ins[i], srt).contiguous()
        tile = band_tile(n, band)
        starts = window_starts(n, tile, band, dev)
        if integer:  # the case must put the k-th boundary inside ties
            t, c = n // tile, ins[0].shape[2]
            cols = (starts.long()[:, None]
                    + torch.arange(band, device=dev)).reshape(-1)
            top = pairwise_neg_sqdist(
                ins[0].reshape(b * t, tile, c),
                ins[0][:, cols].reshape(b * t, band, c)).topk(
                    k + 1, dim=-1).values
            ties = int((top[..., k - 1] == top[..., k]).sum())
            print(f"{key}: rows whose k-th window score ties the (k+1)-th "
                  f"{ties}", flush=True)
            if not ties:
                bad.append(f"{key}: no tie at the k-th boundary")
        outs = {}
        for name in order:
            fn = entries[name][0]
            out = torch.empty(out_shape, device=dev)
            scratch = [torch.empty(sh, device=dev) for sh in scratch_shapes]
            args = (*map(p, ins), p(starts), *map(p, scratch), p(out), b, n,
                    *dims, k, tile, band, slope, _build.stream_of(out))
            if integer:
                _call(fn, *args)
            else:
                ms = device_ms(lambda: _call(fn, *args), reps=5, rounds=5)
                result["forms"][name]["ms"].setdefault(key, []).append(ms)
                print(f"{name} {key} ms {ms:.4f}", flush=True)
            torch.cuda.synchronize()
            outs[name] = out
        same = all(torch.equal(out, outs["earlier"]) for out in outs.values())
        finite = bool(torch.isfinite(outs["earlier"]).all())
        result["checks"].append({"shape": key, "bit_equal": same,
                                 "finite": finite})
        print(f"{key}: outputs bit-equal {same}, finite {finite}",
              flush=True)
        if not (same and finite):
            bad.append(key)
        del ins, outs
        torch.cuda.empty_cache()
    return bad


def _bwd_integer_case(g, dev):
    """Kernel 5's integer duplicate-points case (chip_smoke.py's phase 8):
    256 grid points four times, a a function of the point, max/min
    cotangents multiples of the lcm of the tie counts, so that every
    addend and every sum is exact."""
    import math

    from dgcnn_tpu_torch.ops.graph import gather_neighbors
    from dgcnn_tpu_torch.ops.knn_reduce_kernel import knn_reduce

    base = torch.randint(-4, 5, (2, 256, 3), generator=g).float()
    graph = torch.cat([base] * 4, dim=1).to(dev)
    a = torch.cat([torch.randint(-256, 257, (2, 256, 64),
                                 generator=g).float()] * 4, dim=1).to(dev)
    idx, amax, amin, _, _ = knn_reduce(graph, a, 20)
    ag = gather_neighbors(a, idx.long())
    ties = torch.cat([(ag == amax[:, :, None]).sum(2).flatten(),
                      (ag == amin[:, :, None]).sum(2).flatten()])
    lcm = math.lcm(*ties.unique().tolist())
    cts = [torch.randint(-3, 4, (2, 1024, 64), generator=g).float().to(dev)
           for _ in range(4)]
    cts[0] *= lcm
    cts[1] *= lcm
    return idx, a, amax, amin, cts


def run_bwd(entries: dict, result: dict, order: list[str]) -> list[str]:
    """Kernel 5: every form at every training cell's stages (timed), then
    the integer duplicate-points case; da within rel 1e-5 of each row's
    norm of the earlier form's, exact on the integers."""
    from dgcnn_tpu_torch.ops.edge_reduce_bwd_kernel import (
        edge_reduce_bwd_plain,
    )
    from dgcnn_tpu_torch.ops.knn_reduce_kernel import knn_reduce

    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = _build.ptr
    cases = [(f"{cell} N={n} k={k} Cg={cg} Co={co}", n, k, cg, co)
             for cell, n, k, stages in BWD_SHAPES for cg, co in stages]
    cases.append(("integer duplicates N=1024 k=20 Co=64", 1024, 20, 3, 64))
    bad = []
    for key, n, k, cg, co in cases:
        integer = key.startswith("integer")
        if integer:
            idx, a, amax, amin, cts = _bwd_integer_case(g, dev)
        else:
            graph = torch.randn((TB, n, cg), generator=g).to(dev)
            a = torch.randn((TB, n, co), generator=g).to(dev)
            idx, amax, amin, _, _ = knn_reduce(graph, a, k)
            cts = [torch.randn((TB, n, co), generator=g).to(dev)
                   for _ in range(4)]
            del graph
        b = a.shape[0]
        outs, same = {}, True
        for name in order:
            fn = entries[name][0]
            da = torch.empty_like(a)
            scratch = []
            if name == "pull":  # each edge's addend and the reverse lists
                scratch = [torch.empty((b * n * k * co,), device=dev),
                           torch.empty((_list_ints(b, n, k),), device=dev,
                                       dtype=torch.int32)]
            args = (p(idx), p(a), p(amax), p(amin), *map(p, cts), p(da),
                    *map(p, scratch), b, n, co, k, _build.stream_of(a))

            def call(fn=fn, args=args, da=da,
                     zero=name not in ("kernel", "pull")):
                if zero:  # the earlier forms add into a zeroed da
                    da.zero_()
                _call(fn, *args)
            if not integer:
                ms = device_ms(call, reps=5, rounds=5)
                result["forms"][name]["ms"].setdefault(key, []).append(ms)
                print(f"{name} {key} ms {ms:.4f}", flush=True)
            call()
            torch.cuda.synchronize()
            if name == "pull":  # no float atomic: the same bits each call
                first = da.clone()
                call()
                torch.cuda.synchronize()
                same = same and torch.equal(first, da)
            outs[name] = da
        check = {"shape": key,
                 "da_row_rel": _row_rel(outs["kernel"], outs["earlier"])}
        if "pull" in outs:
            check["pull_da_row_rel"] = _row_rel(outs["pull"],
                                                outs["earlier"])
            check["pull_same_bits_over_calls"] = same
        if integer:
            want = edge_reduce_bwd_plain(idx, a, amax, amin, *cts)
            check["exact"] = all(torch.equal(outs[name], want)
                                 for name in outs if name != "store")
        ok = (check["da_row_rel"] <= 1e-5 and check.get("exact", True)
              and check.get("pull_da_row_rel", 0.0) <= 1e-5 and same)
        result["checks"].append(check)
        print(f"{key}: {json.dumps(check)}", flush=True)
        if not ok:
            bad.append(key)
        del idx, a, amax, amin, cts, outs
        torch.cuda.empty_cache()
    return bad


def _fwd_inputs(g, n: int, k: int, c2: int, dev, integer: bool = False):
    """Kernel 7's inputs [a1, b1, s1, t1, w2, idx], C1 = 64, and for the
    ``integer`` case (small integers on a cloud of 64 points each four
    times, so that every z2 is exact and z2 ties) the number of rows whose
    k-th score ties the (k+1)-th (else None)."""
    from dgcnn_tpu_torch.ops.knn import knn_plain, pairwise_neg_sqdist

    c1 = 64
    if integer:
        pts = torch.cat([torch.randint(-2, 3, (2, n // 4, 3),
                                       generator=g).float()] * 4, dim=1)
        idx = knn_plain(pts, k).int()
        top = pairwise_neg_sqdist(pts).topk(k + 1, dim=-1).values
        ties = int((top[..., k - 1] == top[..., k]).sum())
        a1 = torch.cat([torch.randint(-2, 3, (2, n // 4, c1),
                                      generator=g).float()] * 4, dim=1)
        b1 = torch.randint(-2, 3, (2, n, c1), generator=g).float()
        s1 = torch.where(torch.rand(c1, generator=g) < 0.3, -0.5, 1.0)
        t1 = torch.randint(-2, 3, (c1,), generator=g).float()
        w2 = torch.randint(-1, 2, (c1, c2), generator=g).float()
    else:
        idx = torch.randint(0, n, (TB, n, k), generator=g, dtype=torch.int32)
        a1, b1 = (torch.randn((TB, n, c1), generator=g) for _ in range(2))
        s1 = 1 + 0.1 * torch.randn(c1, generator=g)
        t1 = 0.1 * torch.randn(c1, generator=g)
        w2 = torch.randn((c1, c2), generator=g) / 8
        ties = None
    return [t.to(dev).contiguous() for t in (a1, b1, s1, t1, w2, idx)], ties


def run_fwd(entries: dict, result: dict, order: list[str]) -> list[str]:
    """Kernel 7: every form at the semseg and partseg training shapes and
    outside the tiled route (timed), then on integer duplicate points;
    all four outputs bit-equal between the forms."""
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = _build.ptr
    cases = [(f"{cell} N={n} k={k} C1=64 C2={c2}", n, k, c2, False)
             for cell, n, k, c2 in FWD_SHAPES]
    cases += [(f"integer duplicates N=256 k={k} C1=C2=64", 256, k, 64, True)
              for k in (20, 40)]
    bad = []
    for key, n, k, c2, integer in cases:
        slope = 0.25 if integer else 0.2
        tin, ties = _fwd_inputs(g, n, k, c2, dev, integer)
        b = tin[0].shape[0]
        if integer:  # the case must put the k-th boundary inside ties
            print(f"{key}: rows whose k-th score ties the (k+1)-th {ties}",
                  flush=True)
            if not ties:
                bad.append(f"{key}: no tie at the k-th boundary")
        outs = {}
        for name in order:
            fn = entries[name][0]
            red = [torch.empty((b, n, c2), device=dev) for _ in range(4)]
            args = (p(tin[5]), *map(p, tin[:5]), *map(p, red), b, n, 64, c2,
                    k, slope, _build.stream_of(red[0]))
            if not integer:
                ms = device_ms(lambda: _call(fn, *args), reps=5, rounds=5)
                result["forms"][name]["ms"].setdefault(key, []).append(ms)
                print(f"{name} {key} ms {ms:.4f}", flush=True)
            _call(fn, *args)
            torch.cuda.synchronize()
            outs[name] = red
        same = all(torch.equal(x, y) for name in outs
                   for x, y in zip(outs[name], outs["earlier"]))
        finite = all(bool(torch.isfinite(x).all()) for x in outs["kernel"])
        result["checks"].append({"shape": key, "bit_equal": same,
                                 "finite": finite})
        print(f"{key}: four outputs bit-equal {same}, finite {finite}",
              flush=True)
        if not (same and finite):
            bad.append(key)
        del tin, outs
        torch.cuda.empty_cache()
    return bad


def run_knn_idx(entries: dict, result: dict, order: list[str]) -> list[str]:
    """Kernel 11: every form at the graphs' shapes (timed), then on integer
    duplicate points; idx identical between the forms and over two
    calls."""
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = _build.ptr
    cases = [(f"{cell} B={b} N={n} k={k} C=3", b, n, k, False)
             for cell, b, n, k in KNN_IDX_SHAPES]
    cases += [(f"integer duplicates B=2 N=1024 k={k} C=3", 2, 1024, k, True)
              for k in (20, 40)]
    bad = []
    for key, b, n, k, integer in cases:
        if integer:  # every point four times on a small grid
            base = torch.randint(-2, 3, (b, n // 4, 3), generator=g).float()
            x = torch.cat([base] * 4, dim=1).to(dev).contiguous()
        else:
            x = torch.randn((b, n, 3), generator=g).to(dev)
        outs = {}
        for name in order:
            fn = entries[name][0]
            idx = torch.empty((b, n, k), device=dev, dtype=torch.int32)
            sq = torch.empty((b * n,), device=dev)
            args = (p(x), p(sq), p(idx), b, n, 3, k, _build.stream_of(x))
            if not integer:
                ms = device_ms(lambda: _call(fn, *args), reps=5, rounds=5)
                result["forms"][name]["ms"].setdefault(key, []).append(ms)
                print(f"{name} {key} ms {ms:.4f}", flush=True)
            _call(fn, *args)
            first = idx.clone()
            _call(fn, *args)
            torch.cuda.synchronize()
            outs[name] = (idx, torch.equal(first, idx))
        same = all(torch.equal(idx, outs["earlier"][0]) and again
                   for idx, again in outs.values())
        check = {"shape": key, "identical": same}
        if integer:  # the case must put the k-th boundary inside ties
            from dgcnn_tpu_torch.ops.knn import pairwise_neg_sqdist

            top = pairwise_neg_sqdist(x).topk(k + 1, dim=-1).values
            check["rows_tied_at_kth"] = int(
                (top[..., k - 1] == top[..., k]).sum())
            same = same and check["rows_tied_at_kth"] > 0
        result["checks"].append(check)
        print(f"{key}: {json.dumps(check)}", flush=True)
        if not same:
            bad.append(key)
        del x, outs
        torch.cuda.empty_cache()
    return bad


def run_knn_sum(entries: dict, result: dict, order: list[str]) -> list[str]:
    """Kernel 10: every form at the HOG's graphs (timed), then on integer
    duplicate points; idx and the sums identical between the forms and
    over two calls."""
    from dgcnn_tpu_torch.ops.hog import centred_moments
    from dgcnn_tpu_torch.ops.knn import pairwise_neg_sqdist

    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = _build.ptr
    cases = [(f"{cell} B={b} N={n} k={k} C=3 Ca=9", b, n, k, False)
             for cell, b, n, k in KNN_SUM_SHAPES]
    cases += [(f"integer duplicates B=2 N=2048 k={k} C=3 Ca=9", 2, 2048, k,
               True) for k in (32, 40)]
    bad = []
    for key, b, n, k, integer in cases:
        if integer:  # every point four times on a small grid
            base = torch.randint(-2, 3, (b, n // 4, 3), generator=g).float()
            x = torch.cat([base] * 4, dim=1).to(dev)
            a = torch.randint(-3, 4, (b, n, 9), generator=g).float().to(dev)
        else:
            x, a = centred_moments(torch.randn((b, n, 3), generator=g).to(
                dev))
        x, a = x.contiguous(), a.contiguous()
        outs = {}
        for name in order:
            fn = entries[name][0]
            idx = torch.empty((b, n, k), device=dev, dtype=torch.int32)
            asum = torch.empty((b, n, 9), device=dev)
            sq = torch.empty((b * n,), device=dev)
            args = (p(x), p(a), p(sq), p(idx), p(asum), b, n, 3, 9, k,
                    _build.stream_of(x))
            if not integer:
                ms = device_ms(lambda: _call(fn, *args), reps=5, rounds=5)
                result["forms"][name]["ms"].setdefault(key, []).append(ms)
                print(f"{name} {key} ms {ms:.4f}", flush=True)
            _call(fn, *args)
            first = (idx.clone(), asum.clone())
            _call(fn, *args)
            torch.cuda.synchronize()
            outs[name] = (idx, asum, torch.equal(first[0], idx)
                          and torch.equal(first[1], asum))
        want = outs["earlier"]
        same = all(torch.equal(o[0], want[0]) and torch.equal(o[1], want[1])
                   and o[2] for o in outs.values())
        check = {"shape": key, "bit_equal": same,
                 "finite": bool(torch.isfinite(want[1]).all())}
        if integer:  # the case must put the k-th boundary inside ties
            top = pairwise_neg_sqdist(x).topk(k + 1, dim=-1).values
            check["rows_tied_at_kth"] = int(
                (top[..., k - 1] == top[..., k]).sum())
            same = same and check["rows_tied_at_kth"] > 0
        result["checks"].append(check)
        print(f"{key}: {json.dumps(check)}", flush=True)
        if not (same and check["finite"]):
            bad.append(key)
        del x, a, outs
        torch.cuda.empty_cache()
    return bad


def run_edge_sum(entries: dict, result: dict, order: list[str]) -> list[str]:
    """Kernel 9: every form at the HOG's shapes and beside them (timed),
    then on repeated indices; the sums bit-equal between the forms and to
    the plain version."""
    from dgcnn_tpu_torch.ops.edge_sum_kernel import edge_sum_plain
    from dgcnn_tpu_torch.ops.knn import knn

    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    p = _build.ptr
    cases = [(f"{cell} B={b} N={n} Co={co} k={k}", b, n, co, k, False)
             for cell, b, n, co, k in EDGE_SUM_SHAPES]
    cases += [(f"repeated indices B=2 N=2048 Co={co} k={k}", 2, 2048, co, k,
               True) for co in (18, 9) for k in (1, 32, 40)]
    bad = []
    for key, b, n, co, k, repeated in cases:
        if repeated:  # random indices, one position a copy of another
            idx = torch.randint(0, n, (b, n, k), generator=g,
                                dtype=torch.int32)
            idx[..., k // 2] = idx[..., k // 3]
            idx = idx.to(dev)
        else:
            pts = torch.randn((b, n, 3), generator=g).to(dev)
            idx = knn(pts, k).int()
        a = torch.randn((b, n, co), generator=g).to(dev)
        outs = {}
        for name in order:
            fn = entries[name][0]
            out = torch.empty((b, n, co), device=dev)
            args = (p(idx), p(a), p(out), b, n, co, k, _build.stream_of(a))
            if not repeated:
                ms = device_ms(lambda: _call(fn, *args), reps=20, rounds=5)
                result["forms"][name]["ms"].setdefault(key, []).append(ms)
                print(f"{name} {key} ms {ms:.4f}", flush=True)
            _call(fn, *args)
            torch.cuda.synchronize()
            outs[name] = out
        want = edge_sum_plain(a, idx)
        same = all(torch.equal(out, want) for out in outs.values())
        result["checks"].append({"shape": key, "bit_equal_plain": same})
        print(f"{key}: every form bit-equal to edge_sum_plain {same}",
              flush=True)
        if not same:
            bad.append(key)
        del idx, a, outs, want
        torch.cuda.empty_cache()
    return bad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(SOURCES), required=True)
    ap.add_argument("--root", default=None,
                    help="checkout whose dgcnn_tpu_torch/csrc holds the "
                         "kernel's source (default: this one)")
    ap.add_argument("--form", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another source of the kernel's C entry to time "
                         "(repeat); its own directory's headers first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("reduce_ab: needs a CUDA card")
    root = os.path.abspath(args.root or os.path.join(_HERE, "..", ".."))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    print(card, flush=True)
    extra = dict(f.split("=", 1) for f in args.form)
    built = build(args.kernel, root, extra)
    result = {"card": card, "kernel": args.kernel, "root": root,
              "forms": {}, "checks": []}
    for name, (lib, regs) in built.items():
        for ln in regs:
            print(f"{name} ptxas {ln}", flush=True)
        result["forms"][name] = {"ptxas": regs, "ms": {}}
    entries = {name: _entry(lib, args.kernel, name)
               for name, (lib, _) in built.items()}
    order = list(built) + list(reversed(built))
    torch.backends.cuda.matmul.allow_tf32 = False
    run = {"knn_reduce": run_knn, "edge2_bwd": run_edge2,
           "edge_conv_eval": functools.partial(run_eval, "edge_conv_eval"),
           "knn_edge2": functools.partial(run_eval, "knn_edge2"),
           "edge_reduce_bwd": run_bwd, "edge2_fwd": run_fwd,
           "knn_idx": run_knn_idx,
           "banded_edge_conv_eval": functools.partial(
               run_banded, "banded_edge_conv_eval"),
           "banded_knn_edge2": functools.partial(run_banded,
                                                 "banded_knn_edge2"),
           "knn_sum": run_knn_sum, "edge_sum": run_edge_sum}
    bad = run[args.kernel](entries, result, order)
    print(json.dumps(result), flush=True)
    if bad:
        sys.exit(f"reduce_ab: {bad} failed their checks")


if __name__ == "__main__":
    main()
