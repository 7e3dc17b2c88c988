"""A/B timing of kernel 3 (``dg_knn_reduce``) or kernel 8
(``dg_edge2_bwd``) against its earlier row-warp form on one card.

Builds the kernel's source (``csrc/knn_reduce.cu`` or ``csrc/edge2_bwd.cu``)
and its earlier form (``tools/reduce_forms/*_rowwarp.cu``) each into a
library of its own (one ``nvcc`` a form, both started together; the
kNN forms link ``csrc/edge_conv_eval.cu`` and ``csrc/project.cu`` for the
squared norms and the projection), then times both at every cell's shapes
in the order a b b a, as device times (calls queued behind a sleep of the
card, ``project_ab.device_ms``), and holds them to each other:

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
  each row's norm.

``--root DIR`` builds the kernel's source from another checkout (its
``dgcnn_tpu_torch/csrc``), the earlier form from this one; ``--form
NAME=PATH`` adds another source of the same C entry, held and timed like
the kernel (the order is then a b c ... c b a).  Prints the
card's name and power limit, ptxas's registers and spills for each form,
one line a shape and form, and last one JSON object with every reading.
Exits non-zero without a CUDA card or when a check fails.

    python -m dgcnn_tpu_torch.tools.reduce_ab --kernel knn_reduce|edge2_bwd
        [--root DIR] [--form NAME=PATH ...]
"""
from __future__ import annotations

import argparse
import ctypes
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
SOURCES = {"knn_reduce": "knn_reduce.cu", "edge2_bwd": "edge2_bwd.cu"}
# the sources a kNN form links: launch_sqnorm, dg_cuda_error_string and
# launch_project
KNN_HELPERS = ("edge_conv_eval.cu", "project.cu")
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


def build(kernel: str, root: str,
          extra: dict[str, str]) -> dict[str, tuple[str, list[str]]]:
    """Compiles the kernel, its earlier form and the ``extra`` sources into
    ``build/reduce_ab/``; returns each form's library path and ptxas's
    lines."""
    csrc = os.path.join(root, "dgcnn_tpu_torch", "csrc")
    forms = {"kernel": os.path.join(csrc, SOURCES[kernel]),
             "rowwarp": os.path.join(
                 _FORMS_DIR, SOURCES[kernel][:-3] + "_rowwarp.cu"), **extra}
    helpers = ([os.path.join(_build.CSRC, h) for h in KNN_HELPERS]
               if kernel == "knn_reduce" else [])
    out_dir = os.path.join(_build.BUILD_DIR, "reduce_ab")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, src in forms.items():
        inc = _build.CSRC if name == "rowwarp" else os.path.dirname(src)
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
                             if "reduce" in ln or "bwd" in ln
                             or "partial" in ln])
    return built


def _entry(lib: str, kernel: str):
    """The form's C entry of the kernel and, for kernel 8, its tile count
    (None where the form has none)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll = ctypes.CDLL(lib)
    if kernel == "knn_reduce":
        fn = dll.dg_knn_reduce
        fn.argtypes = [p] * 8 + [i] * 5 + [p]
        tiles = None
    else:
        fn = dll.dg_edge2_bwd
        fn.argtypes = [p] * 16 + [i] * 6 + [f, p]
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
                       for x, y in zip(outs[name], outs["rowwarp"]))
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
        args = (p(idx), *map(p, tin), *map(p, feats), p(da1), p(db1),
                p(part), p(dflat), b, n, c1, c2, k, g_blocks, 0.2,
                _build.stream_of(idx))

        def call():
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
            first = dflat.clone()
            call()
            torch.cuda.synchronize()
            outs[name] = (da1.clone(), db1.clone(), dflat.clone(),
                          torch.equal(first, dflat))
        old = outs["rowwarp"]
        for name, new in outs.items():
            if name == "rowwarp":
                continue
            dw_rel = ((new[2] - old[2]).norm() / old[2].norm()).item()
            check = {"shape": key, "form": name,
                     "db1_bit_equal": torch.equal(new[1], old[1]),
                     "dflat_rel": dw_rel,
                     "dflat_same_bits_over_calls": new[3],
                     "da1_row_rel": _row_rel(new[0], old[0])}
            result["checks"].append(check)
            print(f"{key}: {json.dumps(check)}", flush=True)
            if not (check["db1_bit_equal"] and dw_rel <= 1e-5 and new[3]
                    and check["da1_row_rel"] <= 1e-5):
                bad.append(f"{key} {name}")
        del tin, idx, feats, outs
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
    entries = {name: _entry(lib, args.kernel)
               for name, (lib, _) in built.items()}
    order = list(built) + list(reversed(built))
    torch.backends.cuda.matmul.allow_tf32 = False
    bad = (run_knn if args.kernel == "knn_reduce" else run_edge2)(
        entries, result, order)
    print(json.dumps(result), flush=True)
    if bad:
        sys.exit(f"reduce_ab: {bad} failed their checks")


if __name__ == "__main__":
    main()
