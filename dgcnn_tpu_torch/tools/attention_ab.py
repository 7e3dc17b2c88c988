"""A/B timing of forms of the attention kernels on one card.

Builds each form's source into a library of its own (one ``nvcc`` a form,
all started together), then times every form at the fusion Net's
attention shapes in the order a b ... b a, so that a drift of the card's
clock falls on every form alike, and holds each output against the plain
version.  ``--kernel fwd`` (the default) times ``dg_attention_fwd``
(kernel 14: ``csrc/attention_fwd.cu`` and its earlier forms) at the eval
shapes, and ``dg_attention_fwd_train`` of the forms that have it at the
training step's shapes at dropout rate 0.5, its output and log-sum-exp
held within rel 1e-5 (of each row's norm) of the plain version;
``--kernel bwd`` times
``dg_attention_bwd`` (kernel 15: ``csrc/attention_bwd.cu`` and its CUDA-
core form) at dropout rate 0.5, dq, dk and dv held within rel 1e-4 of
each row's norm of ``attention_bwd_plain``.  The earlier forms live in
``tools/attention_forms/``; ``--form`` names others.

Prints the card's name and power limit, ptxas's registers and spills for
each form, one line a form, shape and pass, and last one JSON object with
every reading.  Exits non-zero without a CUDA card, or when a form
disagrees with the plain version.

    python -m dgcnn_tpu_torch.tools.attention_ab [--kernel fwd|bwd]
        [--form NAME=PATH ...]
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_plain,
    keep_threshold,
)

_HERE = os.path.dirname(os.path.abspath(__file__))
_FORMS_DIR = os.path.join(_HERE, "attention_forms")
FORMS = {
    "fwd": {
        "kernel": os.path.join(_build.CSRC, "attention_fwd.cu"),
        "simt": os.path.join(_FORMS_DIR, "attention_fwd_simt.cu"),
        "float4_reads": os.path.join(_FORMS_DIR, "float4_reads.cu"),
        "shared_kv": os.path.join(_FORMS_DIR, "shared_kv.cu"),
    },
    "bwd": {
        "kernel": os.path.join(_build.CSRC, "attention_bwd.cu"),
        "simt": os.path.join(_FORMS_DIR, "attention_bwd_simt.cu"),
    },
}
# (B, h, N, d): the Net's stacked eval call at 2, 1 and 4 heads of emb 512,
# and a ragged tile
SHAPES = [(32, 2, 2048, 256), (16, 1, 2048, 512), (32, 4, 2048, 128),
          (2, 2, 300, 256)]
# the training step's calls (stacked batch 64 and batch 32) at 2 heads,
# the stacked call at 1 and 4 heads, and a ragged tile
BWD_SHAPES = [(64, 2, 2048, 256), (32, 2, 2048, 256), (64, 1, 2048, 512),
              (64, 4, 2048, 128), (2, 2, 300, 256)]
BWD_RATE = 0.5


def build(forms: dict[str, str]) -> dict[str, tuple[str, list[str]]]:
    """Compiles every form into ``build/attention_ab/``; returns each
    form's library path and ptxas's register and spill lines."""
    out_dir = os.path.join(_build.BUILD_DIR, "attention_ab")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, src in forms.items():
        h = hashlib.sha256()
        for path in [src] + sorted(glob.glob(os.path.join(_build.CSRC,
                                                          "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        lib = os.path.join(out_dir, f"{name}_{digest}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", src, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {forms[name]}:\n{log}")
        built[name] = (lib, _ptxas_summary(log))
    return built


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` name among the <length><name> parts of a mangled
    (namespace-qualified) function name."""
    m = re.match(r"_ZN?", mangled)
    pos = m.end() if m else 0
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        pos += len(digits)
        part = mangled[pos:pos + int(digits)]
        pos += int(digits)
        if part.endswith("_kernel"):
            return part
    return "?"


def _ptxas_summary(log: str) -> list[str]:
    """One line a kernel instance: its template arguments, registers and
    spill stores."""
    lines, entry, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            args = re.findall(r"(?:Li|Lb)(\d+)E", m.group(1))
            entry = _kernel_name(m.group(1)) + (
                "<" + ", ".join(args) + ">" if args else "")
            spill = ""
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            lines.append(f"{entry}: {m.group(1)} registers, "
                         f"{spill or 0} B spill stores")
    return lines


def _entry(lib_path: str, kernel: str = "fwd"):
    """The form's C entry of ``kernel`` ("fwd", "fwd_train" or "bwd"), or
    None where the library has no such entry."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if kernel == "fwd":
        fn = ctypes.CDLL(lib_path).dg_attention_fwd
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, f, p]
    elif kernel == "fwd_train":
        fn = getattr(ctypes.CDLL(lib_path), "dg_attention_fwd_train", None)
        if fn is None:
            return None
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, f, p, ctypes.c_uint, f,
                       p, p]
    else:
        fn = ctypes.CDLL(lib_path).dg_attention_bwd
        fn.argtypes = [p] * 10 + [i] * 5 + [p, f, p, ctypes.c_uint, f, p]
    fn.restype = i
    return fn


def _time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _prepare(forms: dict[str, str], kernel: str):
    """Prints the card and ptxas's lines; returns the card, each form's
    entry point and the result skeleton."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    print(card, flush=True)
    built = build(forms)
    for name, (_, regs) in built.items():
        for ln in regs:
            print(f"{name} ptxas {ln}", flush=True)
    entries = {name: _entry(lib, kernel) for name, (lib, _) in built.items()}
    result = {"card": card, "kernel": kernel, "forms": {
        name: {"source": os.path.relpath(forms[name], os.getcwd()),
               "ptxas": built[name][1], "ms": {}, "rel": 0.0}
        for name in forms}}
    if kernel == "fwd":
        train = {name: _entry(lib, "fwd_train")
                 for name, (lib, _) in built.items()}
        entries = {name: (fn, train[name]) for name, fn in entries.items()}
    return entries, result


def _row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def run(forms: dict[str, str]) -> dict:
    entries, result = _prepare(forms, "fwd")
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    order = list(forms) + list(reversed(forms))
    for shape in SHAPES:
        b, h, n, d = shape
        q, k, v = (torch.randn(shape, generator=g).to(dev) for _ in range(3))
        want = attention_plain(q, k, v, d ** -0.5)
        out = torch.empty((b, n, h, d), device=dev).transpose(1, 2)
        strides = (ctypes.c_longlong * 12)(*[
            s for t in (q, k, v, out) for s in t.stride()[:3]])
        stream = _build.stream_of(q)

        for name in order:
            fn = entries[name][0]

            def call():
                rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                        _build.ptr(out), b, h, n, n, d, strides,
                        float(d ** -0.5), stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            ms = _time_ms(call)
            rel = _row_rel(out, want)
            form = result["forms"][name]
            form["ms"].setdefault(str(shape), []).append(ms)
            form["rel"] = max(form["rel"], rel)
            print(f"{name} {shape} rel {rel:.2e} ms {ms:.3f}", flush=True)
        del q, k, v, want, out
        torch.cuda.empty_cache()
    run_fwd_train(entries, result, order)
    return result


def run_fwd_train(entries, result, order) -> None:
    """Times ``dg_attention_fwd_train`` of every form that has it at
    ``BWD_SHAPES``, rate 0.5, on (B, h, N, d) views of (B, N, h * d)
    tensors as the Net passes them; o and the log-sum-exp held against
    ``attention_plain(..., with_lse=True)``."""
    g = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    seed = torch.tensor([9], dtype=torch.int64, device=dev)
    order = [name for name in order if entries[name][1] is not None]
    for shape in BWD_SHAPES:
        b, h, n, d = shape
        sc = d ** -0.5
        q, k, v = (torch.randn((b, n, h * d), generator=g).to(dev).reshape(
            b, n, h, d).transpose(1, 2) for _ in range(3))
        with torch.no_grad():
            want, lse_want = attention_plain(q, k, v, sc, BWD_RATE, seed,
                                             with_lse=True)
        out = torch.empty((b, n, h, d), device=dev).transpose(1, 2)
        lse = torch.empty((b, h, n), device=dev)
        strides = (ctypes.c_longlong * 12)(*[
            s for t in (q, k, v, out) for s in t.stride()[:3]])
        stream = _build.stream_of(q)
        p = _build.ptr

        for name in order:
            fn = entries[name][1]

            def call():
                rc = fn(p(q), p(k), p(v), p(out), b, h, n, n, d, strides, sc,
                        p(seed), keep_threshold(BWD_RATE),
                        1.0 / (1.0 - BWD_RATE), p(lse), stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            out.fill_(float("nan"))
            ms = _time_ms(call)
            rel = _row_rel(out, want)
            lse_rel = ((lse - lse_want).abs() / lse_want.abs()).max().item()
            form = result["forms"][name]
            form.setdefault("train_ms", {}).setdefault(str(shape),
                                                        []).append(ms)
            form["rel"] = max(form["rel"], rel, lse_rel)
            print(f"{name} {shape} training form rate {BWD_RATE} rel "
                  f"{rel:.2e} lse rel {lse_rel:.2e} ms {ms:.3f}", flush=True)
        del q, k, v, want, lse_want, out, lse
        torch.cuda.empty_cache()


def run_bwd(forms: dict[str, str]) -> dict:
    """Times ``dg_attention_bwd`` of every form at ``BWD_SHAPES``, rate
    0.5, on (B, h, N, d) views of (B, N, h * d) tensors as the Net passes
    them; o and the log-sum-exp come from the plain version."""
    entries, result = _prepare(forms, "bwd")
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    seed = torch.tensor([8], dtype=torch.int64, device=dev)
    order = list(forms) + list(reversed(forms))
    for shape in BWD_SHAPES:
        b, h, n, d = shape
        sc = d ** -0.5

        def heads():
            return torch.randn((b, n, h * d), generator=g).to(dev).reshape(
                b, n, h, d).transpose(1, 2)

        q, k, v, do = heads(), heads(), heads(), heads()
        with torch.no_grad():
            o, lse = attention_plain(q, k, v, sc, BWD_RATE, seed,
                                     with_lse=True)
        lse = lse.contiguous()
        want = attention_bwd_plain(q, k, v, seed, do, sc, BWD_RATE)
        grads = [torch.empty((b, n, h, d), device=dev).transpose(1, 2)
                 for _ in range(3)]
        delta = torch.empty((b, h, n), device=dev)
        strides = (ctypes.c_longlong * 24)(*[
            s for t in (q, k, v, o, do, *grads) for s in t.stride()[:3]])
        stream = _build.stream_of(q)
        p = _build.ptr

        for name in order:
            fn = entries[name]

            def call():
                rc = fn(p(q), p(k), p(v), p(o), p(do), p(lse), p(delta),
                        *(p(t) for t in grads), b, h, n, n, d, strides, sc,
                        p(seed), keep_threshold(BWD_RATE),
                        1.0 / (1.0 - BWD_RATE), stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            for t in grads:
                t.fill_(float("nan"))
            ms = _time_ms(call)
            rel = max(_row_rel(a, w) for a, w in zip(grads, want))
            form = result["forms"][name]
            form["ms"].setdefault(str(shape), []).append(ms)
            form["rel"] = max(form["rel"], rel)
            print(f"{name} {shape} rate {BWD_RATE} dq/dk/dv rel {rel:.2e} "
                  f"ms {ms:.3f}", flush=True)
        del q, k, v, do, o, lse, want, grads, delta
        torch.cuda.empty_cache()
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd",
                    help="fwd: dg_attention_fwd and dg_attention_fwd_train "
                         "(kernel 14); bwd: dg_attention_bwd (kernel 15)")
    ap.add_argument("--form", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a source of the kernel's C entry to time "
                         "(repeat; default: the kernel and the earlier "
                         "forms)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attention_ab: needs a CUDA card")
    forms = (dict(f.split("=", 1) for f in args.form)
             or FORMS[args.kernel])
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    result = run(forms) if args.kernel == "fwd" else run_bwd(forms)
    print(json.dumps(result), flush=True)
    tol = 1e-5 if args.kernel == "fwd" else 1e-4
    bad = [n for n, f in result["forms"].items() if not f["rel"] <= tol]
    if bad:
        sys.exit(f"attention_ab: {bad} disagree with the plain version")


if __name__ == "__main__":
    main()
