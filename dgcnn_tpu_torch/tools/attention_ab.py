"""A/B timing of forms of the attention kernel (kernel 14) on one card.

Builds each form's source of ``dg_attention_fwd`` into a library of its
own (one ``nvcc`` a form, all started together), then times every form at
the fusion Net's attention shapes in the order a b ... b a, so that a
drift of the card's clock falls on every form alike, and holds each
output against the plain version (rel 1e-5 of each row's norm).  The
forms are the kernel (``csrc/attention_fwd.cu``) and the earlier forms in
``tools/attention_forms/``, or those given with ``--form``.

Prints the card's name and power limit, ptxas's registers and spills for
each form, one line a form, shape and pass, and last one JSON object with
every reading.  Exits non-zero without a CUDA card, or when a form
disagrees with the plain version.

    python -m dgcnn_tpu_torch.tools.attention_ab [--form NAME=PATH ...]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

import torch

from dgcnn_tpu_torch.ops import _build
from dgcnn_tpu_torch.ops.attention import attention_plain

_HERE = os.path.dirname(os.path.abspath(__file__))
FORMS = {
    "kernel": os.path.join(_build.CSRC, "attention_fwd.cu"),
    "float4_reads": os.path.join(_HERE, "attention_forms", "float4_reads.cu"),
    "shared_kv": os.path.join(_HERE, "attention_forms", "shared_kv.cu"),
}
# (B, h, N, d): the Net's stacked call at 2, 1 and 4 heads of emb 512, and
# a ragged tile
SHAPES = [(32, 2, 2048, 256), (16, 1, 2048, 512), (32, 4, 2048, 128),
          (2, 2, 300, 256)]


def build(forms: dict[str, str]) -> dict[str, tuple[str, list[str]]]:
    """Compiles every form into ``build/attention_ab/``; returns each
    form's library path and ptxas's register and spill lines."""
    out_dir = os.path.join(_build.BUILD_DIR, "attention_ab")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, src in forms.items():
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
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


def _ptxas_summary(log: str) -> list[str]:
    """One line a kernel instance: its template arguments, registers and
    spill stores."""
    lines, entry, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            args = re.findall(r"(?:Li|Lb)(\d+)E", m.group(1))
            entry, spill = "<" + ", ".join(args) + ">", ""
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            lines.append(f"attn_fwd_kernel{entry}: {m.group(1)} registers, "
                         f"{spill or 0} B spill stores")
    return lines


def _entry(lib_path: str):
    fn = ctypes.CDLL(lib_path).dg_attention_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p, ctypes.c_float, p]
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


def run(forms: dict[str, str]) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    print(card, flush=True)
    built = build(forms)
    for name, (_, regs) in built.items():
        for ln in regs:
            print(f"{name} ptxas {ln}", flush=True)
    entries = {name: _entry(lib) for name, (lib, _) in built.items()}
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    result = {"card": card, "forms": {
        name: {"source": os.path.relpath(forms[name], os.getcwd()),
               "ptxas": built[name][1], "ms": {}, "rel": 0.0}
        for name in forms}}
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
            fn = entries[name]

            def call():
                rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                        _build.ptr(out), b, h, n, n, d, strides,
                        float(d ** -0.5), stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            ms = _time_ms(call)
            rel = ((out - want).norm(dim=-1)
                   / want.norm(dim=-1)).max().item()
            form = result["forms"][name]
            form["ms"].setdefault(str(shape), []).append(ms)
            form["rel"] = max(form["rel"], rel)
            print(f"{name} {shape} rel {rel:.2e} ms {ms:.3f}", flush=True)
        del q, k, v, want, out
        torch.cuda.empty_cache()
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--form", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a source of dg_attention_fwd to time (repeat; "
                         "default: the kernel and the earlier forms)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attention_ab: needs a CUDA card")
    forms = dict(f.split("=", 1) for f in args.form) or FORMS
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    result = run(forms)
    print(json.dumps(result), flush=True)
    bad = [n for n, f in result["forms"].items() if f["rel"] > 1e-5]
    if bad:
        sys.exit(f"attention_ab: {bad} disagree with the plain version")


if __name__ == "__main__":
    main()
