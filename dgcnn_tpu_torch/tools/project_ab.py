"""Timing of the projection of kernels 1, 4 and 12 (``xw_project``, the
launch behind ``dg_project`` and every ``launch_project``) on one card.

Times ``xw_project`` at the shapes the main paths give it: the four
DGCNNCls eval stages' ``[W_nbr | W_ctr]`` projections (B=64, N=1024; K =
3, 64, 64, 128; 2 Co = 128, 128, 256, 512) and the cls training stage 4
(B=32, K=128, Co=256), each beside one ``torch.matmul`` in f32 and the
card's bound, and holds each output within rel 1e-5 of the matmul.  The
output of rows that start unaligned (the small-K kernel) must equal the
tiled kernel's bit for bit, and so must the projection of half the rows.
Times are device times: the calls are queued behind a sleep of the card,
so that the host's launch time does not enter them.

``--root DIR`` imports ``dgcnn_tpu_torch`` from another checkout (its
kernels built there), so that two trees are timed by one script: run it
in the order a b b a inside one call.  Prints the card's name and power
limit, one line a shape, and last one JSON object.  Exits non-zero without
a CUDA card or when a check fails.

    python dgcnn_tpu_torch/tools/project_ab.py [--root DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 CUDA-core flop/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# (name, M, K, ncols)
SHAPES = [("cls eval stage 1", 64 * 1024, 3, 128),
          ("cls eval stage 2", 64 * 1024, 64, 128),
          ("cls eval stage 3", 64 * 1024, 64, 256),
          ("cls eval stage 4", 64 * 1024, 128, 512),
          ("cls train stage 4 (xw_project)", 32 * 1024, 128, 256)]


def bound_ms(m: int, k: int, n: int) -> float:
    nbytes = 4 * (m * k + k * n + m * n)
    return 1e3 * max(nbytes / PEAK_BYTES, 2 * m * k * n / PEAK_F32)


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls queued behind a sleep of
    the card, so that the events time the kernels and not the host's
    launches; the median of ``rounds``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues the calls
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose dgcnn_tpu_torch to time (default: "
                         "this one)")
    args = ap.parse_args()
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("project_ab: needs a CUDA card")
    from dgcnn_tpu_torch.ops.knn_reduce_kernel import xw_project

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows, bad = [], []
    for name, m, k, n in SHAPES:
        x = torch.randn((m // 1024, 1024, k), generator=g).to(dev)
        w = (torch.randn((k, n), generator=g) / k ** 0.5).to(dev)
        got = xw_project(x, w)
        want = torch.matmul(x, w)
        rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
        # rows that start unaligned take the small-K kernel
        xu = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x)
        xu.copy_(x)
        same = (torch.equal(xw_project(xu, w), got)
                and torch.equal(xw_project(x[: x.shape[0] // 2], w),
                                got[: x.shape[0] // 2]))
        row = {"shape": name, "M": m, "K": k, "ncols": n,
               "ms": device_ms(lambda: xw_project(x, w)),
               "matmul_ms": device_ms(lambda: torch.matmul(x, w)),
               "bound_ms": bound_ms(m, k, n), "rel": rel,
               "same_bits": same}
        rows.append(row)
        print(f"{name} (M, K, ncols) = {(m, k, n)}: xw_project "
              f"{row['ms']:.4f} ms, torch.matmul {row['matmul_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms, rows within rel {rel:.2e}, "
              f"same bits unaligned and on half the rows {same}", flush=True)
        if not rel <= 1e-5 or not same:
            bad.append(name)
        del x, w, got, want, xu
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "root": root, "shapes": rows}),
          flush=True)
    if bad:
        sys.exit(f"project_ab: {bad} failed their checks")


if __name__ == "__main__":
    main()
