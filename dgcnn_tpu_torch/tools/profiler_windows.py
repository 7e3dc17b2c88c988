"""How many kernel events torch.profiler records in window after window,
on one card, with CUPTI torn down after each window and without.

In each of two child processes a run (the Kineto default, then
``TEARDOWN_CUPTI=0``), it opens ``--windows`` profiler windows one after
another, each over ``--calls`` calls of ``conv_pool`` at the DGCNNCls conv5
shape (B=64, N=1024, inputs 64 / 64 / 128 / 256, E = 1024: two kernels a
call) and one ``torch.matmul``, and counts the windows that record no
device event and those that record another number of ``conv_pool`` kernel
events than ran.  ``chip_smoke.py`` opens dozens of such windows in one
process for its route checks.  Prints the card's name and power limit, one
line a run, and last one JSON object with every count.

    python -m dgcnn_tpu_torch.tools.profiler_windows [--windows 300]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RUNS = [("kineto default", {}), ("TEARDOWN_CUPTI=0",
                                 {"TEARDOWN_CUPTI": "0"})]


def count_windows(windows: int, calls: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool

    g = torch.Generator().manual_seed(0)
    xs = tuple(torch.randn((64, 1024, c), generator=g).cuda()
               for c in (64, 64, 128, 256))
    w = (torch.randn((512, 1024), generator=g) / 512 ** 0.5).cuda()
    scale, bias = torch.ones(1024).cuda(), torch.zeros(1024).cuda()
    a = torch.randn((512, 512), generator=g).cuda()
    conv_pool(xs, w, scale, bias)
    torch.cuda.synchronize()
    rows, t0 = [], time.perf_counter()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                conv_pool(xs, w, scale, bias)
            torch.matmul(a, a)
            torch.cuda.synchronize()
        ours = total = 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                total += e.count
                ours += e.count if "conv_pool" in e.key else 0
        rows.append((ours, total))
    off = [i for i, (ours, _) in enumerate(rows) if ours != 2 * calls]
    return {"windows": windows, "calls": calls,
            "empty": sum(total == 0 for _, total in rows),
            "conv_pool_events_off": len(off),
            "first_off": [(i, rows[i][0]) for i in off[:10]],
            "seconds": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=300)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(count_windows(args.windows, args.calls)))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("profiler_windows: no CUDA card")
    from dgcnn_tpu_torch.ops import _build

    _build.load_library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    out = {"card": card, "runs": {}}
    for name, extra in RUNS:
        env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        p = subprocess.run(
            [sys.executable, "-m", "dgcnn_tpu_torch.tools.profiler_windows",
             "--child", "--windows", str(args.windows), "--calls",
             str(args.calls)], env=dict(env, **extra), capture_output=True,
            text=True, timeout=1200)
        if p.returncode != 0:
            sys.exit(f"profiler_windows: {name}: {p.stderr.strip()[-500:]}")
        out["runs"][name] = json.loads(p.stdout.strip().splitlines()[-1])
        print(name, out["runs"][name], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
