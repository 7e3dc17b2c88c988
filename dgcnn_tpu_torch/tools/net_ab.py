"""End-to-end timing of the fusion Net's eval forward and training step on
one card, for an A/B of two checkouts.

Builds the Net of ``chip_smoke.py``'s phases 24-31 (emb 512, k 32, 2
heads, 2 blocks, feed-forward 512, 50 parts, flax-like random weights
from a seed) on structured synthetic ShapeNetPart clouds (N = 2048), and
times its eval forward at B = 16 and one SGD step under the cycle
scheduler at B = 32, dropout 0.5: CUDA events around each call, the
median of ``--iters`` after warm-up (the step: half as many), as
``chip_smoke.py``'s phases 27 and 31 time them.  Reads the card's SM
clock, power draw and temperature before and after each.

``--amp`` times the eval forward in the AMP mode (the JAX package's
default on the card: ``DGCNN_TPU_PALLAS_EXACT`` unset, the Net's default
forward); without it ``DGCNN_TPU_PALLAS_EXACT=1`` pins the exact mode, as
the Net ran before it had the AMP mode.  The step is exact either way.

``--root DIR`` imports ``dgcnn_tpu_torch`` from another checkout (its
kernels built there), so that two trees are timed by one script: run it
in turns (a b b a ...) inside one call.  Prints the card's name and power
limit, one line a timing, and last one JSON object.  Exits non-zero
without a CUDA card.

    python dgcnn_tpu_torch/tools/net_ab.py [--root DIR] [--iters N] [--amp]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.stdout else "?"


def time_ms(fn, iters: int, warmup: int) -> float:
    import torch

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose dgcnn_tpu_torch to time (default: "
                         "this one)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--amp", action="store_true",
                    help="time the eval forward in the AMP mode")
    args = ap.parse_args()
    if args.amp:
        os.environ.pop("DGCNN_TPU_PALLAS_EXACT", None)
    else:
        os.environ["DGCNN_TPU_PALLAS_EXACT"] = "1"
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("net_ab: needs a CUDA card")
    from dgcnn_tpu_torch.cli.partseg import one_hot_categories
    from dgcnn_tpu_torch.data.synthetic import make_shapenetpart_structured
    from dgcnn_tpu_torch.models import Net, init_like_flax_
    from dgcnn_tpu_torch.ops import _build
    from dgcnn_tpu_torch.train import (
        make_momentum_schedule,
        make_optimizer,
        make_schedule,
        make_seg_steps,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi("name,power.limit")
    print(card, flush=True)
    _build.load_library()
    dev = torch.device("cuda")
    x, lab, seg = make_shapenetpart_structured(
        n_train=32, n_val=0, n_test=0, num_points=2048, seed=17)["train"]
    x, oh = (torch.from_numpy(v).to(dev) for v in (
        x, one_hot_categories(lab)))
    seg = torch.from_numpy(seg.astype(np.int64)).to(dev)
    model = init_like_flax_(
        Net(emb_dim=512, k=32, n_heads=2, n_blocks=2, ff_dims=512,
            dropout=0.5, device="cpu"),
        torch.Generator().manual_seed(18)).to(dev)

    def forward():
        with torch.no_grad():
            model(x[:16], oh[:16])

    train_step, _ = make_seg_steps(with_label=True)
    opt = make_optimizer(
        model.parameters(), use_sgd=True,
        schedule=make_schedule("cycle", 0.001, epochs=200,
                               steps_per_epoch=3),
        momentum_schedule=make_momentum_schedule("cycle", epochs=200,
                                                 steps_per_epoch=3))
    gen = torch.Generator(device=dev).manual_seed(29)

    def step():
        train_step(model, opt, x, oh, seg, gen)

    clock = "clocks.sm,power.draw,temperature.gpu"
    result = {"card": card, "root": root,
              "eval_mode": "amp" if args.amp else "exact"}
    for name, fn, iters, warmup in [
            ("eval_ms", forward, args.iters, 5),
            ("step_ms", step, max(3, args.iters // 2), 3)]:
        before = smi(clock)
        result[name] = time_ms(fn, iters, warmup)
        result[name + "_clocks"] = [before, smi(clock)]
        print(f"{name} {result[name]:.3f} (SM clock, power, temperature "
              f"{result[name + '_clocks']})", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
