"""A/B timing of kernel 2 (``conv_pool``) on one card: its register-blocked
route against its first form, beside ``torch.matmul`` of the same product.

At the embedding convs of every model (E = 1024): DGCNNCls conv5 (B=64,
N=1024, inputs 64 / 64 / 128 / 256, max and mean) and at N = 1000 (the
last row tile masked), DGCNNSemSeg conv6 (B=16, N=4096, 192, max),
DGCNNPartSeg conv3 and conv6 (B=16, N=2048, 128 and 192, max; conv3 is the
fusion Net's too), it times, as device times (calls queued behind a sleep
of the card, ``project_ab.device_ms``), in the order a b b a:

- ``conv_pool`` on its register-blocked route (``csrc/conv_pool.cu``,
  ``conv_pool_gemm_kernel`` and its combine);
- ``conv_pool(..., tile64=True)``, the first form (``conv_pool_kernel``);

then the yardstick, ``torch.matmul`` of the same (B*N, C) x (C, E)
product in f32 with TF32 off, on inputs concatenated beforehand, and a
probe: ``xw_project`` of the same product, the GEMM core that kernel 2
shares with the projection (``csrc/gemm128.cuh``) writing its (B*N, E)
output to device memory, which shows what the core costs without the
pooling.  Holds the route to its plain version (every row within rel 1e-4)
and to the first form: max row bit-equal, mean row within rel 1e-6 (of
each element's |mean| plus the row's rms), both rows the same bits over
two calls.  Prints the card's name and power limit, one line a shape, and
last one JSON object with every reading.  Exits non-zero without a CUDA
card or when a check fails.

With ``--amp`` it times the AMP form instead (bf16 inputs): its
tensor-core route (``csrc/conv_pool_wgmma.cu``) against its earlier form
(``conv_pool(..., amp=True, simt=True)``: the inputs upcast for the CUDA
cores' register-blocked route), beside bf16 ``torch.matmul`` of the
product; both forms held within rel 1e-5 of ``conv_pool_amp_plain`` and to
the same bits over two calls.

    python -m dgcnn_tpu_torch.tools.pool_ab [--amp]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from dgcnn_tpu_torch.tools.project_ab import device_ms

E = 1024
# (cell, B, N, input widths, with_mean)
SHAPES = [("cls conv5", 64, 1024, (64, 64, 128, 256), True),
          ("cls conv5 N=1000", 64, 1000, (64, 64, 128, 256), True),
          ("seg conv6", 16, 4096, (192,), False),
          ("part conv3 (Net conv3)", 16, 2048, (128,), False),
          ("part conv6", 16, 2048, (192,), False)]


def _inputs(g, b: int, n: int, widths, dev):
    xs = tuple(torch.randn((b, n, c), generator=g).to(dev) for c in widths)
    c = sum(widths)
    w = (torch.randn((c, E), generator=g) / c ** 0.5).to(dev)
    sign = torch.where(torch.rand(E, generator=g) < 0.2, -1.0, 1.0)
    scale = (sign * (0.5 + torch.rand(E, generator=g))).to(dev)
    bias = (0.1 * torch.randn(E, generator=g)).to(dev)
    return xs, w, scale, bias


def check(xs, w, scale, bias, with_mean: bool) -> dict:
    """The route against its plain version and its first form."""
    from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool, conv_pool_plain

    got = conv_pool(xs, w, scale, bias, with_mean=with_mean)
    again = conv_pool(xs, w, scale, bias, with_mean=with_mean)
    first = conv_pool(xs, w, scale, bias, with_mean=with_mean, tile64=True)
    plain = conv_pool_plain(xs, w, scale, bias, with_mean=with_mean)
    torch.cuda.synchronize()
    rms = plain.pow(2).mean().sqrt()
    out = {"plain_rows_within_1e-4": bool(
               ((got - plain).abs() <= 1e-4 * (plain.abs() + rms)).all()),
           "max_bit_equal_first_form": torch.equal(got[:, 0], first[:, 0]),
           "same_bits_over_calls": torch.equal(got, again),
           "mean_rel_first_form": 0.0}
    if with_mean:
        want = first[:, 1]
        row = want.pow(2).mean(-1, keepdim=True).sqrt()
        out["mean_rel_first_form"] = (
            (got[:, 1] - want).abs() / (want.abs() + row)).max().item()
    return out


def check_amp(xs, w, scale, bias, with_mean: bool) -> dict:
    """The AMP form's two routes against its plain version."""
    from dgcnn_tpu_torch.ops.conv_pool_kernel import (
        conv_pool,
        conv_pool_amp_plain,
    )

    got = conv_pool(xs, w, scale, bias, with_mean=with_mean, amp=True)
    again = conv_pool(xs, w, scale, bias, with_mean=with_mean, amp=True)
    earlier = conv_pool(xs, w, scale, bias, with_mean=with_mean, amp=True,
                        simt=True)
    plain = conv_pool_amp_plain(xs, w, scale, bias, with_mean=with_mean)
    torch.cuda.synchronize()
    rms = plain.pow(2).mean().sqrt()

    def within(out):
        return bool(((out - plain).abs() <= 1e-5 * (plain.abs() + rms)).all())

    return {"plain_rows_within_1e-5": within(got) and within(earlier),
            "same_bits_over_calls": torch.equal(got, again)}


def main_amp(card: str) -> None:
    """The ``--amp`` A/B (module docstring)."""
    from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows, bad = [], []
    for cell, b, n, widths, with_mean in SHAPES:
        xs, w, scale, bias = _inputs(g, b, n, widths, dev)
        xs = tuple(x.to(torch.bfloat16) for x in xs)
        forms = {
            "kernel": lambda: conv_pool(xs, w, scale, bias,
                                        with_mean=with_mean, amp=True),
            "earlier": lambda: conv_pool(xs, w, scale, bias,
                                         with_mean=with_mean, amp=True,
                                         simt=True)}
        ms = {name: [] for name in forms}
        for name in list(forms) + list(reversed(list(forms))):
            ms[name].append(device_ms(forms[name], reps=5, rounds=5))
        x_cat, wb = torch.cat(xs, dim=-1), w.to(torch.bfloat16)
        row = {"cell": cell, "B": b, "N": n, "widths": list(widths), "E": E,
               "with_mean": with_mean, "ms": ms,
               "matmul_bf16_ms": device_ms(lambda: torch.matmul(x_cat, wb),
                                           reps=5, rounds=5),
               **check_amp(xs, w, scale, bias, with_mean)}
        rows.append(row)
        print(f"{cell} B={b} N={n} widths {widths} (AMP): kernel "
              f"{' / '.join(f'{v:.4f}' for v in ms['kernel'])} ms, earlier "
              f"{' / '.join(f'{v:.4f}' for v in ms['earlier'])} ms, bf16 "
              f"torch.matmul {row['matmul_bf16_ms']:.4f} ms; plain rows "
              f"{row['plain_rows_within_1e-5']}, same bits "
              f"{row['same_bits_over_calls']}", flush=True)
        if not (row["plain_rows_within_1e-5"]
                and row["same_bits_over_calls"]):
            bad.append(cell)
        del xs, w, x_cat, wb
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "amp": True, "shapes": rows}),
          flush=True)
    if bad:
        sys.exit(f"pool_ab --amp: {bad} failed their checks")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--amp", action="store_true",
                    help="time the AMP form's tensor-core route against "
                         "its earlier form")
    amp = ap.parse_args().amp
    if not torch.cuda.is_available():
        sys.exit("pool_ab: needs a CUDA card")
    from dgcnn_tpu_torch.ops.conv_pool_kernel import conv_pool
    from dgcnn_tpu_torch.ops.knn_reduce_kernel import xw_project

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    print(card, flush=True)
    if amp:
        main_amp(card)
        return
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows, bad = [], []
    for cell, b, n, widths, with_mean in SHAPES:
        xs, w, scale, bias = _inputs(g, b, n, widths, dev)
        forms = {
            "kernel": lambda: conv_pool(xs, w, scale, bias,
                                        with_mean=with_mean),
            "first_form": lambda: conv_pool(xs, w, scale, bias,
                                            with_mean=with_mean,
                                            tile64=True)}
        ms = {name: [] for name in forms}
        for name in list(forms) + list(reversed(list(forms))):
            ms[name].append(device_ms(forms[name], reps=5, rounds=5))
        x_cat = torch.cat(xs, dim=-1)
        row = {"cell": cell, "B": b, "N": n, "widths": list(widths), "E": E,
               "with_mean": with_mean, "ms": ms,
               "matmul_ms": device_ms(lambda: torch.matmul(x_cat, w),
                                      reps=5, rounds=5),
               "core_probe_ms": device_ms(lambda: xw_project(x_cat, w),
                                          reps=5, rounds=5),
               **check(xs, w, scale, bias, with_mean)}
        rows.append(row)
        print(f"{cell} B={b} N={n} widths {widths}: kernel "
              f"{' / '.join(f'{v:.4f}' for v in ms['kernel'])} ms, first "
              f"form {' / '.join(f'{v:.4f}' for v in ms['first_form'])} ms, "
              f"torch.matmul {row['matmul_ms']:.4f} ms, core probe "
              f"{row['core_probe_ms']:.4f} ms; plain rows "
              f"{row['plain_rows_within_1e-4']}, max bit-equal "
              f"{row['max_bit_equal_first_form']}, mean within "
              f"{row['mean_rel_first_form']:.2e}, same bits "
              f"{row['same_bits_over_calls']}", flush=True)
        if not (row["plain_rows_within_1e-4"]
                and row["max_bit_equal_first_form"]
                and row["same_bits_over_calls"]
                and row["mean_rel_first_form"] <= 1e-6):
            bad.append(cell)
        del xs, w, x_cat
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "shapes": rows}), flush=True)
    if bad:
        sys.exit(f"pool_ab: {bad} failed their checks")


if __name__ == "__main__":
    main()
