"""Time the bf16 flash kernels (forward, dQ, dK/dV) against SDPA and,
optionally, against the same kernels built from another copy of the sources,
on one CUDA card.

    python -m fedml_tpu_torch.tools.compare_kernels [--against DIR] [--rounds N]

For each shape (the slice's B=2 T=2048 H=32 D=128 causal and dense, a long
T=8192 and a short T=512 one, all causal unless marked dense) it times each
kernel of this checkout's ``ops/csrc`` and
``torch.nn.functional.scaled_dot_product_attention`` (forward, or the
backward's dQ+dK+dV), a yardstick the port never calls. With ``--against``
(a variant of ``ops/csrc`` with the same C interface and tiles, unpacked or
copied under an ignored directory) the two builds are timed in turns, ABBA
over ``--rounds`` rounds, and each line gives both times and the rounds the
checkout won. A time is ``cuda_ms``'s mean over back-to-back launches, the
timer ``chip_smoke.py`` uses too. Prints the card line, then one JSON
object per kernel and shape. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

SHAPES = ((2, 2048, 32, True), (2, 2048, 32, False), (1, 8192, 32, True), (8, 512, 32, True))
D = 128
ITERS = 50


def cuda_ms(fn, iters: int) -> float:
    """ms a call: the mean over one window of ``iters`` back-to-back calls,
    timed with CUDA events after one warm-up call, so a stall anywhere in the
    window counts."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def work(name: str, b: int, t: int, hq: int, hkv: int, d: int, esize: int,
         causal: bool = True) -> tuple[float, float]:
    """(operations, bytes: inputs read once + outputs written once) of one call
    of kernel ``name``; operations are 2*D per (q, k) product (2 products in
    the forward, 3 in dQ, 4 in dK/dV) over the (q, k) pairs these inputs need,
    T(T+1)/2 a head when causal."""
    pairs = b * hq * (t * (t + 1) / 2 if causal else t * t)
    qbytes, kvbytes, stat = b * hq * t * d * esize, b * hkv * t * d * esize, b * hq * t * 4
    return {
        "flash_fwd": (2 * 2 * d * pairs, 2 * qbytes + 2 * kvbytes + stat),
        "flash_bwd_dq": (3 * 2 * d * pairs, 3 * qbytes + 2 * kvbytes + 2 * stat),
        "flash_bwd_dkv": (4 * 2 * d * pairs, 2 * qbytes + 4 * kvbytes + 2 * stat),
    }[name]


def _cases(kern, b: int, t: int, h: int, causal: bool):
    """{kernel: (launch(kernels), sdpa call, operations)} on seeded inputs;
    the backward reads O and lse from `kern`'s forward."""
    import torch
    import torch.nn.functional as F

    from ..ops import flash_attention as fa

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v, do = (torch.randn(b * h, t, D, generator=g, device="cuda").bfloat16()
                   for _ in range(4))
    fwd_tiles = fa.resolve_blocks("flash_fwd", torch.bfloat16)
    dq_tiles = fa.resolve_blocks("flash_bwd_dq", torch.bfloat16)
    dkv_tiles = fa.resolve_blocks("flash_bwd_dkv", torch.bfloat16)
    o, lse = torch.empty_like(q), torch.empty(b * h, t, device="cuda")
    kern.fwd(q, k, v, o, lse, causal, h, h, *fwd_tiles)
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    out, stats = torch.empty_like(o), torch.empty_like(lse)
    q4, k4, v4 = (x.view(b, h, t, D) for x in (q, k, v))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    flops = {name: work(name, b, t, h, h, D, 2, causal)[0]
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), do.view(b, h, t, D), retain_graph=True)

    return {
        "flash_fwd": (lambda kn: kn.fwd(q, k, v, out, stats, causal, h, h, *fwd_tiles),
                      lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
                      flops["flash_fwd"]),
        "flash_bwd_dq": (lambda kn: kn.bwd_dq(q, k, v, do, lse, delta, dq, causal, h, h,
                                              *dq_tiles),
                         sdpa_bwd, flops["flash_bwd_dq"]),
        "flash_bwd_dkv": (lambda kn: kn.bwd_dkv(q, k, v, do, lse, delta, dk, dv, causal, h, h,
                                                *dkv_tiles),
                          sdpa_bwd, flops["flash_bwd_dkv"]),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, help="another ops/csrc directory to time")
    parser.add_argument("--rounds", type=int, default=6)
    args = parser.parse_args()

    from ..ops import _build

    builds = {"checkout": _build.kernels()}
    if args.against:
        builds["against"] = _build.load(args.against.resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for b, t, h, causal in SHAPES:
        for name, (launch, sdpa, flops) in _cases(builds["checkout"], b, t, h, causal).items():
            row = {"kernel": name, "B": b, "T": t, "H": h, "D": D, "causal": causal,
                   "sdpa_ms": cuda_ms(sdpa, ITERS)}
            if args.against:
                times = {n: [] for n in builds}
                for r in range(args.rounds):
                    for n in (list(builds) if r % 2 == 0 else list(builds)[::-1]):
                        times[n].append(cuda_ms(lambda: launch(builds[n]), ITERS))
                # equal launches a round, so the mean of the rounds is the mean a launch
                row.update({f"{n}_ms": statistics.fmean(ts) for n, ts in times.items()})
                row["checkout_won"] = f"{sum(a < c for a, c in zip(*times.values()))}/{args.rounds}"
            else:
                row["checkout_ms"] = cuda_ms(lambda: launch(builds["checkout"]), ITERS)
            row["checkout_tflops"] = flops / row["checkout_ms"] / 1e9
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
