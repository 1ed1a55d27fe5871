"""Time the port's hand-written kernels on one CUDA card: the flash kernels
(forward, dQ, dK/dV) against SDPA, and the int8 GEMM against ``F.linear`` on
bf16 weights; optionally each against the same kernels built from another
copy of the sources.

    python -m fedml_tpu_torch.tools.compare_kernels [--kernels flash,int8]
        [--against DIR] [--rounds N] [--head-dim D] [--kv-heads H]
        [--dtype bfloat16|float16|float32]

Flash: for each shape (the slice's B=2 T=2048 H=32 causal and dense, a
long T=8192 and a short T=512 one, all causal unless marked dense) at head
dim ``--head-dim`` (128; any multiple of 8 up to 256 runs on the instance of
its padded width), ``--kv-heads`` KV heads (H: no grouping) and ``--dtype``
(bfloat16) it times each kernel of this checkout's ``ops/csrc`` and
``torch.nn.functional.scaled_dot_product_attention`` (forward, or the
backward's dQ+dK+dV), a yardstick the port never calls, and the kernel's
plain PyTorch version where T <= PLAIN_MAX_T (it holds [B*H, T, T] scores);
each row's bound is reckoned from the real head dim, so a padded instance's
wasted products show as a lower share of it. Int8: the bf16 GEMM
``y = x . wq^T * scale`` at Llama-2-7B's four projection shapes (K x N) and M
1, 8, 16, 128 and 512, with the design this checkout launches
(``int8_matmul.design_for``), its bound (bytes over 3.35 TB/s or operations
over 989 TFLOP/s) and ``F.linear`` on the same weights in bf16; each call is
queued behind a sleep kernel (a decode-size call is shorter than its launch
on the host) and cycles weight copies past the 50 MB L2. With ``--against``
(a variant of ``ops/csrc`` with the same C interface and tiles, unpacked or
copied under an ignored directory) the two builds are timed in turns, ABBA
over ``--rounds`` rounds, and each line gives both times and the rounds the
checkout won. A time is ``cuda_ms``'s mean over back-to-back launches, the
timer ``chip_smoke.py`` uses too. Prints the card line, then one JSON object
per kernel and shape. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

SHAPES = ((2, 2048, 32, True), (2, 2048, 32, False), (1, 8192, 32, True), (8, 512, 32, True))
ITERS = 50
PLAIN_MAX_T = 2048
# the int8 GEMM: Llama-2-7B's projections (K, N) and the rows M of a call
INT8_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
INT8_MS = (1, 8, 16, 128, 512)
INT8_ROTATE_BYTES = 100e6  # weight copies cycled per timing: twice the 50 MB L2
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12  # H100 SXM: HBM3 bytes/s, dense bf16 FLOP/s
PEAK_FLOPS = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16, "float32": 67e12}  # f32: no tensor cores


def cuda_ms(fn, iters: int, behind_sleep: bool = False) -> float:
    """ms a call: the mean over one window of ``iters`` back-to-back calls,
    timed with CUDA events after one warm-up call, so a stall anywhere in the
    window counts. ``behind_sleep`` queues the window behind a sleep kernel,
    so the host's launch cost is hidden."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if behind_sleep:
        torch.cuda._sleep(50_000_000)  # about 30 ms of cycles: the host queues the window
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


def _cases(kern, b: int, t: int, h: int, causal: bool, d: int = 128, hkv: int | None = None,
           dtype: str = "bfloat16"):
    """{kernel: (launch(kernels), sdpa call, (operations, bytes), plain
    call)} on seeded inputs of head dim ``d``, ``hkv`` KV heads (``h`` by
    default) and ``dtype``; the backward reads O and lse from `kern`'s
    forward."""
    import torch
    import torch.nn.functional as F

    from ..ops import flash_attention as fa

    hkv = hkv or h
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v, do = (torch.randn(b * rows, t, d, generator=g, device="cuda").to(dt)
                   for rows in (h, hkv, hkv, h))
    fwd_tiles = fa.resolve_blocks("flash_fwd", dt, head_dim=d)
    dq_tiles = fa.resolve_blocks("flash_bwd_dq", dt, head_dim=d)
    dkv_tiles = fa.resolve_blocks("flash_bwd_dkv", dt, head_dim=d)
    o, lse = torch.empty_like(q), torch.empty(b * h, t, device="cuda")
    kern.fwd(q, k, v, o, lse, causal, h, hkv, *fwd_tiles)
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    out, stats = torch.empty_like(o), torch.empty_like(lse)
    q4, k4, v4 = (x.view(b, -1, t, d) for x in (q, k, v))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    gqa = hkv != h
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=gqa)
    cost = {name: work(name, b, t, h, hkv, d, q.element_size(), causal)
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), do.view(b, h, t, d), retain_graph=True)

    kw = dict(causal=causal, hq=h, hkv=hkv)
    return {
        "flash_fwd": (lambda kn: kn.fwd(q, k, v, out, stats, causal, h, hkv, *fwd_tiles),
                      lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                                             enable_gqa=gqa),
                      cost["flash_fwd"], lambda: fa.flash_fwd_reference(q, k, v, **kw)),
        "flash_bwd_dq": (lambda kn: kn.bwd_dq(q, k, v, do, lse, delta, dq, causal, h, hkv,
                                              *dq_tiles),
                         sdpa_bwd, cost["flash_bwd_dq"],
                         lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)),
        "flash_bwd_dkv": (lambda kn: kn.bwd_dkv(q, k, v, do, lse, delta, dk, dv, causal, h, hkv,
                                                *dkv_tiles),
                          sdpa_bwd, cost["flash_bwd_dkv"],
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)),
    }


def int8_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """The least ms of one bf16 int8 GEMM: the larger of its bytes (int8
    weights, x, y, scales, each once) over 3.35 TB/s and 2*M*N*K over the
    bf16 peak, and which of the two it is."""
    nbytes = n * k + 2 * m * k + 2 * m * n + 4 * n
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2.0 * m * n * k / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def _int8_case(m: int, k: int, n: int, seed: int):
    """(x, [(wq, scale, y)] cycled past L2, the bf16 weights' copies)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
    copies = max(1, int(-(-INT8_ROTATE_BYTES // (n * k))))
    ws = [(torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8),
           torch.rand(n, generator=g, device="cuda") * 1e-2 + 1e-4,
           torch.empty(m, n, device="cuda", dtype=torch.bfloat16)) for _ in range(copies)]
    dense = [w.bfloat16() for w, _, _ in ws[:max(1, int(-(-INT8_ROTATE_BYTES // (2 * n * k))))]]
    return x, ws, dense


def int8_rows(builds: dict, rounds: int, ms=INT8_MS):
    """One dict a (shape, M): each build's ms, F.linear's, the bound."""
    import itertools

    import torch

    from ..ops import int8_matmul as im

    for i, (k, n) in enumerate(INT8_SHAPES):
        for m in ms:
            x, ws, dense = _int8_case(m, k, n, seed=100 + 10 * i + m)
            ref = im.int8_matmul_reference(x, *ws[0][:2])
            cyc, cyc_d = itertools.cycle(ws), itertools.cycle(dense)

            def launch(kern):
                wq, scale, y = next(cyc)
                kern.int8_gemm(x, wq, scale, y)

            bound, by = int8_bound_ms(m, k, n)
            row = {"kernel": "int8_gemm", "M": m, "K": k, "N": n, "dtype": "bfloat16",
                   "design": im.design_for(m, torch.bfloat16), "bound_ms": bound, "bound_by": by,
                   "dense_ms": cuda_ms(lambda: torch.nn.functional.linear(x, next(cyc_d)), ITERS,
                                       behind_sleep=True)}
            for name, kern in builds.items():
                wq, scale, y = ws[0]
                kern.int8_gemm(x, wq, scale, y)
                rel = ((y.float() - ref.float()).norm() / ref.float().norm()).item()
                row[f"{name}_rel_err"] = rel
            times = {n_: [] for n_ in builds}
            for r in range(rounds):
                for name in (list(builds) if r % 2 == 0 else list(builds)[::-1]):
                    times[name].append(cuda_ms(lambda: launch(builds[name]), ITERS,
                                               behind_sleep=True))
            row.update({f"{n_}_ms": statistics.fmean(ts) for n_, ts in times.items()})
            row["checkout_share_of_bound"] = bound / row["checkout_ms"]
            if len(builds) > 1:
                row["checkout_won"] = f"{sum(a < c for a, c in zip(*times.values()))}/{rounds}"
            del ws, dense
            yield row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, help="another ops/csrc directory to time")
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--kernels", default="flash,int8",
                        help="comma-separated: flash (K1-K3), int8 (the int8 GEMM)")
    parser.add_argument("--int8-ms", default=",".join(map(str, INT8_MS)),
                        help="comma-separated rows M of the int8 GEMM's calls")
    parser.add_argument("--head-dim", type=int, default=128,
                        help="the flash kernels' head dim: a multiple of 8 from 8 to 256")
    parser.add_argument("--kv-heads", type=int, default=None,
                        help="the flash kernels' KV heads (default: as many as query heads)")
    parser.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16", "float32"),
                        help="the flash kernels' dtype")
    args = parser.parse_args()
    which = set(args.kernels.split(","))

    from ..ops import _build

    builds = {"checkout": _build.kernels()}
    if args.against:
        builds["against"] = _build.load(args.against.resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if "int8" in which:
        ms = tuple(int(m) for m in args.int8_ms.split(","))
        for row in int8_rows(builds, args.rounds if args.against else 1, ms):
            print(json.dumps(row), flush=True)
    if "flash" not in which:
        return
    d, hkv, dtype = args.head_dim, args.kv_heads, args.dtype
    for b, t, h, causal in SHAPES:
        for name, (launch, sdpa, (flops, nbytes), plain) in _cases(
                builds["checkout"], b, t, h, causal, d, hkv, dtype).items():
            bound = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) * 1e3
            row = {"kernel": name, "B": b, "T": t, "H": h, "Hkv": hkv or h, "D": d,
                   "dtype": dtype, "causal": causal, "bound_ms": bound,
                   "sdpa_ms": cuda_ms(sdpa, ITERS),
                   "plain_ms": cuda_ms(plain, 3) if t <= PLAIN_MAX_T else None}
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
            row["checkout_share_of_bound"] = bound / row["checkout_ms"]
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
