"""What the row gate sees of the bf16 dQ kernel, on one CUDA card.

    python -m fedml_tpu_torch.tools.dq_row_gate

``chip_smoke.py`` holds each row r of the bf16 dQ kernel's output to
``ROW_RTOL * ||ref_r|| + ROW_ATOL + floor_r`` against the plain version,
``floor_r`` being ``flash_bwd_dq_rounding_floor``: the f32 rounding of dP,
which the tensor cores sum in another order than the plain version. For
each shape this prints, as JSON, the rows outside that limit with and
without the floor for three candidates: the kernel; the plain version summed
in another order (the head dim permuted), which is as right as the plain
version itself; and the kernel's output with its later half of rows scaled
by 1.03, which is wrong. Beside them: the rows the floor holds (where it is
above ROW_RTOL * ||ref_r||), and how far row 0 of the kernel and of the
plain version lie from the plain version evaluated in f64 (causal row 0 is
0 in exact arithmetic). Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess

ROW_RTOL, ROW_ATOL = 1e-2, 1e-6  # chip_smoke.py's bf16 row gate
SHAPES = ((2, 2048, 32, 32, 128, True), (2, 2048, 32, 8, 128, True),
          (2, 2048, 32, 32, 128, False), (1, 2000, 32, 8, 64, True), (1, 130, 4, 2, 128, True))


def main() -> None:
    import torch

    from ..ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for b, t, hq, hkv, d, causal in SHAPES:
        g = torch.Generator(device="cuda")
        g.manual_seed(t + d)
        q, k, v, do = (torch.randn(b * h, t, d, generator=g, device="cuda").bfloat16()
                       for h in (hq, hkv, hkv, hq))
        kw = dict(causal=causal, hq=hq, hkv=hkv)
        o, lse = fa.flash_fwd_reference(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        ref = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw).float()
        kernel = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw).float()
        perm = torch.randperm(d, generator=torch.Generator().manual_seed(0)).cuda()
        other_order = fa.flash_bwd_dq_reference(
            *(x[..., perm].contiguous() for x in (q, k, v, do)), lse, delta,
            **kw).float()[..., torch.argsort(perm)]
        scaled = kernel.clone()
        scaled[:, t // 2:] *= 1.03
        f64 = fa.flash_bwd_dq_reference(*(x.double() for x in (q, k, v, do)), lse.double(),
                                        delta.double(), **kw)
        floor = fa.flash_bwd_dq_rounding_floor(q, k, v, do, lse, **kw)
        size = ref.norm(dim=-1)
        row = {"B": b, "T": t, "Hq": hq, "Hkv": hkv, "D": d, "causal": causal,
               "rows": size.numel(), "rows_held_by_floor": int((floor > ROW_RTOL * size).sum()),
               "floor_median": floor.median().item(), "floor_max": floor.max().item()}
        for name, got in (("kernel", kernel), ("other_order", other_order),
                          ("scaled_1.03", scaled)):
            err = (got - ref).norm(dim=-1)
            row[f"{name}_outside_without_floor"] = int((err > ROW_RTOL * size + ROW_ATOL).sum())
            row[f"{name}_outside_with_floor"] = int(
                (err > ROW_RTOL * size + ROW_ATOL + floor).sum())
        for name, got in (("kernel", kernel), ("plain", ref)):
            row[f"{name}_row0_from_f64_max"] = (
                (got[:, 0].double() - f64[:, 0]).norm(dim=-1).max().item())
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
