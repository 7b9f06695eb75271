#!/usr/bin/env python3
"""Time one source tree's int8 GEMM under both timers of ``chip_smoke.py``.

    python3 scripts/time_int8.py [--src DIR] [--label NAME]

DIR is the ``src`` directory whose ``repro_torch`` package is timed (this
checkout's by default). An older tree, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists (``build/``), is then timed by the same
code as this one; to compare two trees, run them in one call on one card as
old, new, new, old. The shapes are ``chip_smoke.py``'s timed int8 cases:
llama3.2-1b's four projections at M = 8 and 2048 with bf16 x, and the down
projection with f32 x. Each is timed by ``chip_smoke.time_int8``: held
back-to-back launches on cold weights, host-paced launches on warm weights
(``chip_smoke.py``'s earlier timer), and the host time of one call, each
beside ``torch.mm`` on the dequantised weight. Prints one JSON line. Needs
one CUDA card; the tree's kernels are built into its own ``build/kernels``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_int8: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.ref import quantize_int8
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    cases = [(kd, n, torch.bfloat16) for kd, n in chip_smoke.INT8_SHAPES]
    cases.append((8192, 2048, torch.float32))
    rows = []
    for M in (8, 2048):
        for Kd, N, dt in cases:
            x = torch.randn((M, Kd), generator=gen, device=dev).to(dt)
            w = torch.randn((Kd, N), generator=gen, device=dev) / Kd ** 0.5
            w_q, s = quantize_int8(w)
            rows.append(chip_smoke.time_int8(torch, x, w_q, s))
    print(json.dumps({"tree": args.label, "src": str(src),
                      "card": chip_smoke.card_line(), "int8": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
