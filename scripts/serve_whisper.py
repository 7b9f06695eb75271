#!/usr/bin/env python3
"""Serve ``chip_smoke.py``'s whisper-base path from one source tree.

    python3 scripts/serve_whisper.py [--src DIR] [--label NAME]

DIR is the ``src`` directory whose ``repro_torch`` package serves (this
checkout's by default), driven by the ``chip_smoke.py`` beside it, so that
an older tree unpacked with ``git archive`` under ``build/`` is served and
checked by its own code. The path runs through ``chip_smoke.phase_family``:
the seeded stream served ``SERVE_REPEATS["whisper-base"]`` times on one
warm engine (median tok/s and its quartiles, first-serve segment ms and
prefill) and one profiled serve (device kernel time, the decode-attention
lines by kernel), all printed by ``chip_smoke``. To compare two trees, run
them in one call on one card in turns (old, new, new, old). Prints one JSON
line of what the tree's ``phase_family`` returns. Needs one CUDA card.
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
                    help="the src directory whose repro_torch serves")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(src.parent))
    import torch
    if not torch.cuda.is_available():
        print("serve_whisper: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = cs.phase_family(torch, torch.device("cuda"), "whisper-base")
    keep = ("tok_s", "tok_s_all", "spread", "seg_ms", "prefill_s",
            "peak_gb", "profile")
    print(json.dumps({"tree": args.label, "src": str(src),
                      "card": cs.card_line(),
                      **{k: res.get(k) for k in keep}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
