#!/usr/bin/env python3
"""The distributed layer's cases on 4 gloo ranks, outside pytest and
without JAX, under whatever torch is installed.

    python3 scripts/dist_cases.py [--log PATH]

Runs the world of ``tests/test_torch_distributed.py`` (every case on
DTensor's strategy table as it comes) on the CPU and prints one line a
case: ``ok`` with, for a family or train-step case, the worst error
against the unsharded port as that file's tests scale it, and for an
``ops/`` case the number of ops that reached DTensor dispatch; or
``FAIL`` with the exception's last line and the port's innermost frames,
or, for an ``ops/`` case, the ops that torch 2.11 refuses. The
``recorder`` line gives, for one op of each refused kind, what the
recorder refused. The full
tracebacks go to ``--log``. The reference's side (``moe_ffn_ep`` and the
split-K decode under JAX) is not run: the EP and split-K cases print
``ok`` when they ran. Needs 4 CPU cores; about 35 s on torch 2.13.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch                                        # noqa: E402
import torch.multiprocessing as mp                  # noqa: E402


def _worst(T, key, value):
    """The worst error of a case's (got, want) pairs, as its test scales
    it (a train step's relative to each leaf's largest magnitude), or
    None."""
    pairs = value.get("pairs", value)
    if not all(isinstance(p, tuple) and len(p) == 2 for p in pairs.values()):
        return None
    worst = 0.0
    for got, want in pairs.values():
        if key.startswith("train/"):
            got, want = got.double(), want.double()
            worst = max(worst, float((got - want).abs().max() / want.abs()
                                     .max().clamp(min=1e-30)))
        elif got.is_floating_point():
            worst = max(worst, T._scaled_err(got, want))
        elif not torch.equal(got, want):
            worst = float("inf")
    return worst


def _failed(value):
    return isinstance(value, dict) and ("error" in value
                                        or bool(value.get("refused")))


def _report(T, results, log):
    for key in sorted(k for k in results if k != "seconds"):
        value = results[key]
        if key.startswith("ops/"):
            refused = sorted(set(value["refused"]))
            print(("FAIL" if refused else "ok  ") + f" {key} "
                  f"{value['count']} DTensor ops"
                  + "".join(f" | {r}" for r in refused[:5]))
            continue
        if key == "recorder" and "error" not in value:
            print("ok   recorder " + "; ".join(
                f"{probe}: {', '.join(r) or 'none refused'}"
                for probe, r in value.items()))
            continue
        if isinstance(value, dict) and "error" in value:
            lines = value["error"].strip().splitlines()
            frames = [ln.strip() for ln in lines if "repro_torch" in ln]
            print(f"FAIL {key} | {lines[-1][:300]} | "
                  + " <- ".join(frames[-3:]))
            log.write(f"==== {key}\n{value['error']}\n")
            continue
        worst = _worst(T, key, value) if isinstance(value, dict) else None
        print(f"ok   {key}"
              + ("" if worst is None else f" worst error {worst:.3e}"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", default=str(ROOT / "build" / "dist_cases.log"))
    args = ap.parse_args()
    import test_torch_distributed as T
    print("torch", torch.__version__, "cores", os.cpu_count())
    tmp = tempfile.mkdtemp()
    T._make_inputs(os.path.join(tmp, "inputs.npz"))
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    with open(args.log, "w") as log:
        t0 = time.perf_counter()
        try:
            mp.spawn(T._rank_main, args=(tmp,), nprocs=T.WORLD)
        except Exception:                                # noqa: BLE001
            print(f"the world raised:\n{traceback.format_exc()}")
            return 1
        print(f"world: {time.perf_counter() - t0:.1f} s")
        results = torch.load(os.path.join(tmp, "results.pt"),
                             weights_only=False)
        _report(T, results, log)
        failed = any(_failed(v) for v in results.values())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
