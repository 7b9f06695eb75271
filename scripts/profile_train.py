#!/usr/bin/env python3
"""Where a training step of llama3.2-1b at full width goes on the card.

    python3 scripts/profile_train.py [--batch 8] [--seq 64] [--impl torch]

Builds llama3.2-1b (bf16, the plain impls, remat on) and its train state
from seed 0 (``training.train_loop.init_train_state``), runs three warm
steps of ``make_train_step`` on ``training.data`` batches, then takes the
step's two halves apart, as ``make_train_step`` runs them: the loss and
its gradients (``train_loop.loss_and_grads``) and the update
(``training.optimizer.adamw_update``). Each half is timed by the host
clock between synchronizations (median of 3) and profiled once with
``torch.profiler``: its device kernel time and that time's share of the
half's unprofiled wall time (the busy share), its kernel count, its GEMM
time (kernels named as cuBLAS/CUTLASS GEMMs) and its five costliest
kernels. Prints one JSON line with the card's name and power limit. Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GEMM_WORDS = ("gemm", "xmma", "nvjet", "cutlass", "wgmma", "cublas")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wall_ms(torch, fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profiled(torch, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            ms = (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    device = sum(by_name.values())
    gemm = sum(v for k, v in by_name.items()
               if any(w in k.lower() for w in GEMM_WORDS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(device_ms=device, kernels=n, gemm_ms=gemm,
                top=[(k, round(v, 3)) for k, v in top])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--impl", default="torch",
                    choices=["torch", "torch_chunked"])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    from repro_torch.training import data as data_lib
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(ARCHS["llama3.2-1b"], attention_impl=args.impl)
    model = build_model(cfg, device=dev)
    tcfg = TrainConfig()
    state = init_train_state(model, 0)
    step = make_train_step(model, tcfg)
    dcfg = data_lib.DataConfig(batch=args.batch, seq=args.seq)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data_lib.batch_at_step(cfg, dcfg, 0).items()}
    for _ in range(3):
        state, _ = step(state, batch)
    grads = {}

    def loss_and_grads():
        grads["g"] = train_loop.loss_and_grads(model, state["params"],
                                               batch)[1]

    def update():
        adamw_update(tcfg.opt, grads["g"], state["opt"], state["params"])

    out = {"card": card(), "batch": args.batch, "seq": args.seq,
           "impl": args.impl, "params": cfg.param_count()}
    step_ms = wall_ms(torch, lambda: step(state, batch))
    for name, fn in (("loss_and_grads", loss_and_grads),
                     ("update", update)):
        wall, prof = wall_ms(torch, fn), profiled(torch, fn)
        out[name] = dict(wall_ms=wall, busy_share=prof["device_ms"] / wall,
                         **prof)
    out["step_ms"] = step_ms
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
