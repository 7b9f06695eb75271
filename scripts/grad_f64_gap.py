#!/usr/bin/env python3
"""How far f32 gradients lie from f64 ones, on the CPU, per family.

    python3 scripts/grad_f64_gap.py [arch ...]   (default: every family)

For each arch, reduced, on the params of ``init(0)`` and the batch of
``training.data.batch_at_step(cfg, DataConfig(batch=2, seq=32), 0)``
(``chip_smoke.py`` phase 12 (c)'s inputs), takes the loss and every grad
leaf twice on the CPU: as the model runs (f32), and with every f32 in the
model code promoted to f64 (``torch.float32``, ``Tensor.float`` and the
config's dtype all mean f64 for that call; the params are the same values
widened). Prints, per arch, the worst grad error of the f32 run as a share
of its leaf's largest f64 magnitude, the leaf it is at, and the loss's
relative gap: the rounding that a card-against-CPU check in f32 has to
leave room for. Runs in a few seconds per arch.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FAMILIES = ["llama3.2-1b", "moonshot-v1-16b-a3b", "zamba2-1.2b",
            "xlstm-1.3b", "whisper-base", "llama-3.2-vision-90b"]


@contextlib.contextmanager
def f32_means_f64():
    from repro_torch.models import transformer as T
    saved = (torch.float32, torch.Tensor.float, T.DTYPES["float32"])
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    T.DTYPES["float32"] = torch.float64
    try:
        yield
    finally:
        torch.float32, torch.Tensor.float, T.DTYPES["float32"] = saved


def gap(arch: str):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    from repro_torch.training import data as data_lib
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.tree import leaves, tree_map
    cfg = ARCHS[arch].reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    batch = {k: torch.from_numpy(v) for k, v in data_lib.batch_at_step(
        cfg, data_lib.DataConfig(batch=2, seq=32), 0).items()}
    l32, g32 = loss_and_grads(model, params, batch)
    wide = tree_map(lambda t: t.double() if t.is_floating_point() else t,
                    params)
    with f32_means_f64():
        l64, g64 = loss_and_grads(model, wide, batch)
    g32, g64 = dict(leaves(g32)), dict(leaves(g64))
    assert all(g.dtype == torch.float64 for g in g64.values()), arch
    worst, at = 0.0, None
    for k, g in g64.items():
        scale = float(g.abs().max())
        err = float((g32[k].double() - g).abs().max())
        share = err / scale if scale > 0 else 0.0
        if share >= worst:
            worst, at = share, k
    return worst, at, abs(float(l32) - float(l64)) / abs(float(l64))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*", default=FAMILIES)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for arch in args.archs:
        worst, at, rel = gap(arch)
        print(f"{arch}: f32 grads against f64, worst {worst:.3e} of the "
              f"leaf's scale at {at}; loss rel {rel:.2e}")


if __name__ == "__main__":
    main()
