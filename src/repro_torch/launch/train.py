"""Training launcher of the port (``repro.launch.train``): trains one
architecture on the synthetic data stream on ``--device`` (default CUDA,
which raises without it), at full width unless ``--reduced``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 100 --ckpt /path/to/run

The model runs on the plain impls (the kernels have no backward). This
launcher trains on one device; training on a mesh is
``make_train_step`` over ``build_model(cfg, device, parallel=...)`` with
params placed by ``distributed.sharding.param_specs``. ``--dryrun`` runs
the full config's train step once on the 16x16 production mesh
(``--multi-pod``: 2x16x16) in a fake world and prints its record
(``launch.dryrun.run_cell`` at ``train_4k``):

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-moe-235b-a22b --dryrun --multi-pod
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (cuda raises without a GPU)")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced (CPU-sized) config")
    ap.add_argument("--dryrun", action="store_true",
                    help="run the FULL config's train step once on the "
                         "production mesh in a fake world instead of "
                         "training")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    if args.dryrun:
        import json

        from repro_torch.launch import dryrun as dr
        rec = dr.run_cell(args.arch, "train_4k", args.multi_pod)
        print(json.dumps(rec, indent=2))
        return

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build_model
    from repro_torch.training import data as data_lib
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, train

    cfg = ARCHS[args.arch].reduced() if args.reduced else ARCHS[args.arch]
    model = build_model(cfg, device=args.device)
    dcfg = data_lib.DataConfig(batch=args.batch, seq=args.seq)
    tcfg = TrainConfig(opt=AdamWConfig(total_steps=args.steps))
    out = train(model, dcfg, steps=args.steps, tcfg=tcfg,
                ckpt_dir=args.ckpt, log=print)
    print(f"final loss {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
