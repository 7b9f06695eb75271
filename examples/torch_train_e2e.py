"""End-to-end training driver on the PyTorch port: train a reduced llama
config for a few hundred steps with checkpoint/restart (the train_4k
substrate in miniature).

The twin of ``examples/train_e2e.py`` on ``repro_torch``. It trains the
registry's ``.reduced()`` config on ``--device``: CUDA by default, which
raises without a card; ``--device cpu`` runs on the CPU. Training runs
the plain PyTorch impls on either (the kernels have no backward).

Run:  PYTHONPATH=src python examples/torch_train_e2e.py [--steps 200]
      [--device cpu]
"""
import argparse
import tempfile

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS
from repro_torch.models import build_model
from repro_torch.training import data as data_lib
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ARCHS[args.arch].reduced()
    model = build_model(cfg, dev)
    dcfg = data_lib.DataConfig(batch=8, seq=64, seed=0)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=20,
                                       total_steps=args.steps),
                       ckpt_every=50, log_every=20)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train(model, dcfg, steps=args.steps, tcfg=tcfg,
                    ckpt_dir=ckpt_dir, log=print)
        print(f"\nfinal loss: {out['losses'][-1]:.4f} "
              f"(start {out['losses'][0]:.4f})")
        # restart from the last checkpoint to prove restore works
        out2 = train(model, dcfg, steps=args.steps, tcfg=tcfg,
                     ckpt_dir=ckpt_dir, log=lambda s: None)
        print(f"restart resumed from step {out2['resumed_from']}")
    return {"steps": len(out["losses"]), "first_loss": out["losses"][0],
            "final_loss": out["losses"][-1],
            "resumed_from": out2["resumed_from"],
            "steps_after_restart": len(out2["losses"])}


if __name__ == "__main__":
    main()
