"""The readings a cell's check limit is set from: the program's widest
served-token gap below the plain reference's best logit, and the
control's (the reference one precision lower in the program's place:
int8 weights for a bf16 configuration, int4 for an int8 one), on many
traffic seeds in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 15

One set-up (weights from ``--weights-seed``), then per seed one window at
the cell's own load and the readings of its sample. Lines also go to
``chiprun_out/calibrate_<cell>.jsonl``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, workload  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--weights-seed", type=int, default=2 ** 31 + 5)
    args = ap.parse_args()
    import torch
    dev = torch.device("cuda")
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    vocab = cell.config["vocab_size"]
    draws = {s: workload.draw(cell.mix, args.seconds, s, vocab)
             for s in seeds}
    lens = {len(r.prompt) for d in draws.values() for r in d}
    t = time.monotonic()
    ctx = harness.setup(cell, args.weights_seed, dev, lens)
    print(f"setup {time.monotonic() - t:.1f} s; card {harness.card_line()}",
          flush=True)
    out = ROOT / "chiprun_out" / f"calibrate_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    try:
        for s in seeds:
            run = harness.window(ctx, draws[s], args.seconds, False, 0.0)
            t = time.monotonic()
            read = harness.gap_readings(run, ctx.params, dev, s, control=True)
            line = json.dumps(dict(
                seed=s, weights_seed=args.weights_seed, **read,
                unanswered=sum(not q.ok for q in run.queries),
                sent=len(run.queries),
                tokens=sum(len(q.outputs) for q in harness.sample(run, s)),
                reference_s=time.monotonic() - t))
            print(line, flush=True)
            with out.open("a") as f:
                f.write(line + "\n")
    finally:
        harness.teardown(ctx)


if __name__ == "__main__":
    main()
