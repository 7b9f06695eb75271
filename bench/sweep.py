"""Find an open-loop cell's knee: one set-up, then one window a rate.

    python3 bench/sweep.py --workload <cell> --rates 2,4,6 --seconds 20

Prints, for each offered rate, the rate completed, the TTFT and latency
quantiles, and whether the backlog grew: ``growth``, the median latency
of the queries due in the window's last third over that of its first
third, less 1. The knee is the highest rate swept whose growth reads
under 0.2 in every sweep that ran it (with some tens of queries a third,
rates well below the knee read up to +0.47 from the order of arrivals
alone), and an open-loop cell runs at 0.8 of it. Lines also go to
``chiprun_out/sweep_<cell>.jsonl``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from bench import harness, workload  # noqa: E402


def summary(run, rate):
    lat = [(q.last() - q.due) for q in run.queries if q.last() is not None]
    ttft = [(q.first() - q.due) for q in run.queries
            if q.first() is not None]
    done = [q for q in run.queries
            if q.last() is not None and q.last() < run.t1]
    third = run.seconds / 3

    def med(a, b):
        v = [q.last() - q.due for q in run.queries if q.last() is not None
             and run.t0 + a <= q.due < run.t0 + b]
        return float(np.median(v)) if v else None

    st = run.counters
    steps = st["t1"]["stats.decode_steps"] - st["t0"]["stats.decode_steps"]
    busy = (st["t1"]["stats.busy_slot_steps"]
            - st["t0"]["stats.busy_slot_steps"])
    return {"rate": rate, "sent": len(run.queries),
            "completed_qps": len(done) / run.seconds,
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
            "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "latency_first_third_ms": (med(0, third) or 0) * 1e3,
            "latency_last_third_ms": (med(2 * third, 3 * third) or 0) * 1e3,
            "growth": (med(2 * third, 3 * third) or 0)
            / (med(0, third) or float("nan")) - 1,
            "tokens_per_s": sum(1 for _ in run.tokens_in(run.t0, run.t1))
            / run.seconds,
            "rows_per_step": busy / steps if steps else 0.0,
            "unanswered": sum(not q.ok for q in run.queries)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    import torch
    cell = harness.load_cell(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    vocab = cell.config["vocab_size"]
    lens = {len(r.prompt) for rate in rates for r in workload.draw(
        dict(cell.mix, rate_qps=rate), args.seconds, args.seed, vocab)}
    t = time.monotonic()
    ctx = harness.setup(cell, args.seed, torch.device("cuda"), lens)
    print(f"setup {time.monotonic() - t:.1f} s; card {harness.card_line()}",
          flush=True)
    out = ROOT / "chiprun_out" / f"sweep_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    try:
        for k, rate in enumerate(rates):
            mix = dict(cell.mix, rate_qps=rate)
            reqs = workload.draw(mix, args.seconds, args.seed + k, vocab)
            ctx.cell = harness.dataclasses.replace(cell, mix=mix)
            run = harness.window(ctx, reqs, args.seconds, False, 0.0)
            line = json.dumps(summary(run, rate))
            print(line, flush=True)
            with out.open("a") as f:
                f.write(line + "\n")
    finally:
        harness.teardown(ctx)


if __name__ == "__main__":
    main()
