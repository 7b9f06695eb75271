#!/usr/bin/env python3
"""Where a dry-run cell's counts come from: ``DeviceCost`` per op and per
DTensor redistribution, for one cell, under whatever torch is installed.

    PYTHONPATH=src python3 scripts/dryrun_ops.py ARCH SHAPE [--multi-pod] \\
        --out cell.json
    python3 scripts/dryrun_ops.py --diff a.json b.json

The first form runs ``launch.dryrun.run_cell`` with the counter wrapped,
and writes the cell's record beside: the bytes accessed and the calls of
each op, the collective bytes of each op, the op at which the peak was
last raised, and the collective bytes of each redistribution (source and
target placements, local shape, the op whose propagation asked for it or
``api.redistribute`` for an explicit one, and the innermost model frame,
``backward`` where there is none). The second prints the largest
differences between two such files (two torch releases, two trees).
Wraps private torch functions (``_redistribute.redistribute_local_tensor``):
a diagnostic, not part of the dry-run.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _frame(skip=("launch", "train_loop")):
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename
              and not any(s in f.filename for s in skip)]
    if not frames:
        return "backward"
    f = frames[-1]
    return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"


def trace(arch: str, shape: str, multi_pod: bool) -> dict:
    import torch
    import torch.distributed.tensor._api as dt_api
    import torch.distributed.tensor._dispatch as dt_dispatch
    import torch.distributed.tensor._redistribute as dt_redist

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R

    by_bytes, by_n = collections.Counter(), collections.Counter()
    by_coll = collections.Counter()
    redist, redist_n = collections.Counter(), collections.Counter()
    peak_at, current = {}, {}
    dispatch, enter = R.DeviceCost.__torch_dispatch__, R.DeviceCost.__enter__

    def counted(self, func, types, args=(), kwargs=None):
        b0, p0 = self.bytes_accessed, self.peak
        c0 = sum(self.collective.values())
        out = dispatch(self, func, types, args, kwargs)
        if out is NotImplemented:
            return out
        name = func.name()
        if self.bytes_accessed != b0:
            by_bytes[name] += self.bytes_accessed - b0
            by_n[name] += 1
        c1 = sum(self.collective.values())
        if c1 != c0:
            by_coll[name] += c1 - c0
        if self.peak != p0:
            peak_at.update(op=name, peak=self.peak, n_live=len(self._live),
                           shapes=[list(a.shape) for a in args
                                   if torch.is_tensor(a)])
        return out

    def entered(self):
        current["cost"] = self
        return enter(self)

    move = dt_redist.redistribute_local_tensor

    def moved(local, src, dst, *a, **k):
        cost = current.get("cost")
        c0 = sum(cost.collective.values()) if cost else 0
        out = move(local, src, dst, *a, **k)
        c1 = sum(cost.collective.values()) if cost else 0
        if c1 != c0:
            op, f = "api.redistribute", sys._getframe(1)
            while f is not None:
                info = f.f_locals.get("op_info")
                if info is not None and getattr(info, "schema", None):
                    op = str(info.schema.op)
                    break
                f = f.f_back
            key = (f"{tuple(str(p) for p in src.placements)}->"
                   f"{tuple(str(p) for p in dst.placements)} "
                   f"{list(local.shape)} {op} @{_frame()}")
            redist[key] += c1 - c0
            redist_n[key] += 1
        return out

    R.DeviceCost.__torch_dispatch__ = counted
    R.DeviceCost.__enter__ = entered
    for mod in (dt_redist, dt_dispatch, dt_api):
        if hasattr(mod, "redistribute_local_tensor"):
            mod.redistribute_local_tensor = moved
    t0 = time.time()
    rec = D.run_cell(arch, shape, multi_pod)
    rec.pop("traceback", None)
    return {"torch": torch.__version__, "rec": rec,
            "bytes_by_op": dict(by_bytes.most_common()),
            "n_by_op": dict(by_n), "coll_by_op": dict(by_coll),
            "redist": {k: [v, redist_n[k]]
                       for k, v in redist.most_common(40)},
            "peak_at": peak_at, "s": time.time() - t0}


def diff(a: dict, b: dict, n: int = 6) -> None:
    print(f"{a['torch']} against {b['torch']}")
    for key in ("collective_bytes_per_device", "bytes_per_device",
                "cost_per_device"):
        print(f"  {key}: {a['rec'].get(key)}\n  {' ' * len(key)}  "
              f"{b['rec'].get(key)}")
    print(f"  peak at: {a['peak_at']}\n           {b['peak_at']}")
    for what in ("bytes_by_op", "redist"):
        def get(d, k):
            v = d[what].get(k, 0)
            return v[0] if isinstance(v, list) else v
        keys = set(a[what]) | set(b[what])
        rows = sorted(((get(a, k) - get(b, k)), k) for k in keys)
        for d, k in rows[:n] + rows[-n:]:
            if d:
                print(f"  {what} {d:+.4e} {k}: {a[what].get(k)} / "
                      f"{b[what].get(k)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", nargs="?")
    ap.add_argument("shape", nargs="?")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.diff:
        a, b = (json.loads(Path(p).read_text()) for p in args.diff)
        diff(a, b)
        return 0
    res = trace(args.arch, args.shape, args.multi_pod)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    rec = res["rec"]
    print(rec["status"], rec.get("error", ""), rec.get("bytes_per_device"),
          rec.get("cost_per_device"), rec.get("collective_bytes_per_device"))
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
