"""Dry-run of every (architecture x input shape x mesh) cell on the
production meshes (``repro.launch.dryrun`` on ``torch.distributed``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8 \\
        --out dryrun.jsonl

The reference lowers and compiles each cell's entry point for 256 or 512
forced host devices and reads XLA's memory and cost analyses. The port
has no compiler between the model and the card, so it runs the entry
point once: on ``meta`` tensors (shapes and placements, no storage, no
device work; ``launch.specs`` says why not fake ones) in a ``"fake"``
process group of 256 ranks
(the 16x16 ``make_production_mesh``) or 512 (2x16x16), as rank 0 of that
world. The mesh is typed ``cuda`` (``launch.mesh``), so DTensor issues
the collectives of a world of cards: a shard moved to another dim is an
all-to-all (on a ``cpu`` mesh, torch 2.13 gathers it whole instead). ``launch.roofline.DeviceCost`` counts what the rank executes: the
FLOPs and bytes of its local ops, the bytes of its collectives, and its
peak live bytes. As in the reference, the attention takes the chunked
plain impl (``"torch_chunked"``; the reference's ``"xla_chunked"``, so the
S x T scores never exist at 32k-524k), the moe family the expert-parallel
lowering, and every other op its plain impl: no kernel lies on a mesh.

A cell's record has the reference's keys: ``arch``, ``shape``, ``mesh``,
``entry_point``, ``status`` (``ok``, ``skipped`` with the reference's
``reason``, or ``error`` with the exception and its traceback),
``devices``, ``bytes_per_device`` (``arguments``: the params, state,
batch and cache a rank holds; ``outputs``; ``temps`` = ``peak`` -
``arguments``; ``peak``), ``cost_per_device`` (``flops``, ``bytes
accessed``: every local op reading its operands and writing its result,
unfused, so an estimate from above of a fused program's),
``collective_bytes_per_device`` by family, ``roofline`` (the reference's
terms over the H100 constants, named in ``constants``) and ``wall_s``.
The reference's ``lower_s`` and ``compile_s`` are one ``trace_s`` here,
the seconds of the run; ``torch`` is the version that ran it. The
reference's ``roofline.hlo_flops_global`` is ``flops_global`` (no HLO),
and its ``--keep-hlo`` has no counterpart.

One process holds one default process group, so a cell on the other mesh
re-creates the world; ``--jobs N`` runs cells in N processes at once, a
fresh one a cell.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch.roofline import (CONSTANTS, DeviceCost,
                                         analytic_compute_s, model_flops,
                                         roofline_terms)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def fake_world(n: int) -> None:
    """This process as rank 0 of a ``"fake"`` world of ``n`` ranks (its
    collectives move nothing); a world of another size is torn down
    first."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    # registers the "fake" backend; a private module of torch
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _local_leaves(tree) -> List[torch.Tensor]:
    from torch.distributed.tensor import DTensor
    out = []
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif dataclasses.is_dataclass(t):
            stack.extend(getattr(t, f.name) for f in dataclasses.fields(t))
        elif isinstance(t, DTensor):
            out.append(t.to_local())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _run_entry(model, shape, ins, mesh):
    """One call of the cell's entry point, its outputs placed as the
    reference's ``out_shardings`` place them."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.layers import as_dtensor
    from repro_torch.training.train_loop import make_train_step
    cfg = model.cfg
    ax = SH.MeshAxes.from_mesh(mesh)
    B = shape.global_batch
    if shape.kind == "train":
        return make_train_step(model)(ins["state"], ins["batch"])
    if shape.kind == "prefill":
        logits, cache = model.prefill(ins["params"], ins["batch"])
    else:
        logits, cache = model.decode(ins["params"], ins["cache"],
                                     ins["token"], ins["pos"])
    logits = logits.redistribute(mesh, SH.to_placements(
        mesh, SH.P(SH._dax(ax, B), None, SH._max(ax, cfg.vocab))))
    cspecs = SH.cache_specs(cfg, B, ax)
    # a leaf the model makes whole (audio's enc_len) is replicated
    cache = {k: as_dtensor(v, mesh).redistribute(
        mesh, SH.to_placements(mesh, cspecs[k])) for k, v in cache.items()}
    return logits, cache


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg=None) -> Dict[str, Any]:
    """Run one cell's entry point on meta tensors on the production mesh
    (``cfg`` overrides ``ARCHS[arch]``) and return its measured fields."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.parallel import ParallelConfig
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import build_model

    shape = SHAPES[shape_name]
    cfg = dataclasses.replace(cfg or ARCHS[arch],
                              attention_impl="torch_chunked")
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    ax = SH.MeshAxes.from_mesh(mesh)
    model = build_model(cfg, "cpu", parallel=ParallelConfig(
        mesh=mesh, data_axes=ax.data, model_axis=ax.model))
    ins = specs_lib.input_specs(model, shape, mesh)
    t0 = time.time()
    with DeviceCost() as cost:
        args = cost.hold(_local_leaves(ins))
        out = _run_entry(model, shape, ins, mesh)
    trace_s = time.time() - t0
    n_dev = mesh.size()
    coll = dict(cost.collective)
    cost_dev = {"flops": float(cost.flops),
                "bytes accessed": float(cost.bytes_accessed)}
    terms = roofline_terms(cost_dev, float(sum(coll.values())), n_dev)
    mf = model_flops(cfg, shape)
    return {
        "trace_s": round(trace_s, 1), "devices": n_dev,
        "torch": torch.__version__,
        "bytes_per_device": {
            "arguments": int(args),
            "outputs": int(_storage_bytes(_local_leaves(out))),
            "temps": int(cost.peak - args), "peak": int(cost.peak)},
        "cost_per_device": cost_dev,
        "collective_bytes_per_device": coll,
        "roofline": {
            "compute_s": terms.compute_s,
            "compute_s_analytic": analytic_compute_s(cfg, shape, n_dev),
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "step_time_s": terms.step_time_s,
            "model_flops": mf,
            "flops_global": terms.flops_global,
            "useful_flops_ratio": mf / terms.flops_global
            if terms.flops_global else 0.0},
        "constants": dict(CONSTANTS)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg=None) -> Dict[str, Any]:
    """The cell's record (the module docstring); an exception is data.
    ``cfg`` overrides ``ARCHS[arch]`` (a reduced width, for tests)."""
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg or ARCHS[arch], shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": _mesh_name(multi_pod),
                           "entry_point": shape.entry_point}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    try:
        rec.update(status="ok",
                   **trace_cell(arch, shape_name, multi_pod, cfg=cfg))
    except Exception as e:  # noqa: BLE001 — a cell failure is data
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def _line(rec: Dict[str, Any]) -> str:
    extra = ""
    if rec["status"] == "ok":
        r = rec["roofline"]
        extra = (f" dominant={r['dominant']}"
                 f" step={r['step_time_s']:.4f}s"
                 f" peak_mem={rec['bytes_per_device']['peak'] / 2**30:.2f}GiB"
                 f" wall={rec['wall_s']}s")
    elif rec["status"] == "error":
        extra = " " + rec["error"][:160]
    return (f"[{rec['status']:7s}] {rec['arch']:24s} {rec['shape']:12s} "
            f"{rec['mesh']:8s}{extra}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (or all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append records to JSONL")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present (ok/skipped) in --out")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    done = set()
    if args.resume and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r["status"] in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes
             if (a, s, _mesh_name(mp)) not in done]

    def emit(rec):
        records.append(rec)
        print(_line(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    records: List[Dict[str, Any]] = []
    if args.jobs <= 1:
        for cell in cells:
            emit(run_cell(*cell))
    else:
        # the longest cells first: prefill_32k (the ssm family's sLSTM
        # steps, then the chunk loop), then training, deeper models first
        cells.sort(key=lambda c: (c[1] != "prefill_32k", c[1] != "train_4k",
                                  ARCHS[c[0]].family != "ssm",
                                  -ARCHS[c[0]].n_layers))
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                    max_tasks_per_child=1) as pool:
            futs = [pool.submit(run_cell, *cell) for cell in cells]
            for fut in cf.as_completed(futs):
                emit(fut.result())
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n{n_ok} ok, {n_skip} skipped (documented), {n_err} errors "
          f"of {len(records)} cells")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
