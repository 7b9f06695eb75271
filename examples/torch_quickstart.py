"""Quickstart on the PyTorch port: register models, inspect the model-less
registry, and issue queries at all three granularities (variant / arch /
use-case) through the typed QuerySpec/QueryHandle API.

The twin of ``examples/quickstart.py`` on ``repro_torch``. It runs the
control plane on the simulator, so no model runs and no device is needed.
The port's catalog profiles an H100 (``h100-1``) where the original's
profiles a TPU, so its variants, latencies and SLO verdicts differ from
the original's by design.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""
from repro_torch.configs.registry import ARCHS
from repro_torch.core.api import QuerySpec
from repro_torch.sim.cluster import make_cluster


def main(argv=None) -> dict:
    del argv        # no options: the simulator runs no model
    # one accelerator worker + one CPU worker, INFaaS autoscaling on
    cluster = make_cluster(n_accel=1, n_cpu=1,
                           archs=[ARCHS["llama3.2-1b"], ARCHS["yi-9b"],
                                  ARCHS["whisper-base"]])
    api = cluster.api

    print("== model_info (the model-less registry) ==")
    infos = api.model_info(task="text-generation", dataset="openwebtext")
    for info in infos:
        print(f"  {info['arch']}: accuracy={info['accuracy']:.2f}, "
              f"{len(info['variants'])} variants")
        for v in info["variants"][:3]:
            print(f"     e.g. {v['name']}  lat_b1={v['latency_b1_ms']:.2f}ms"
                  f" load={v['load_ms']:.0f}ms mem={v['mem_mb']:.0f}MB")

    print("\n== online queries (QuerySpec -> QueryHandle) ==")
    # 1. use-case granularity: task + dataset + accuracy + latency
    h1 = api.submit(QuerySpec.usecase("text-generation", "openwebtext",
                                      min_accuracy=0.60, latency_ms=50))
    # 2. arch granularity: architecture + latency
    h2 = api.submit(QuerySpec.arch("yi-9b", latency_ms=100))
    # 3. expert granularity: exact variant
    vname = next(iter(cluster.store.registry.variants))
    h3 = api.submit(QuerySpec.variant(vname))
    ok = {}
    for name, h in (("use-case", h1), ("arch", h2), ("variant", h3)):
        # result() pumps the event loop until the query completes
        res = h.result(timeout=60.0)
        ok[name] = not res.failed
        status = "FAILED" if res.failed else f"{res.latency*1e3:.1f} ms"
        verdict = {True: "SLO met", False: "SLO VIOLATED",
                   None: "no SLO"}[res.slo_met]
        print(f"  {name:9s} -> {res.variant:45s} latency={status}")
        print(f"            queue={res.queue*1e3:.1f}ms "
              f"load={res.load*1e3:.1f}ms compute={res.compute*1e3:.1f}ms "
              f"[{verdict}]")

    print("\n== offline (best-effort) query ==")
    hj = api.submit(QuerySpec.arch("llama3.2-1b", mode="offline",
                                   n_inputs=200))
    job = hj.job
    cluster.run_until(cluster.loop.now() + 120.0)
    print(f"  processed {job.processed}/{job.total_inputs} inputs "
          "in slack capacity")

    print("\n== decision overheads recorded by the master ==")
    for mode, needs_load, us in cluster.master.decision_log:
        print(f"  {mode:8s} needs_load={needs_load!s:5s} {us:8.1f} us")
    return {"archs": len(infos), "ok": ok, "processed": job.processed,
            "total_inputs": job.total_inputs,
            "decisions": len(cluster.master.decision_log)}


if __name__ == "__main__":
    main()
