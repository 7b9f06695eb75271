"""Multi-tenant sharing + fault tolerance on the PyTorch port: two tenants
share workers and models; offline work fills the slack; a worker failure
is detected via heartbeats and queries are re-dispatched.

The twin of ``examples/multi_tenant.py`` on ``repro_torch``. It runs the
control plane on the simulator, so no model runs and no device is needed.
The port's catalog profiles an H100 (``h100-1``) where the original's
profiles a TPU, so its counts and SLO violations differ from the
original's by design.

Run:  PYTHONPATH=src python examples/torch_multi_tenant.py
"""
from repro_torch.configs.registry import ARCHS
from repro_torch.core.api import QuerySpec
from repro_torch.sim.cluster import make_cluster
from repro_torch.sim.workload import poisson_arrivals


def main(argv=None) -> dict:
    del argv        # no options: the simulator runs no model
    c = make_cluster(n_accel=2, n_cpu=1,
                     archs=[ARCHS["llama3.2-1b"], ARCHS["yi-9b"]],
                     autoscale=True)

    # tenant A: latency-sensitive llama traffic; tenant B: accurate yi-9b
    poisson_arrivals(c.loop, lambda t: 40.0,
                     lambda t: c.api.submit(QuerySpec.arch(
                         "llama3.2-1b", latency_ms=50, user="tenantA")),
                     t_end=60.0, seed=1)
    poisson_arrivals(c.loop, lambda t: 10.0,
                     lambda t: c.api.submit(QuerySpec.usecase(
                         "text-generation", "openwebtext",
                         min_accuracy=0.71, latency_ms=200,
                         user="tenantB")),
                     t_end=60.0, seed=2)
    # tenant B also runs an offline batch job in the slack
    job = c.api.submit(QuerySpec.arch("yi-9b", mode="offline",
                                      n_inputs=400, user="tenantB")).job

    c.run_until(25.0)
    # kill a worker mid-run: heartbeats stop, master re-routes
    victim = next(iter(c.master.workers))
    print(f"t=25s: injecting failure on {victim}")
    c.master.fail_worker(victim)
    c.run_until(120.0)

    done = [q for q in c.master.metrics if q.kind == "online"]
    ok = [q for q in done if not q.failed]
    by_arch = {}
    for q in ok:
        by_arch.setdefault(q.variant.split("/")[0], []).append(q)
    print(f"\nonline queries completed: {len(ok)}/{len(done)} "
          f"(failures re-dispatched transparently)")
    for arch, qs in by_arch.items():
        viol = sum(q.violated for q in qs)
        print(f"  {arch}: {len(qs)} served, {viol} SLO violations")
    print(f"offline progress: {job.processed}/{job.total_inputs}")
    dead = [n for n, w in c.store.workers.items() if not w.alive]
    alive = [n for n, w in c.store.workers.items() if w.alive]
    print(f"dead workers: {dead}")
    print(f"workers alive: {alive}")
    # accuracy isolation: tenant B's use-case queries must have hit yi-9b
    b_queries = [q for q in ok if q.variant.startswith("yi-9b")]
    print(f"tenant-B accuracy-bound queries served by yi-9b: "
          f"{len(b_queries)}")
    tenant_b = [q for q in ok if q.user == "tenantB"]
    return {"victim": victim, "dead": dead, "alive": alive,
            "online": len(done), "completed": len(ok),
            "served_by_arch": {a: len(qs) for a, qs in by_arch.items()},
            "offline_processed": job.processed,
            "tenant_b": len(tenant_b),
            "tenant_b_on_yi9b": sum(q.variant.startswith("yi-9b")
                                    for q in tenant_b),
            "yi9b": len(b_queries)}


if __name__ == "__main__":
    main()
