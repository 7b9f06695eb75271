"""Autoscaling walkthrough on the PyTorch port: watch INFaaS replicate,
upgrade, and downgrade a model's variants as the load swings (paper Fig.
11 in miniature).

The twin of ``examples/autoscale_demo.py`` on ``repro_torch``. It runs the
control plane on the simulator, so no model runs and no device is needed.
The heavy phase's rate comes from the analytic profile of an H100
(``h100-1``) where the original's comes from a TPU's, and the port's
catalog profiles H100 variants, so its rates, placements and SLO
violations differ from the original's by design.

Run:  PYTHONPATH=src python examples/torch_autoscale_demo.py
"""
from repro_torch.configs.registry import ARCHS
from repro_torch.core import profiler as prof
from repro_torch.core.api import QuerySpec
from repro_torch.sim import hardware as HW
from repro_torch.sim.cluster import make_cluster
from repro_torch.sim.workload import poisson_arrivals

ARCH = ARCHS["llama3.2-1b"]


def snapshot(cluster, t):
    lines = []
    for wname, w in cluster.master.workers.items():
        if not w.alive:
            continue
        insts = [f"{li.variant.name.split('/', 1)[1]} x{li.replicas}"
                 for li in w.instances.values()]
        if insts:
            lines.append(f"    {wname}: {', '.join(insts)}")
    util = {h: f"{u:.2f}" for w in cluster.store.workers.values() if w.alive
            for h, u in w.util.items()}
    print(f"  t={t:5.0f}s util={util}")
    for ln in lines:
        print(ln)


def main(argv=None) -> dict:
    del argv        # no options: the simulator runs no model
    c = make_cluster(n_accel=1, n_cpu=1, archs=[ARCH], autoscale=True)
    peak_b8 = prof.analytic_profile(ARCH, HW.HARDWARE["h100-1"],
                                    "bf16", 8).peak_qps

    # phase 1: light load (CPU should suffice)
    print("== phase 1: light load, relaxed 500ms SLO ==")
    poisson_arrivals(c.loop, lambda t: 4.0,
                     lambda t: c.api.submit(
                         QuerySpec.arch(ARCH.name, latency_ms=500)),
                     t_end=20.0, seed=1)
    c.run_until(20.0)
    snapshot(c, 20)

    # phase 2: heavy load + strict SLO (expect upgrade to batched accel)
    print("== phase 2: heavy load, strict 50ms SLO ==")
    poisson_arrivals(c.loop, lambda t: peak_b8 * 0.45,
                     lambda t: c.api.submit(
                         QuerySpec.arch(ARCH.name, latency_ms=50)),
                     t_end=40.0, seed=2)
    c.run_until(65.0)
    snapshot(c, 65)

    # phase 3: quiet again (expect hysteretic downgrade + idle unload)
    print("== phase 3: load gone (downgrades after hysteresis) ==")
    c.run_until(180.0)
    snapshot(c, 180)

    done = [q for q in c.master.metrics if not q.failed and q.finish >= 0]
    viol = sum(q.violated for q in done)
    print(f"\nserved {len(done)} queries, SLO violations: {viol} "
          f"({viol/max(len(done),1)*100:.1f}%)")
    alive = sum(1 for w in c.store.workers.values() if w.alive)
    print(f"workers alive at end: {alive}")
    return {"served": len(done), "violations": viol, "workers_alive": alive,
            "workers": len(c.store.workers)}


if __name__ == "__main__":
    main()
