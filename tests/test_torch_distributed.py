"""The port's distributed layer on 4 gloo ranks (CPU, f32, reduced configs):
the expert-parallel MoE and the split-K decode against the reference's
(``repro``'s ``moe_ffn_ep`` and ``decode_attention_splitk`` on a 4-device
host mesh), the split-K dispatch conditions of ``attention_core``, every
family sharded on a (2, 2) mesh against the unsharded port, one train step
on the mesh, the all-to-all count of ``moe_ffn_ep``, and the production
meshes under the ``"fake"`` backend.

One world of 4 rank processes per module (``mp.spawn``, a ``FileStore``
under the module's temp dir, so no port is shared between xdist workers)
runs every case on DTensor's strategy table as a user of
``build_model(parallel=)`` gets it and writes its results; the reference
runs once, beside it, in a subprocess with 4 host devices (``XLA_FLAGS``)
that writes an ``.npz``; the tests read them. Rank processes import no
JAX and take one torch thread. Every wait is bounded (120 s).

Tolerances: ``moe_ffn_ep`` within 1e-5 of the reference's,
``decode_attention_splitk`` within 1e-6; each family's logits, loss and
cache leaves within 1e-5 of the unsharded port, relative to the leaf's
largest magnitude where that exceeds 1 (the hybrid family's SSM states
reach hundreds), and greedy tokens equal; the train step's loss, clip norm
and every updated leaf within 1e-5 relative. The moe family's sharded
run takes ``capacity_factor = n_experts``, a capacity no expert's load can
pass, so neither side drops a token: with capacity from each rank's own
tokens, as the reference computes it, the expert-parallel lowering differs
from the dense one wherever a token is dropped (the ``drop`` case holds
that to the reference's expert-parallel lowering instead).

Which ops reach DTensor's sharding propagation depends on nothing but the
model code, so one check holds the layer to the op kinds that torch 2.11
was seen to refuse on the port's code: a dispatch mode records each op
with a DTensor operand during each family's forward, prefill and decode
and the two train steps, and no op may be ``cummax`` (no sharding rule),
``log_sigmoid_forward``/``_backward`` (no rule for the backward),
``constant_pad_nd`` (an ``IndexError`` in propagation), an
``index``/``index_put`` by a DTensor index (no rule for the embedding's
backward, nor for a batch index sharded over two mesh dims), or a view
that flattens a sharded dim behind the first dim of its group (torch
2.13 takes that as a strided shard; 2.11 refuses it, so such a model
fails on the card machine's torch on any mesh dim larger than 1). An op
of another kind that 2.11 refuses shows only under 2.11
(``scripts/dist_cases.py``). ``_recorder_cases`` runs one op of each
refused kind under the recorder. The products, the lookup, attention,
the losses and the recurrent cells run in local regions for that reason
(``layers.local_region``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

WORLD = 4
WAIT_S = 120
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
MOE_ARCH = "moonshot-v1-16b-a3b"
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# x (B, S, d) per case; capacity_factor None keeps the config's 1.25
EP_CASES = {"seq": (2, 8, None), "s1": (4, 1, None), "drop": (4, 16, 0.25)}
SPLITK = dict(B=2, K=2, G=2, D=16, T=32)      # T_local 8 on the (1, 4) mesh
SPLITK_VALID = (5, 13, 32)                    # 13: shards 3-4 wholly masked
FAMILIES = {"dense": "llama3.2-1b", "moe": MOE_ARCH,
            "hybrid": "zamba2-1.2b", "ssm": "xlstm-1.3b",
            "audio": "whisper-base", "vlm": "llama-3.2-vision-90b"}
FAMILY_B, FAMILY_S, DECODE_ROOM = 2, 4, 4
DISPATCH_CASES = ["reached", "per_slot_lengths", "kv_heads_divide",
                  "seq_not_divisible", "no_context", "plain_impl",
                  "two_token_query", "no_valid_len"]


# ---------------------------------------------------------------------------
# inputs (numpy, seeded), shared by the ranks and the reference


def _make_inputs(path):
    from repro_torch.configs.registry import ARCHS
    rng = np.random.default_rng(0)
    cfg = ARCHS[MOE_ARCH].reduced()
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    fs = f * cfg.n_shared_experts

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    arrs = {"router": w(d, E, fan=d), "w_gate": w(E, d, f, fan=d),
            "w_up": w(E, d, f, fan=d), "w_down": w(E, f, d, fan=f),
            "shared/w_gate": w(d, fs, fan=d), "shared/w_up": w(d, fs, fan=d),
            "shared/w_down": w(fs, d, fan=fs)}
    for case, (B, S, _) in EP_CASES.items():
        arrs[f"x/{case}"] = rng.standard_normal((B, S, d)).astype(np.float32)
    sk = SPLITK
    arrs["q"] = rng.standard_normal(
        (sk["B"], 1, sk["K"], sk["G"], sk["D"])).astype(np.float32)
    for n in ("kc", "vc"):
        arrs[n] = rng.standard_normal(
            (sk["B"], sk["T"], sk["K"], sk["D"])).astype(np.float32)
    np.savez(path, **arrs)


def _moe_params(arrs, to):
    p = {k: to(arrs[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    p["shared"] = {k: to(arrs[f"shared/{k}"])
                   for k in ("w_gate", "w_up", "w_down")}
    return p


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 4 host devices

_ORACLE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import ARCHS
from repro.distributed.parallel import ParallelConfig, activation_sharding_from
from repro.models import layers as L
from repro.models import moe as M

spec = json.loads(sys.argv[3])
arrs = dict(np.load(sys.argv[1]))
out = {}
for name, shape in spec["meshes"].items():
    mesh = jax.make_mesh(tuple(shape), ("data", "model"))
    par = ParallelConfig(mesh=mesh, data_axes=("data",))
    for case, (B, S, cf) in spec["ep"].items():
        cfg = ARCHS[spec["moe"]].reduced()
        if cf is not None:
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        p = {k: jnp.asarray(arrs[k]) for k in
             ("router", "w_gate", "w_up", "w_down")}
        p["shared"] = {k: jnp.asarray(arrs["shared/" + k])
                       for k in ("w_gate", "w_up", "w_down")}
        # jitted: eager shard_map dispatch takes seconds a call
        fn = jax.jit(lambda x, p, cfg=cfg, par=par:
                     M.moe_ffn_ep(x, p, cfg, par))
        y = fn(jnp.asarray(arrs["x/" + case]), p)
        out["ep/%s/%s" % (name, case)] = np.asarray(y)
    if tuple(shape) == (1, 4):
        ctx = activation_sharding_from(par)
        for vl in spec["valid"]:
            fn = jax.jit(lambda q, k, v, vl=vl, ctx=ctx:
                         L.decode_attention_splitk(q, k, v, vl, ctx))
            o = fn(jnp.asarray(arrs["q"]), jnp.asarray(arrs["kc"]),
                   jnp.asarray(arrs["vc"]))
            out["splitk/%d" % vl] = np.asarray(o)
np.savez(sys.argv[2], **out)
"""


def _oracle_cmd(inputs, out):
    spec = {"meshes": MESHES, "ep": EP_CASES, "moe": MOE_ARCH,
            "valid": list(SPLITK_VALID)}
    return [sys.executable, "-c", _ORACLE, inputs, out, json.dumps(spec)]


def _oracle_env():
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


# ---------------------------------------------------------------------------
# the rank processes


def _flattening_groups(src, dst):
    """The groups of ``src``'s dims that a view to ``dst`` merges into one
    dim, size-1 dims left out (a size-1 dim moves no data)."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        start, a, b = i, src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a, i = a * src[i], i + 1
            else:
                b, j = b * dst[j], j + 1
        group = [d for d in range(start, i) if src[d] != 1]
        if len(group) > 1:
            groups.append(group)
    return groups


def _refused_view(t, size):
    """Whether viewing DTensor ``t`` as ``size`` flattens a sharded dim
    behind the first dim of its group."""
    size = list(size)
    if -1 in size:
        known = int(np.prod([n for n in size if n != -1]))
        size[size.index(-1)] = int(np.prod(t.shape)) // max(known, 1)
    sharded = {p.dim for p in t.placements if isinstance(p, Shard)}
    return any(d in sharded for g in _flattening_groups(tuple(t.shape), size)
               for d in g[1:])


class _DTensorOps(TorchDispatchMode):
    """A dispatch mode that records each op with a DTensor operand: their
    count and the ones no torch release propagates alike (the module
    docstring), as strings naming the op."""

    def __init__(self):
        super().__init__()
        self.count, self.refused = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(isinstance(a, DTensor) for a in tree_leaves(args)):
            self.count += 1
            name = func.name()
            if "cummax" in name or "log_sigmoid" in name \
                    or name == "aten::constant_pad_nd":
                self.refused.append(name)
            elif name.startswith("aten::index") and any(
                    isinstance(i, DTensor) for i in tree_leaves(args[1:2])):
                self.refused.append(f"{name} by a DTensor index")
            elif name in ("aten::view", "aten::_unsafe_view") \
                    and isinstance(args[0], DTensor) \
                    and isinstance(args[1], (list, tuple)) \
                    and _refused_view(args[0], args[1]):
                self.refused.append(f"{name} {tuple(args[0].shape)}->"
                                    f"{list(args[1])} {args[0].placements}")
        return func(*args, **(kwargs or {}))


def _recorder_cases(mesh):
    """Each op kind that ``_DTensorOps`` refuses, run on DTensors under
    it, beside an op it takes: the ops each one recorded as refused. An
    op that raises (torch 2.11 refuses some of them) is recorded first."""
    import torch.nn.functional as F
    from torch.distributed.tensor import distribute_tensor

    def dt(shape, pls, grad=False):
        t = torch.arange(float(np.prod(shape))).reshape(shape) / 7 - 2
        return distribute_tensor(t, mesh, pls).requires_grad_(grad)

    def log_sigmoid():
        x = dt((4, 8), [Shard(0), Shard(1)], grad=True)
        y = F.logsigmoid(x)
        torch.autograd.grad(y, x, grad_outputs=torch.ones_like(y))

    def index():
        i = distribute_tensor(torch.tensor([2, 0, 3, 1]), mesh,
                              [Shard(0), Replicate()])
        return dt((4, 8), [Replicate(), Replicate()])[i]
    probes = {
        "cummax": lambda: torch.cummax(dt((4, 8), [Shard(0), Replicate()]),
                                       1),
        "log_sigmoid": log_sigmoid,
        "constant_pad_nd": lambda: F.pad(dt((4, 8), [Shard(0), Shard(1)]),
                                         (1, 0)),
        "index": index,
        "view": lambda: dt((4, 2, 8), [Shard(0), Shard(1)]).view(8, 8),
        "add": lambda: dt((4, 8), [Shard(0), Shard(1)]) + 1}
    out = {}
    for name, fn in probes.items():
        with _DTensorOps() as mode:
            try:
                fn()
            except Exception:                            # noqa: BLE001
                pass
        out[name] = list(mode.refused)
    return out


def _recorded(results, key, fn):
    """``fn()`` under ``_DTensorOps``; adds the ops it recorded to
    ``results[key]``."""
    rec = results.setdefault(key, {"count": 0, "refused": []})
    with _DTensorOps() as mode:
        try:
            return fn()
        finally:
            rec["count"] += mode.count
            rec["refused"] += mode.refused


def _guard(results, key, fn):
    try:
        results[key] = fn()
    except Exception:                                    # noqa: BLE001
        results[key] = {"error": traceback.format_exc()}


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _ep_cases(results, arrs, meshes):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.registry import ARCHS
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.parallel import (ParallelConfig,
                                                  activation_sharding_from)
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    base = ARCHS[MOE_ARCH].reduced()
    plain = _moe_params(arrs, torch.from_numpy)
    for name, mesh in meshes.items():
        par = ParallelConfig(mesh, ("data",))
        ax = SH.MeshAxes.from_mesh(mesh)
        specs = SH.param_specs(base, ax)["layers"]["moe"]
        layer = {k: SH.P(*s[1:]) for k, s in specs.items() if k != "shared"}
        layer["shared"] = {k: SH.P(*s[1:])
                           for k, s in specs["shared"].items()}
        p = SH.shard_tree(mesh, plain, layer)
        for case, (B, S, cf) in EP_CASES.items():
            cfg = base if cf is None else dataclasses.replace(
                base, capacity_factor=cf)
            x = torch.from_numpy(arrs[f"x/{case}"])
            xd = SH.shard_tree(mesh, {"x": x}, {"x": SH.P()})["x"]
            _guard(results, f"ep/{name}/{case}",
                   lambda: _full(MOE.moe_ffn_ep(xd, p, cfg, par)))
            if name == "2x2":
                results[f"dense/{case}"] = MOE.moe_ffn_dense(x, plain, cfg)

        def count():
            x = torch.from_numpy(arrs["x/seq"])
            ctx = activation_sharding_from(par)
            xd = distribute_tensor(x, mesh, L.activation_placements(
                ctx, (ctx.batch(x.shape[0]), par.model_axis, None)),
                src_data_rank=None)
            with CommDebugMode() as comm:
                MOE.moe_ffn_ep(xd, p, base, par)
            return {str(op): n for op, n in comm.get_comm_counts().items()}
        _guard(results, f"comm/{name}", count)


def _splitk_cases(results, arrs, mesh):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.parallel import (ParallelConfig,
                                                  activation_sharding_from,
                                                  using_activation_sharding)
    from repro_torch.models import layers as L

    par = ParallelConfig(mesh, ("data",))
    ctx = activation_sharding_from(par)
    q = torch.from_numpy(arrs["q"])
    kc, vc = torch.from_numpy(arrs["kc"]), torch.from_numpy(arrs["vc"])
    kv_spec = SH.P(None, "model", None, None)
    kv = SH.shard_tree(mesh, {"k": kc, "v": vc}, {"k": kv_spec,
                                                  "v": kv_spec})
    for vl in SPLITK_VALID:
        _guard(results, f"splitk/{vl}", lambda: _full(
            L.decode_attention_splitk(q, kv["k"], kv["v"], vl, ctx)))
        results[f"splitk_plain/{vl}"] = L.attention_core(
            q, kc, vc, causal=False, kv_valid_len=vl)

    # which calls of attention_core take the split-K region
    calls = []
    real = L.decode_attention_splitk

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    B, K, G, D, T = (SPLITK[n] for n in "BKGDT")
    gen = torch.Generator().manual_seed(1)

    def case(name):
        q_, S_, K_, T_ = q, 1, K, T
        vl, impl, with_ctx = 7, "torch_chunked", True
        if name == "per_slot_lengths":
            vl = torch.full((B,), 7)
        elif name == "kv_heads_divide":
            K_ = 4
        elif name == "seq_not_divisible":
            T_ = 30
        elif name == "no_context":
            with_ctx = False
        elif name == "plain_impl":
            impl = "torch"
        elif name == "two_token_query":
            S_ = 2
        elif name == "no_valid_len":
            vl = None
        q_ = torch.randn((B, S_, K_, G, D), generator=gen)
        k_ = torch.randn((B, T_, K_, D), generator=gen)
        v_ = torch.randn((B, T_, K_, D), generator=gen)
        calls.clear()
        L.decode_attention_splitk = spy
        try:
            with using_activation_sharding(ctx if with_ctx else None), \
                    implicit_replication():
                out = _full(L.attention_core(q_, k_, v_, causal=False,
                                             kv_valid_len=vl, impl=impl))
        finally:
            L.decode_attention_splitk = real
        want = L.attention_core(q_, k_, v_, causal=False, kv_valid_len=vl)
        return {"reached": bool(calls),
                "err": float((out - want).abs().max())}

    for name in DISPATCH_CASES:
        _guard(results, f"dispatch/{name}", lambda: case(name))


def _family_batch(cfg, rng):
    B, S = FAMILY_B, FAMILY_S
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)) \
            .astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _family_cfg(family):
    from repro_torch.configs.registry import ARCHS
    cfg = dataclasses.replace(ARCHS[FAMILIES[family]].reduced(),
                              attention_impl="torch_chunked")
    if family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


def _contiguous_cache(model, prefill_cache):
    """An empty contiguous cache with room for DECODE_ROOM more tokens,
    the prompt's leaves written at its start."""
    B, S = FAMILY_B, FAMILY_S
    cache = model.empty_state(B, S + DECODE_ROOM, enc_len=S)
    for name, leaf in prefill_cache.items():
        dst = cache[name]
        if dst.shape == leaf.shape:
            dst.copy_(leaf)
        else:
            ax = next(i for i in range(dst.ndim)
                      if dst.shape[i] != leaf.shape[i])
            dst.narrow(ax, 0, leaf.shape[ax]).copy_(leaf)
    return cache


def _family_cases(results, mesh):
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.parallel import ParallelConfig
    from repro_torch.models.model import build_model

    par = ParallelConfig(mesh, ("data",))
    ax = SH.MeshAxes.from_mesh(mesh)
    B, S = FAMILY_B, FAMILY_S
    for family in FAMILIES:
        cfg = _family_cfg(family)
        m0 = build_model(cfg, "cpu")
        m1 = build_model(cfg, "cpu", parallel=par)
        params = m0.init(0)
        batch = _family_batch(cfg, np.random.default_rng(7))
        bspec = SH.batch_specs(cfg, B, ax)
        sb = SH.shard_tree(mesh, batch, bspec)
        nt = {k: v for k, v in batch.items() if k != "targets"}
        snt = {k: v for k, v in sb.items() if k != "targets"}
        ref_fwd = m0.forward(params, batch)
        ref_loss = m0.loss(params, batch)
        ref_logits, ref_cache = m0.prefill(params, nt)
        tok = torch.argmax(ref_logits[:, -1], -1).to(torch.int32)[:, None]
        pos = torch.full((B,), S, dtype=torch.int32)
        ref_dcache = _contiguous_cache(m0, ref_cache)
        start_cache = {k: v.clone() for k, v in ref_dcache.items()}
        ref_dlogits, _ = m0.decode(params, ref_dcache, tok, pos)
        for fsdp in (False, True):
            key = f"family/{family}/{'fsdp' if fsdp else 'nofsdp'}"

            def run():
                sp = SH.shard_tree(mesh, params,
                                   SH.param_specs(cfg, ax, fsdp=fsdp))
                out = {"forward": (_full(m1.forward(sp, sb)), ref_fwd),
                       "loss": (_full(m1.loss(sp, sb)), ref_loss)}
                logits, cache = m1.prefill(sp, snt)
                out["prefill"] = (_full(logits), ref_logits)
                for name, leaf in cache.items():
                    out[f"prefill_cache/{name}"] = (_full(leaf),
                                                    ref_cache[name])
                dc = SH.shard_tree(
                    mesh, {k: v.clone() for k, v in start_cache.items()},
                    SH.cache_specs(cfg, B, ax))
                dlogits, dc = m1.decode(sp, dc, tok, pos)
                out["decode"] = (_full(dlogits), ref_dlogits)
                for name, leaf in dc.items():
                    out[f"decode_cache/{name}"] = (_full(leaf),
                                                   ref_dcache[name])
                return out
            _guard(results, key, lambda: _recorded(
                results, f"ops/{family}", run))


def _train_cases(results, mesh, families=("dense", "moe")):
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.parallel import ParallelConfig
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.tree import leaves

    par = ParallelConfig(mesh, ("data",))
    ax = SH.MeshAxes.from_mesh(mesh)
    # warmup 0 and a low clip, so the step moves every leaf and the clip
    # scale is below 1. Adam's first update is g / (|g| + eps): at the
    # default eps 1e-8 it is sign(g) but for the smallest gradients, which
    # turns a reduction-order difference of a gradient near 0 into an
    # update difference of up to 2 lr (test_torch_training's docstring);
    # eps 1e-3 keeps the update a smooth function of the gradient, so a
    # relative bound on every leaf holds the gradient and the update
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, eps=1e-3, warmup_steps=0,
                                       grad_clip=0.05))
    for family in families:
        cfg = _family_cfg(family)

        def run():
            m0 = build_model(cfg, "cpu")
            m1 = build_model(cfg, "cpu", parallel=par)
            batch = _family_batch(cfg, np.random.default_rng(11))
            params = m0.init(0)
            # a second init: the step updates both trees in place, and a
            # replicated shard may share its storage with its source
            sp = SH.shard_tree(mesh, m0.init(0), SH.param_specs(cfg, ax))
            s0 = {"params": params, "opt": adamw_init(params), "gen": None}
            s1 = {"params": sp, "opt": adamw_init(sp), "gen": None}
            ospec = SH.opt_state_specs(SH.param_specs(cfg, ax))
            placed = all(tuple(m.placements) == tuple(
                SH.to_placements(mesh, dict(leaves(ospec.mu))[k]))
                for k, m in leaves(s1["opt"].mu))
            s0, met0 = make_train_step(m0, tcfg)(s0, batch)
            sb = SH.shard_tree(mesh, batch, SH.batch_specs(cfg,
                                                           FAMILY_B, ax))
            s1, met1 = make_train_step(m1, tcfg)(s1, sb)
            out = {"loss": (_full(met1["loss"]), met0["loss"]),
                   "grad_norm": (_full(met1["grad_norm"]),
                                 met0["grad_norm"])}
            for tree in ("params", "mu", "nu"):
                a = s1["params"] if tree == "params" else \
                    getattr(s1["opt"], tree)
                b = s0["params"] if tree == "params" else \
                    getattr(s0["opt"], tree)
                fb = dict(leaves(b))
                for k, v in leaves(a):
                    out[f"{tree}/{k}"] = (_full(v), fb[k])
            return {"pairs": out, "moments_placed": placed}
        _guard(results, f"train/{family}", lambda: _recorded(
            results, f"ops/train_{family}", run))


def _mesh_cases(results):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    def raised(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None
    results["mesh/wrong_world"] = {
        "production": raised(make_production_mesh),
        "multi_pod": raised(lambda: make_production_mesh(multi_pod=True)),
        "host": raised(make_host_mesh)}


def _rank_main(rank, tmp):
    """One rank of the world: every case, on DTensor's strategy table as
    it comes."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    from torch.distributed.device_mesh import init_device_mesh
    meshes = {name: init_device_mesh("cpu", shape,
                                     mesh_dim_names=("data", "model"))
              for name, shape in MESHES.items()}
    results = {"seconds": {}}
    arrs = dict(np.load(os.path.join(tmp, "inputs.npz")))
    sections = [
        ("ep", lambda: _ep_cases(results, arrs, meshes)),
        ("splitk", lambda: _splitk_cases(results, arrs, meshes["1x4"])),
        ("families", lambda: _family_cases(results, meshes["2x2"])),
        ("train", lambda: _train_cases(results, meshes["2x2"])),
        ("recorder", lambda: _guard(
            results, "recorder", lambda: _recorder_cases(meshes["2x2"]))),
        ("mesh", lambda: _mesh_cases(results))]
    for name, run in sections:
        t0 = time.perf_counter()
        run()
        results["seconds"][name] = time.perf_counter() - t0
    if rank == 0:
        torch.save(results, os.path.join(tmp, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the module's world and reference


_FAKE = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
n = int(sys.argv[1])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
from repro_torch.launch.mesh import make_production_mesh
m = make_production_mesh(multi_pod=n == 512)
print(json.dumps({"shape": list(m.shape), "names": list(m.mesh_dim_names),
                  "device": m.device_type}))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    _make_inputs(os.path.join(tmp, "inputs.npz"))
    deadline = time.monotonic() + WAIT_S
    oracle = subprocess.Popen(
        _oracle_cmd(os.path.join(tmp, "inputs.npz"),
                    os.path.join(tmp, "oracle.npz")),
        env=_oracle_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    fakes = {n: subprocess.Popen([sys.executable, "-c", _FAKE, str(n)],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for n in (256, 512)}
    ctx = mp.spawn(_rank_main, args=(tmp,), nprocs=WORLD, join=False)
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the gloo world ran past {WAIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = {}
    for name, proc in [("oracle", oracle)] + [(f"fake/{n}", p)
                                               for n, p in fakes.items()]:
        stdout, _ = proc.communicate(
            timeout=max(deadline - time.monotonic(), 1.0))
        out[name] = (proc.returncode, stdout.decode())
    assert out["oracle"][0] == 0, out["oracle"][1]
    results = torch.load(os.path.join(tmp, "results.pt"), weights_only=False)
    results["oracle"] = dict(np.load(os.path.join(tmp, "oracle.npz")))
    for n in fakes:
        code, text = out[f"fake/{n}"]
        results[f"fake/{n}"] = json.loads(text.strip().splitlines()[-1]) \
            if code == 0 else {"error": text}
    return results


def _ok(results, key):
    r = results[key]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(f"{key} raised on rank 0:\n{r['error']}")
    return r


def _scaled_err(got, want):
    """max |got - want|, relative to max |want| where that exceeds 1."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


# ---------------------------------------------------------------------------
# expert-parallel MoE and split-K decode against the reference


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(EP_CASES))
def test_moe_ffn_ep_matches_reference(world, case, mesh):
    got = _ok(world, f"ep/{mesh}/{case}").numpy()
    want = world["oracle"][f"ep/{mesh}/{case}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if case == "drop":
        # local capacity drops tokens that the dense lowering's capacity
        # (from every token) keeps: the two differ, as the reference's do
        dense = world[f"dense/{case}"].numpy()
        assert np.abs(got - dense).max() > 1e-3


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_ffn_ep_issues_two_all_to_alls(world, mesh):
    counts = _ok(world, f"comm/{mesh}")
    a2a = {op: n for op, n in counts.items() if "all_to_all" in op}
    assert sum(a2a.values()) == 2, counts


@pytest.mark.parametrize("valid_len", SPLITK_VALID)
def test_decode_attention_splitk_matches_reference(world, valid_len):
    got = _ok(world, f"splitk/{valid_len}").numpy()
    want = world["oracle"][f"splitk/{valid_len}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got, world[f"splitk_plain/{valid_len}"].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_attention_core_takes_splitk_only_under_reference_conditions(
        world, case):
    r = _ok(world, f"dispatch/{case}")
    assert r["reached"] == (case == "reached"), case
    assert r["err"] <= 1e-6, r


# ---------------------------------------------------------------------------
# every family sharded on (2, 2) against the unsharded port


@pytest.mark.parametrize("fsdp", ["nofsdp", "fsdp"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_sharded_matches_unsharded(world, family, fsdp):
    pairs = _ok(world, f"family/{family}/{fsdp}")
    for what in ("forward", "loss", "prefill", "decode"):
        assert what in pairs, what
    for what, (got, want) in pairs.items():
        assert got.shape == want.shape, what
        if not got.is_floating_point():
            assert torch.equal(got, want), what
            continue
        assert _scaled_err(got, want) <= 1e-5, (what, _scaled_err(got,
                                                                  want))
    got, want = pairs["decode"]
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def _check_train(r):
    assert r["moments_placed"]
    pairs = r["pairs"]
    assert float(pairs["grad_norm"][1]) > 0.05        # the clip engaged
    for what, (got, want) in pairs.items():
        rel = float((got.double() - want.double()).abs().max()
                    / want.double().abs().max().clamp(min=1e-30))
        assert rel <= 1e-5, (what, rel)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_train_step_on_mesh_matches_unsharded(world, family):
    _check_train(_ok(world, f"train/{family}"))


def test_train_step_on_default_strategy_table_matches_unsharded(world):
    """The dense train step (forward, loss, backward, AdamW) on DTensor's
    strategy table as it comes, which every case of the world takes."""
    _check_train(_ok(world, "train/dense"))


@pytest.mark.parametrize("case", sorted(FAMILIES) + ["train_dense",
                                                     "train_moe"])
def test_mesh_ops_propagate_on_every_torch(world, case):
    """No op that reaches DTensor dispatch is one that torch 2.11 refuses
    (the module docstring): each family's forward, prefill and decode
    without and with FSDP, and the dense and moe train steps, on (2, 2)."""
    rec = world[f"ops/{case}"]
    assert rec["count"] > 0
    assert rec["refused"] == [], sorted(set(rec["refused"]))[:10]


@pytest.mark.parametrize("probe,refused", [
    ("cummax", ["aten::cummax"]),
    ("log_sigmoid", ["aten::log_sigmoid_forward",
                     "aten::log_sigmoid_backward"]),
    ("constant_pad_nd", ["aten::constant_pad_nd"]),
    ("index", ["aten::index.Tensor by a DTensor index"]),
    ("view", ["aten::view (4, 2, 8)->[8, 8]"]),
    ("add", []),
])
def test_recorder_refuses_each_kind(world, probe, refused):
    """``_DTensorOps`` on one op of each refused kind, run on DTensors on
    (2, 2) in the rank processes (``_recorder_cases``), and on an op it
    takes: each refused op is recorded under its name."""
    got = _ok(world, "recorder")[probe]
    assert [r for r in got if not any(r.startswith(w) for w in refused)] \
        == [], got
    assert all(any(r.startswith(w) for r in got) for w in refused), got


@pytest.mark.parametrize("src,dst,placements,refused", [
    ((4, 2, 8), (8, 8), ("S0", "S1"), True),      # K behind B
    ((4, 2, 8), (8, 8), ("R", "S1"), True),       # K behind a whole B
    ((4, 2, 8), (8, 8), ("S0", "R"), False),      # the first dim sharded
    ((4, 2, 8), (4, 16), ("S0", "S1"), False),    # (2, 8): 2 is first
    ((4, 2, 8), (4, 16), ("R", "S2"), True),      # 8 behind 2
    ((4, 1, 8), (4, 8), ("R", "S2"), False),      # a size-1 dim moves nothing
    ((4, 16), (4, 2, 8), ("R", "S1"), False),     # a split
])
def test_refused_view_rule(src, dst, placements, refused):
    """``_refused_view`` on the shapes of the attention and projection
    einsums, without a world (placements are read, not applied)."""
    t = types.SimpleNamespace(shape=src, placements=[
        Replicate() if p == "R" else Shard(int(p[1])) for p in placements])
    assert _refused_view(t, dst) == refused


# ---------------------------------------------------------------------------
# meshes


@pytest.mark.parametrize("n", [256, 512])
def test_make_production_mesh_under_fake_backend(world, n):
    r = world[f"fake/{n}"]
    assert "error" not in r, r.get("error")
    if n == 256:
        assert r["shape"] == [16, 16] and r["names"] == ["data", "model"]
    else:
        assert r["shape"] == [2, 16, 16]
        assert r["names"] == ["pod", "data", "model"]


def test_meshes_refuse_a_world_of_the_wrong_size(world):
    r = world["mesh/wrong_world"]
    assert "256" in r["production"] and "4" in r["production"]
    assert "512" in r["multi_pod"]
    assert "1 ranks" in r["host"]
