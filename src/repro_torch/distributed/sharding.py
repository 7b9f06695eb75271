"""Partition specs for every architecture family x entry point
(``repro.distributed.sharding`` on ``torch.distributed``).

Rules (the reference's, name for name):
  * batch dims -> the data axes ("pod","data" multi-pod / "data" single-pod),
    only when divisible (long_500k has batch 1 -> replicated).
  * attention heads -> "model": KV-head dim when it divides the axis, else
    the q-per-kv group dim, else fall back to row-parallel d_model.
  * MLP hidden -> "model" (column-parallel in, row-parallel out).
  * MoE experts -> "model" (expert parallelism; ``models.moe.moe_ffn_ep``
    matches these specs).
  * Mamba/xLSTM inner dims -> "model" head-aligned.
  * KV caches: KV-head dim when divisible, else the sequence dim ->
    "model" (split-K decode; keeps the 32k-524k caches within HBM).

A spec is the port's ``P``: a tuple with one entry per leading tensor dim,
each ``None``, a mesh-dim name, or a tuple of names (a one-name tuple is
kept as the bare name, as ``jax.sharding.PartitionSpec`` keeps it), so
``tuple(spec)`` compares with the reference's spec. ``to_placements``
turns a spec into DTensor placements on a ``DeviceMesh``; ``shard_tree``
distributes a nested dict of tensors by a tree of specs and
``gather_tree`` undoes it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as ssm_lib


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    Entries past the spec's length are unsharded."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: Tuple[str, ...]
    model: str
    data_size: int
    model_size: int

    @classmethod
    def from_mesh(cls, mesh: DeviceMesh) -> "MeshAxes":
        names = tuple(mesh.mesh_dim_names)
        model = "model" if "model" in names else names[-1]
        data = tuple(n for n in names if n != model)
        dsize = 1
        for a in data:
            dsize *= mesh.size(names.index(a))
        return cls(data=data, model=model, data_size=dsize,
                   model_size=mesh.size(names.index(model)))


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _dax(ax: MeshAxes, n: int):
    return ax.data if _div(n, ax.data_size) else None


def _max(ax: MeshAxes, n: int):
    return ax.model if _div(n, ax.model_size) else None


# ---------------------------------------------------------------------------
# attention / mlp block specs


def needs_fsdp(cfg: ArchConfig, ax: MeshAxes) -> bool:
    """Model-axis sharding alone must leave params under ~4 GiB/device;
    beyond that, weights are additionally sharded over the data axes
    (ZeRO-3 style; DTensor propagation inserts the per-layer all-gathers).

    The port's ``param_count`` differs from the reference's for the audio,
    vlm, hybrid and ssm families (``ArchConfig.param_count``); on the
    registry's architectures both counts fall on the same side of the
    threshold at every mesh the tests take."""
    per_dev = cfg.param_count() * 2.0 / max(ax.model_size, 1)
    return per_dev > 4 * 2**30


def _attn_specs(cfg: ArchConfig, ax: MeshAxes, stacked: bool = True,
                fsdp: bool = False):
    m = ax.model
    K, G = cfg.n_kv_heads, cfg.q_per_kv
    pre = (None,) if stacked else ()
    dd = _dax(ax, cfg.d_model) if fsdp else None      # fsdp axis on d_model
    dh = _dax(ax, cfg.head_dim) if fsdp else None     # fsdp axis on head_dim
    if _div(K, ax.model_size):
        wq = P(*pre, dd, m, None, None)
        wk = P(*pre, dd, m, None)
        wo = P(*pre, m, None, None, dd)
    elif _div(G, ax.model_size):
        wq = P(*pre, dd, None, m, None)
        wk = P(*pre, dd, None, None)         # kv replicated over model
        wo = P(*pre, None, m, None, dd)
    else:                                    # row-parallel fallback on d
        wq = P(*pre, m, None, None, dh)
        wk = P(*pre, m, None, dh)
        wo = P(*pre, None, None, dh, m)
    return {"wq": wq, "wk": wk, "wv": wk, "wo": wo}


def _mlp_specs(cfg: ArchConfig, ax: MeshAxes, d_ff: Optional[int] = None,
               stacked: bool = True, fsdp: bool = False):
    m_ff = _max(ax, d_ff if d_ff is not None else cfg.d_ff)
    dd = _dax(ax, cfg.d_model) if fsdp else None
    pre = (None,) if stacked else ()
    return {"w_gate": P(*pre, dd, m_ff),
            "w_up": P(*pre, dd, m_ff),
            "w_down": P(*pre, m_ff, dd)}


def _block_specs(cfg: ArchConfig, ax: MeshAxes, d_ff: Optional[int] = None,
                 fsdp: bool = False):
    return {"attn": _attn_specs(cfg, ax, fsdp=fsdp),
            "mlp": _mlp_specs(cfg, ax, d_ff, fsdp=fsdp),
            "ln1": P(None, None), "ln2": P(None, None)}


def _embed_spec(cfg: ArchConfig, ax: MeshAxes, fsdp: bool = False):
    dd = _dax(ax, cfg.d_model) if fsdp else None
    return P(_max(ax, cfg.vocab), dd)


# ---------------------------------------------------------------------------
# per-family parameter specs


def param_specs(cfg: ArchConfig, ax: MeshAxes,
                fsdp: Optional[bool] = None) -> Any:
    fam = cfg.family
    fsdp = needs_fsdp(cfg, ax) if fsdp is None else fsdp
    if fam == "dense":
        return {"embed": _embed_spec(cfg, ax, fsdp),
                "layers": _block_specs(cfg, ax, fsdp=fsdp),
                "ln_f": P(None), "head": _embed_spec(cfg, ax, fsdp)}
    if fam == "moe":
        m = ax.model
        fe = _dax(ax, cfg.d_ff) if fsdp else None
        moe = {"router": P(None, None, None),
               "w_gate": P(None, m, None, fe),
               "w_up": P(None, m, None, fe),
               "w_down": P(None, m, fe, None)}
        if cfg.n_shared_experts:
            moe["shared"] = _mlp_specs(
                cfg, ax, d_ff=cfg.d_ff * cfg.n_shared_experts, fsdp=fsdp)
        return {"embed": _embed_spec(cfg, ax, fsdp),
                "layers": {"attn": _attn_specs(cfg, ax, fsdp=fsdp),
                           "moe": moe,
                           "ln1": P(None, None), "ln2": P(None, None)},
                "ln_f": P(None), "head": _embed_spec(cfg, ax, fsdp)}
    if fam == "hybrid":
        di, h, pdim, ci = ssm_lib.mamba_dims(cfg)
        m_di = _max(ax, di)
        m_h = _max(ax, h)
        mamba = {
            "w_z": P(None, None, m_di), "w_x": P(None, None, m_di),
            "w_bc": P(None, None, None), "w_dt": P(None, None, m_h),
            "conv_x_w": P(None, None, m_di), "conv_x_b": P(None, m_di),
            "conv_bc_w": P(None, None, None), "conv_bc_b": P(None, None),
            "A_log": P(None, m_h), "D": P(None, m_h),
            "dt_bias": P(None, m_h), "norm": P(None, m_di),
            "out_proj": P(None, m_di, None),
        }
        shared = {"attn": _attn_specs(cfg, ax, stacked=False, fsdp=fsdp),
                  "mlp": _mlp_specs(cfg, ax, stacked=False, fsdp=fsdp),
                  "ln1": P(None), "ln2": P(None)}
        return {"embed": _embed_spec(cfg, ax), "mamba": mamba,
                "shared": shared, "ln_f": P(None),
                "head": _embed_spec(cfg, ax)}
    if fam == "ssm":
        d = cfg.d_model
        m_d = _max(ax, d)
        m_2d = _max(ax, 2 * d)
        f_ff = max(128, int(d * 4 / 3) // 64 * 64)
        mlstm = {"w_up": P(None, None, m_2d),
                 "wq": P(None, None, m_d), "wk": P(None, None, m_d),
                 "wv": P(None, None, m_d),
                 "w_gate": P(None, None, None),
                 "gate_bias": P(None, None),
                 "w_down": P(None, m_d, None),
                 "ln": P(None, None)}
        hd = cfg.head_dim
        slstm = {"w_in": P(None, None, _max(ax, 4 * d)),
                 "r": P(None, None, None, None, _max(ax, hd)),
                 "bias": P(None, None),
                 "ln": P(None, None), "ln2": P(None, None),
                 "ffn": _mlp_specs(cfg, ax, d_ff=f_ff)}
        return {"embed": _embed_spec(cfg, ax), "mlstm": mlstm,
                "slstm": slstm, "ln_f": P(None),
                "head": _embed_spec(cfg, ax)}
    if fam == "audio":
        return {"embed": _embed_spec(cfg, ax, fsdp),
                "encoder": _block_specs(cfg, ax, fsdp=fsdp),
                "decoder": _block_specs(cfg, ax, fsdp=fsdp),
                "cross": _block_specs(cfg, ax, fsdp=fsdp),
                "ln_f": P(None), "head": _embed_spec(cfg, ax, fsdp)}
    if fam == "vlm":
        return {"embed": _embed_spec(cfg, ax, fsdp),
                "layers": _block_specs(cfg, ax, fsdp=fsdp),
                "cross_layers": _block_specs(cfg, ax, fsdp=fsdp),
                "ln_f": P(None), "head": _embed_spec(cfg, ax, fsdp)}
    raise ValueError(fam)


# ---------------------------------------------------------------------------
# batch / cache specs


def batch_specs(cfg: ArchConfig, batch: int, ax: MeshAxes,
                with_targets: bool = True) -> Any:
    dax = _dax(ax, batch)
    out = {"tokens": P(dax, None)}
    if with_targets:
        out["targets"] = P(dax, None)
    if cfg.family == "audio":
        out["frames"] = P(dax, None, None)
    if cfg.family == "vlm":
        out["image_embeds"] = P(dax, None, None)
    return out


def _kv_spec(cfg: ArchConfig, ax: MeshAxes, batch: int, n_lead: int = 1):
    """(lead..., B, S, K, D): KV-head sharding when divisible, else split-K
    over the sequence dim."""
    dax = _dax(ax, batch)
    lead = (None,) * n_lead
    if _div(cfg.n_kv_heads, ax.model_size):
        return P(*lead, dax, None, ax.model, None)
    return P(*lead, dax, ax.model, None, None)


def cache_specs(cfg: ArchConfig, batch: int, ax: MeshAxes) -> Any:
    fam = cfg.family
    dax = _dax(ax, batch)
    if fam in ("dense", "moe"):
        kv = _kv_spec(cfg, ax, batch)
        return {"k": kv, "v": kv}
    if fam == "audio":
        kv = _kv_spec(cfg, ax, batch)
        # enc_len: per-sequence true encoder length (B,), batch-sharded
        return {"k": kv, "v": kv, "xk": kv, "xv": kv,
                "enc_len": P(_dax(ax, batch))}
    if fam == "vlm":
        kv = _kv_spec(cfg, ax, batch, n_lead=2)
        # the image-token dim (1601) does not divide the mesh: shard KV
        # heads if possible, else replicate over model (it is small)
        xkv = P(None, dax, None,
                ax.model if _div(cfg.n_kv_heads, ax.model_size) else None,
                None)
        return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}
    if fam == "hybrid":
        di, h, pdim, ci = ssm_lib.mamba_dims(cfg)
        kv = _kv_spec(cfg, ax, batch)
        return {"ssm": P(None, dax, _max(ax, h), None, None),
                "conv": P(None, dax, None, None),
                "k": kv, "v": kv}
    if fam == "ssm":
        hd = cfg.head_dim
        return {"mC": P(None, dax, None, _max(ax, hd), None),
                "mn": P(None, dax, None, _max(ax, hd)),
                "mm": P(None, dax, None),
                "sh": P(None, dax, _max(ax, cfg.d_model)),
                "sc": P(None, dax, _max(ax, cfg.d_model)),
                "sn": P(None, dax, _max(ax, cfg.d_model)),
                "sm": P(None, dax, _max(ax, cfg.d_model))}
    raise ValueError(fam)


def opt_state_specs(pspecs: Any) -> Any:
    """AdamW moments mirror the param specs; step is replicated."""
    from repro_torch.training.optimizer import AdamWState
    return AdamWState(step=P(), mu=pspecs, nu=pspecs)


def train_state_specs(cfg: ArchConfig, ax: MeshAxes) -> Any:
    """The reference's train-state spec tree, leaf for leaf: its ``"rng"``
    key is the reference's, not the port's state layout, whose third key
    is ``"gen"`` (a ``torch.Generator`` or None, which is not sharded).
    Place the port's state by ``param_specs`` and ``opt_state_specs``."""
    ps = param_specs(cfg, ax)
    return {"params": ps, "opt": opt_state_specs(ps), "rng": P()}


# ---------------------------------------------------------------------------
# specs -> DTensor placements


def to_placements(mesh: DeviceMesh, spec: P) -> List[Placement]:
    """One placement per mesh dim: ``Shard(d)`` where the spec names the
    mesh dim on tensor dim ``d``, ``Replicate()`` elsewhere. A tuple entry
    such as ``("pod", "data")`` shards dim ``d`` over both mesh dims, the
    first name major (JAX's order), which DTensor's left-to-right order of
    mesh dims gives when the names come in mesh order.

    A mesh dim of size 1 splits nothing: its placement is ``Replicate()``,
    which holds the same local data as ``Shard`` there (a size-1 axis of a
    JAX spec is a no-op too). torch 2.11 refuses a view that flattens a
    dim sharded behind the first of its group even over a size-1 mesh dim,
    as the attention and MLP einsums do (batch with heads, batch with
    sequence), so a 1x1 mesh on such a torch would not run otherwise."""
    names = tuple(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    named = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: axes {group} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if i in named:
                raise ValueError(f"spec {spec!r} names mesh dim "
                                 f"{names[i]!r} twice")
            named.add(i)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def shard_tree(mesh: DeviceMesh, tree: Any, specs: Any) -> Any:
    """``tree`` (a nested dict of tensors, the same on every rank) as
    DTensors placed by the matching tree of specs. Each rank keeps its own
    shard of its own copy: nothing is sent."""
    return _map2(lambda t, s: distribute_tensor(
        t, mesh, to_placements(mesh, s), src_data_rank=None), tree, specs)


def gather_tree(tree: Any) -> Any:
    """The inverse of ``shard_tree``: every DTensor leaf as the whole
    tensor on each rank."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
