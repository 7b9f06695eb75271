"""Plain float32 reference of the dense decoder, and the seeded weights.

Written from the published layer equations (pre-norm decoder, RMSNorm with
a ``1 + scale`` gain, rotary embeddings on the two halves of each head,
grouped-query causal softmax attention, SwiGLU MLP, untied head), not from
the program: it imports neither ``jax`` nor ``repro`` nor anything of
``repro_torch``. It runs on whatever device its tensors live on, in float32
with TF32 off, one layer at a time over a list of sequences, so that the
card holds one layer's float32 weights at once.

The weights are laid out as the served program takes them (leaves stacked
on a leading layer axis; ``wq`` as (d, K, G, D), ``wo`` as (K, G, D, d)).
``make_params`` draws them from a seed on the device, one call a leaf, in
the dtype they are served in. The int8 weights the reference uses are its
own: ``quantize`` is the per-output-channel rule of weight-only int8
(absmax / levels, a 1.0 floor on an all-zero channel, round half to even,
clamp), applied to the same bf16 tensors the program quantizes itself.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

# contraction axes of each per-layer projection (the output channels are
# the rest): q/k/v contract the model width, wo contracts (K, G, D)
CONTRACT = {"wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1, 2),
            "w_gate": (0,), "w_up": (0,), "w_down": (0,)}
ATTN = ("wq", "wk", "wv", "wo")
MLP = ("w_gate", "w_up", "w_down")
RMS_EPS = 1e-6


def dims(cfg: dict) -> Tuple[int, int, int, int, int, int, int]:
    """(layers, width, KV heads, query heads per KV head, head size, MLP
    width, vocabulary) of a configuration file."""
    K = cfg["num_key_value_heads"]
    return (cfg["num_hidden_layers"], cfg["hidden_size"], K,
            cfg["num_attention_heads"] // K, cfg["head_dim"],
            cfg["intermediate_size"], cfg["vocab_size"])


def leaf_specs(cfg: dict) -> Dict[Tuple[str, ...], Tuple[tuple, float]]:
    """Every leaf of the tree: path -> (shape, standard deviation)."""
    n, d, K, G, D, f, V = dims(cfg)
    return {
        ("embed",): ((V, d), 0.02),
        ("layers", "attn", "wq"): ((n, d, K, G, D), d ** -0.5),
        ("layers", "attn", "wk"): ((n, d, K, D), d ** -0.5),
        ("layers", "attn", "wv"): ((n, d, K, D), d ** -0.5),
        ("layers", "attn", "wo"): ((n, K, G, D, d), (K * G * D) ** -0.5),
        ("layers", "mlp", "w_gate"): ((n, d, f), d ** -0.5),
        ("layers", "mlp", "w_up"): ((n, d, f), d ** -0.5),
        ("layers", "mlp", "w_down"): ((n, f, d), f ** -0.5),
        ("layers", "ln1"): ((n, d), 0.1),
        ("layers", "ln2"): ((n, d), 0.1),
        ("ln_f",): ((d,), 0.1),
        ("head",): ((V, d), 0.02),
    }


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The seeded weight tree, drawn on ``device`` in ``dtype``: one normal
    draw a leaf, scaled in place (fan-in scaling for the projections, 0.02
    for the tables, 0.1 for the norm gains around their 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tree: dict = {}
    for path, (shape, std) in leaf_specs(cfg).items():
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        w.mul_(std)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = w
    return tree


def quantize(w: torch.Tensor, axes: Sequence[int], bits: int = 8
             ) -> torch.Tensor:
    """Symmetric per-output-channel quantization of one layer's weight,
    returned dequantized in float32: absmax over the contraction ``axes``
    over ``2**(bits-1) - 1`` levels, a scale of 1.0 for an all-zero
    channel, round half to even, clamp."""
    levels = 2 ** (bits - 1) - 1
    wf = w.float()
    absmax = wf.abs().amax(dim=tuple(axes), keepdim=True)
    scale = torch.where(absmax > 0, absmax / levels, torch.ones_like(absmax))
    return torch.clamp(torch.round(wf / scale), -levels, levels) * scale


def layer_weights(params: dict, i: int, bits: Optional[int]) -> dict:
    """Layer ``i``'s weights in float32; projections quantized to ``bits``
    when given (None: as drawn)."""
    lay = params["layers"]
    out = {"ln1": lay["ln1"][i].float(), "ln2": lay["ln2"][i].float()}
    for group, names in (("attn", ATTN), ("mlp", MLP)):
        for name in names:
            w = lay[group][name][i]
            out[name] = (w.float() if bits is None
                         else quantize(w, CONTRACT[name], bits))
    return out


def rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + RMS_EPS) \
        * (1.0 + gain)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, ..., D) at positions 0..S-1, the two
    halves of each head rotated as a pair."""
    S, D = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float32) / D)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    ang = ang.reshape((S,) + (1,) * (x.ndim - 2) + (D // 2,))
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def block(x: torch.Tensor, w: dict, theta: float,
          q_rows: int = 512) -> torch.Tensor:
    """One decoder layer over a whole sequence x (S, d), causal."""
    S = x.shape[0]
    h = rmsnorm(x, w["ln1"])
    q = rope(torch.einsum("sd,dkgh->skgh", h, w["wq"]), theta)
    k = rope(torch.einsum("sd,dkh->skh", h, w["wk"]), theta)
    v = torch.einsum("sd,dkh->skh", h, w["wv"])
    D = q.shape[-1]
    o = torch.empty_like(q)
    t = torch.arange(S, device=x.device)
    for a in range(0, S, q_rows):            # query rows in blocks
        b = min(a + q_rows, S)
        sc = torch.einsum("skgh,tkh->kgst", q[a:b], k[:b]) * D ** -0.5
        sc = sc.masked_fill(t[None, :b] > t[a:b, None], float("-inf"))
        o[a:b] = torch.einsum("kgst,tkh->skgh", torch.softmax(sc, -1), v[:b])
    x = x + torch.einsum("skgh,kghd->sd", o, w["wo"])
    h = rmsnorm(x, w["ln2"])
    g = torch.nn.functional.silu(h @ w["w_gate"]) * (h @ w["w_up"])
    return x + g @ w["w_down"]


def served_logits(params: dict, cfg: dict, seqs: Sequence[torch.Tensor],
                  starts: Sequence[int], bits_list: Sequence[Optional[int]]
                  ) -> List[List[torch.Tensor]]:
    """Next-token logits (float32) of each sequence from position
    ``starts[i]`` on, for each weight precision of ``bits_list`` (None: the
    weights as drawn). ``seqs`` are int64 token tensors on the device; the
    layers run one at a time over every sequence. Returns, per precision,
    one (len(seq) - start, V) tensor per sequence."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            emb = params["embed"]
            xs = [[emb[s].float() for s in seqs] for _ in bits_list]
            for i in range(cfg["num_hidden_layers"]):
                for j, bits in enumerate(bits_list):
                    w = layer_weights(params, i, bits)
                    xs[j] = [block(x, w, cfg["rope_theta"]) for x in xs[j]]
                    del w
            head, gain = params["head"].float(), params["ln_f"].float()
            return [[rmsnorm(x[a:], gain) @ head.t()
                     for x, a in zip(xj, starts)] for xj in xs]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each token's reference logit lies below the reference's
    best at its position: ref (n, V), tokens (n,) -> (n,)."""
    return ref.max(-1).values - ref.gather(1, tokens[:, None].long())[:, 0]
