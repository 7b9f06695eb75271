#!/usr/bin/env python3
"""Time one source tree's decode-attention kernels under ``chip_smoke.py``'s
timer, beside their bounds and host cost.

    python3 scripts/time_decode.py [--src DIR] [--label NAME]

DIR is the ``src`` directory whose ``repro_torch`` package is timed (this
checkout's by default). An older tree, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists (``build/``), is then timed by the same
code as this one; to compare two trees, run them in one call on one card as
old, new, new, old.

The shapes are those of ``chip_smoke.py`` phase 2: the fused paged decode
at 8 slots of llama3.2-1b (G = 4, D = 64), of the vision model (G = 8,
D = 128) and of whisper-base (G = 1, D = 64), 32 pages of 16 rows, the
positions of ``phase_fused_decode``; the attend-only paged decode at
whisper-base's cross-attention (300 rows per slot); the contiguous decode
at the vision model's cross-attention (T = 1601), beside SDPA. Each is
timed with its launches held back to back (``chip_smoke.cuda_ms``), by the
host time of one call (``chip_smoke.host_us``, the median of five runs of
50 calls: a shared host's cores make single runs vary), and by the device
time of each kernel that one call launches (``torch.profiler``, mean of 20
calls). Prints one JSON line. Needs one CUDA card; the tree's kernels are
built into its own ``build/kernels``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
POS = [0, 16, 15, 300, 511, 47, 203, 100]   # phase_fused_decode's positions


def host_us(cs, fn) -> float:
    return statistics.median(cs.host_us(fn) for _ in range(5))


def kernel_us(torch, fn, calls=20):
    """Mean device time in microseconds of each kernel one ``fn()`` call
    launches, by kernel name (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("::")[-1].split(" ")[-1][:60]
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / calls
    return by_name


def fused_case(torch, cs, gen, dev, G, D, B=8, K=8, ps=16, P=32):
    from repro_torch.kernels.decode_attention import \
        fused_paged_decode_attention
    n_pages = B * P
    perm = torch.randperm(n_pages, generator=gen, device=dev).reshape(B, P)
    pos = torch.tensor(POS, dtype=torch.int32, device=dev)
    alloc = torch.arange(P, device=dev)[None, :] <= (pos.long() // ps)[:, None]
    bt = torch.where(alloc, perm, torch.full_like(perm, n_pages))
    bt = bt.to(torch.int32)
    bt[B - 1] = n_pages
    kp = torch.randn((n_pages + 1, ps, K, D), generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn(kp.shape, generator=gen, device=dev).bfloat16()
    q = torch.randn((B, K, G, D), generator=gen, device=dev).bfloat16()
    kn = torch.randn((B, K, D), generator=gen, device=dev).bfloat16()
    vn = torch.randn((B, K, D), generator=gen, device=dev).bfloat16()

    def fn():
        return fused_paged_decode_attention(q, kn, vn, kp, vp, bt, pos)

    vlen = (pos.long() + 1).cpu()
    live_rows = int(((vlen + ps - 1) // ps * ps).sum())
    n_bytes = 2 * (2 * live_rows * K * D + 2 * q.numel() + 2 * kn.numel()
                   + 2 * B * K * D) + 4 * (bt.numel() + B)
    b_ms, b_by = cs.bound(n_bytes, 4 * K * G * D * int(vlen.sum()),
                          cs.BF16_FLOPS)
    return dict(kernel="fused_paged_decode_attention",
                shape=f"B={B} K={K} G={G} D={D} ps={ps} P={P}",
                ms=cs.cuda_ms(fn), host_us=host_us(cs, fn),
                kernel_us=kernel_us(torch, fn), bound_ms=b_ms, bound_by=b_by)


def paged_case(torch, cs, gen, dev, B=8, K=8, G=1, D=64, ps=16, P=32):
    from repro_torch.kernels.decode_attention import paged_decode_attention
    n_pages = B * P
    bt = torch.randperm(n_pages, generator=gen, device=dev).reshape(B, P)
    bt = bt.to(torch.int32)
    kp = torch.randn((n_pages + 1, ps, K, D), generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn(kp.shape, generator=gen, device=dev).bfloat16()
    q = torch.randn((B, K, G, D), generator=gen, device=dev).bfloat16()
    vt = torch.full((B,), 300, dtype=torch.int32, device=dev)

    def fn():
        return paged_decode_attention(q, kp, vp, bt, vt)

    rows = 300 * B
    n_bytes = 2 * (2 * rows * K * D + 2 * q.numel()) + 4 * (B * 19 + B)
    b_ms, b_by = cs.bound(n_bytes, 4 * K * G * D * rows, cs.BF16_FLOPS)
    return dict(kernel="paged_decode_attention",
                shape=f"B={B} K={K} G={G} D={D} ps={ps} P={P} valid_len 300",
                ms=cs.cuda_ms(fn), host_us=host_us(cs, fn),
                kernel_us=kernel_us(torch, fn), bound_ms=b_ms, bound_by=b_by)


def decode_case(torch, cs, gen, dev, B=8, K=8, G=8, D=128, T=1601):
    from repro_torch.kernels.decode_attention import decode_attention
    q = torch.randn((B, K, G, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, T, K, D), generator=gen, device=dev).bfloat16()

    def fn():
        return decode_attention(q, k, v)

    qh = q.reshape(B, K * G, 1, D)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = cs.bound(n_bytes, 4 * B * K * G * D * T, cs.BF16_FLOPS)
    return dict(kernel="decode_attention", shape=f"B={B} K={K} G={G} D={D} "
                f"T={T}", ms=cs.cuda_ms(fn), host_us=host_us(cs, fn),
                kernel_us=kernel_us(torch, fn), bound_ms=b_ms, bound_by=b_by,
                library_ms=cs.cuda_ms(lambda: sdpa(qh, kh, vh,
                                                   enable_gqa=True)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_decode: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = [fused_case(torch, cs, gen, dev, 4, 64),
            fused_case(torch, cs, gen, dev, 8, 128),
            fused_case(torch, cs, gen, dev, 1, 64),
            paged_case(torch, cs, gen, dev),
            decode_case(torch, cs, gen, dev)]
    for r in rows:
        print(f"  {args.label}: {r['kernel']} {r['shape']}: {r['ms']:.4f} ms"
              f" (bound {r['bound_ms']:.5f} by {r['bound_by']}"
              + (f", SDPA {r['library_ms']:.4f}" if "library_ms" in r else "")
              + f"), host {r['host_us']:.1f} us a call; kernels (us) "
              + ", ".join(f"{k} {v:.2f}" for k, v in r["kernel_us"].items()),
              file=sys.stderr)
    print(json.dumps({"tree": args.label, "src": str(src),
                      "card": cs.card_line(), "decode": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
