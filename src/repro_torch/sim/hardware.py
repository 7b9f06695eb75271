"""Hardware catalog + roofline latency model (NVIDIA H100 target).

The profiler derives per-variant latency curves from these specs and the
simulator executes against them. Paper mapping: "hardware platform" = the
host CPU or one or four H100 cards; prices mirror the paper's >=6x GPU/CPU
gap in chip-second units, and ``startup_latency`` is the provisioning
model's, as in ``repro``'s catalog: neither is a measurement of a card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# --- H100 SXM5 constants: NVIDIA H100 Tensor Core GPU data sheet (SXM5
# column, dense rates without sparsity; PCIe Gen5 x16 per direction;
# fourth-generation NVLink, total per card) ---
H100_PEAK_FLOPS_BF16 = 989e12         # FLOP/s per card
H100_HBM_BW = 3.35e12                 # B/s per card (HBM3)
H100_NVLINK_BW = 900e9                # B/s per card
H100_HBM_BYTES = 80e9                 # bytes per card
PCIE_LOAD_BW = 64e9                   # host->device weight-load bandwidth


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    kind: str                 # "cpu" | "accel"
    chips: int                # accelerator chips (0 for cpu)
    peak_flops: float         # FLOP/s (aggregate)
    mem_bw: float             # B/s (aggregate)
    mem_capacity: float       # bytes available for model weights + buffers
    load_bw: float            # B/s for loading weights from the repository
    cost_rate: float          # cost units per second (paper: GPU >= 6x CPU)
    startup_latency: float    # seconds to provision a fresh worker


HARDWARE: Dict[str, HardwareSpec] = {
    # NOTE: cpu-host describes ONE replica slot (2 of 8 vCPUs), so CPU
    # replication scales throughput linearly (paper Fig. 4); a host offers
    # cores/cores_per_replica = 4 such slots and mem_capacity is host-wide.
    "cpu-host": HardwareSpec(
        name="cpu-host", kind="cpu", chips=0,
        peak_flops=0.15e12, mem_bw=20e9, mem_capacity=32 * 2**30,
        load_bw=1.5e9, cost_rate=1.0, startup_latency=8.0),
    "h100-1": HardwareSpec(
        name="h100-1", kind="accel", chips=1,
        peak_flops=H100_PEAK_FLOPS_BF16, mem_bw=H100_HBM_BW,
        mem_capacity=H100_HBM_BYTES, load_bw=PCIE_LOAD_BW,
        cost_rate=6.0, startup_latency=15.0),
    "h100-4": HardwareSpec(
        name="h100-4", kind="accel", chips=4,
        peak_flops=4 * H100_PEAK_FLOPS_BF16, mem_bw=4 * H100_HBM_BW,
        mem_capacity=4 * H100_HBM_BYTES, load_bw=4 * PCIE_LOAD_BW,
        cost_rate=24.0, startup_latency=20.0),
}


def roofline_latency(flops: float, bytes_moved: float,
                     hw: HardwareSpec, efficiency: float = 0.6) -> float:
    """max(compute, memory) time in seconds at a de-rated efficiency."""
    t_compute = flops / (hw.peak_flops * efficiency)
    t_memory = bytes_moved / (hw.mem_bw * efficiency)
    return max(t_compute, t_memory)
