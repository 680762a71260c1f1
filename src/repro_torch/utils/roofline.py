"""Three-term roofline from a dry run's per-rank cost.

Counterpart of ``repro.utils.roofline``, with the constants of this
port's card, the NVIDIA H100 SXM, in place of the TPU v5e's:

    peak bf16 dense compute : 989 TFLOP/s
    HBM3 bandwidth          : 3.35 TB/s
    link bandwidth          : 50 GB/s per GPU

``LINK_BW`` is one GPU's inter-node link, 400 Gb/s NDR InfiniBand.  A
16-wide mesh axis spans more than the 8 GPUs of one NVLink domain, so
its collectives cross nodes: this is the conservative counterpart of
the reference's ``ICI_BW``.  Inside a node NVLink 4 moves 450 GB/s per
direction per GPU (``NVLINK_BW``), nine times as much.

Terms (seconds, per step, per rank -- ``utils.op_cost`` counts each
rank's local ops):
    compute    = flops_per_chip / PEAK_FLOPS
    memory     = bytes_per_chip / HBM_BW
    collective = collective_bytes_per_chip / LINK_BW
A record built from these is a prediction from the card's constants,
not a measurement.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Optional

PEAK_FLOPS = 989e12
# f32 outside the tensor cores (``chip_smoke.py``'s f32 kernel bounds)
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
LINK_BW = 50e9
NVLINK_BW = 450e9


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float            # 6*N*D (dense) / 6*N_active*D (MoE), global
    useful_ratio: float           # model_flops / (flops_per_chip * chips)
    collectives: dict
    memory_analysis: dict
    note: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)

    @property
    def step_time_s(self) -> float:
        """Simple roofline step-time estimate: overlapped compute/memory
        plus (conservatively serial) collectives."""
        return max(self.compute_s, self.memory_s) + self.collective_s

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} "
                f"| {self.collective_s*1e3:.2f} | {self.dominant} "
                f"| {self.useful_ratio:.2f} |")


def analyze(arch: str, shape: str, mesh_name: str, chips: int, wc,
            model_flops: float, memory_analysis: Optional[dict] = None,
            note: str = "") -> Roofline:
    """The roofline of one step from its ``op_cost.WeightedCost``
    ``wc`` (per rank)."""
    flops = float(wc.flops)
    byts = float(wc.bytes_accessed)
    coll_b = {k: int(v) for k, v in wc.collective_bytes.items()}
    coll_n = {k: int(v) for k, v in wc.collective_counts.items()}
    cb = float(wc.total_collective_bytes)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = cb / LINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    ma = {k: int(v) for k, v in (memory_analysis or {}).items()}
    useful = model_flops / max(flops * chips, 1.0)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, bytes_per_chip=byts,
        collective_bytes_per_chip=cb,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops, useful_ratio=useful,
        collectives={"bytes": coll_b, "count": coll_n},
        memory_analysis=ma, note=note)
