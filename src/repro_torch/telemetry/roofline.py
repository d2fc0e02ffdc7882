"""Three-term roofline model + DCGM-analogue utilization metrics.

Terms are *seconds per step* on the target hardware, derived from the
compiled dry-run artifact (everything is per-device because post-SPMD HLO is
per-device):

    compute_s    = HLO_FLOPs_per_device / peak_flops
    memory_s     = HLO_bytes_per_device / HBM_BW
    collective_s = wire_bytes_per_device / ICI_LINK_BW

The dominant term is the bottleneck; roofline fraction for the step is
max_term / (compute_s + ideally-overlapped others) — we report
``bound = max(terms)`` and ``frac_of_roofline = compute_s / max(terms)``
(how close the step is to being pure-MXU-limited, the hillclimb objective).

``peak_flops`` is the one field the reference does not have: the peak of the
type the step computes in, the bf16 peak unless the caller says otherwise. On
the H100 an f32 step (the ResNet trio, TF32 off) runs outside the tensor cores
at 67 TFLOP/s, against 989 in bf16 (telemetry/constants.py).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from repro_torch.telemetry import constants as C


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_global: float
    peak_mem_bytes_per_device: float
    collective_detail: Optional[Dict] = None
    peak_flops: float = C.PEAK_FLOPS_BF16

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / C.HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_device / C.ICI_LINK_BW

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = slowest term (perfect overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs (global): remat/redundancy waste detector."""
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        denom = self.step_s * self.chips * self.peak_flops
        return self.model_flops_global / denom if denom else 0.0

    @property
    def frac_of_roofline(self) -> float:
        """compute_s / step_s: 1.0 == pure compute-bound (at the roof)."""
        return self.compute_s / self.step_s if self.step_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "peak_mem_bytes_per_device": self.peak_mem_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "step_s": self.step_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
            "frac_of_roofline": self.frac_of_roofline,
            "collective_detail": self.collective_detail,
        }


# ---------------------------------------------------------------------------
# DCGM-metric analogues (paper §3.2.2), derived from the same artifact
# ---------------------------------------------------------------------------


def dcgm_analogues(r: RooflineReport) -> Dict[str, float]:
    """Map roofline terms onto the paper's utilization metrics.

    GRACT  — fraction of step time *any* engine is busy: 1 by construction
             for a saturated step; we report busy = (compute ∪ memory ∪ coll)
             assuming perfect overlap => max-term / step = 1; instead we use
             (compute_s + memory_s + collective_s admixture) vs serialized
             time to expose idleness: gract = step_s / serial_s.
    SMACT  — MXU-issue fraction: compute_s / step_s.
    SMOCC  — latency-hiding proxy: arithmetic intensity / ridge intensity,
             capped at 1 (weaker semantics than warp occupancy; documented).
    DRAMA  — HBM bandwidth utilization: memory_s / step_s.
    """
    ai = r.flops_per_device / max(r.hbm_bytes_per_device, 1.0)
    ridge = r.peak_flops / C.HBM_BW
    step = r.step_s or 1.0
    return {
        # engines idle only while blocked on collectives
        "gract": min(1.0, max(r.compute_s, r.memory_s) / step),
        "smact": min(1.0, r.compute_s / step),
        "smocc_proxy": min(1.0, ai / ridge),
        "drama": min(1.0, r.memory_s / step),
    }


def model_flops(cfg, suite, n_params_active: int) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D prefill, 2·N·B decode (per step)."""
    if suite.kind == "train":
        return 6.0 * n_params_active * suite.seq_len * suite.global_batch
    if suite.kind == "prefill":
        return 2.0 * n_params_active * suite.seq_len * suite.global_batch
    return 2.0 * n_params_active * suite.global_batch  # one token / decode step


def format_table(reports) -> str:
    hdr = (
        f"{'arch':<18}{'shape':<13}{'mesh':<10}{'compute_s':>10}{'memory_s':>10}"
        f"{'coll_s':>10}{'bound':>11}{'MFU':>7}{'useful':>8}{'GB/dev':>8}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        lines.append(
            f"{r.arch:<18}{r.shape:<13}{r.mesh:<10}"
            f"{r.compute_s:>10.4f}{r.memory_s:>10.4f}{r.collective_s:>10.4f}"
            f"{r.bound:>11}{r.mfu:>7.3f}{r.useful_flops_ratio:>8.3f}"
            f"{r.peak_mem_bytes_per_device/2**30:>8.2f}"
        )
    return "\n".join(lines)
