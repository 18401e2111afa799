"""The roofline of one step on one H100, from the counts of
``roofline.op_cost`` (no card needed):

  compute term = counted FLOPs / the card's peak FLOP/s
  memory term  = counted bytes / the card's HBM bytes/s

The rates are ``launch.mesh``'s data-sheet figures, so both terms are
lower bounds, not measurements. The FLOPs are matmul-class and the bytes
unfused (``op_cost``), and each record says so. One card has no
inter-card link: no collective term is counted (``t_collective`` is
None). The step is costed whole on one card; a production mesh changes
only the argument bytes each card holds (``launch.sharding``).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Optional

from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32)

PEAKS = {"bf16": PEAK_FLOPS_BF16, "f32": PEAK_FLOPS_F32}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int                    # the mesh's cards: they divide only
                                  # the argument bytes
    gflops: float                 # counted, the whole step
    gbytes: float
    peak: str = "bf16"            # the matmuls' dtype: which peak applies
    model_gflops: Optional[float] = None   # analytic 6ND / 2ND
    arg_bytes_per_card: Optional[float] = None
    count_s: Optional[float] = None        # host seconds of the count
    flops_kind: str = "matmul"
    bytes_kind: str = "unfused"

    @property
    def t_compute(self) -> float:
        return self.gflops * 1e9 / PEAKS[self.peak]

    @property
    def t_memory(self) -> float:
        return self.gbytes * 1e9 / HBM_BW

    @property
    def t_collective(self) -> None:
        return None                   # one card: not counted

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def useful_flop_frac(self) -> Optional[float]:
        if self.model_gflops is None or self.gflops == 0:
            return None
        return self.model_gflops / self.gflops

    @property
    def fits_80gb(self) -> Optional[bool]:
        if self.arg_bytes_per_card is None:
            return None
        return self.arg_bytes_per_card <= HBM_BYTES

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flop_frac=self.useful_flop_frac,
                 fits_80gb=self.fits_80gb)
        return d


def analyze(summary, *, arch: str, shape: str, mesh_name: str = "host",
            chips: int = 1, model_flops: Optional[float] = None,
            arg_bytes_per_card: Optional[float] = None, peak: str = "bf16",
            count_s: Optional[float] = None) -> Roofline:
    """A :class:`Roofline` from an ``op_cost.CostSummary``."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        gflops=summary.flops / 1e9, gbytes=summary.bytes / 1e9, peak=peak,
        model_gflops=(model_flops / 1e9) if model_flops else None,
        arg_bytes_per_card=arg_bytes_per_card, count_s=count_s)


# ---------------------------------------------------------------------------
# Serving profiles from the card's constants (``core.cost_model``).

def h100_server_profile(chips: int = 1) -> "ServerProfile":
    """A ``ServerProfile`` whose compute and memory rates are the H100's
    roofline denominators (``launch.mesh``): t_server = O2·gamma/f =
    2·O2/PEAK (a MAC is 2 FLOPs), mem_bw the HBM stream."""
    from repro_torch.core.cost_model import ServerProfile
    return ServerProfile(f_clock=PEAK_FLOPS_BF16 * chips / 2.0, gamma=1.0,
                         mem_bw=HBM_BW * chips)


def h100_device_profile(flops_frac: float = 1.0,
                        bw_frac: float = 1.0) -> "DeviceProfile":
    """A one-card accelerator ``DeviceProfile`` from the same constants;
    ``flops_frac`` / ``bw_frac`` derate it to an edge-class part.
    ``kappa`` is zeroed: the paper's CPU-clock energy model (J/cycle/Hz²)
    is meaningless at accelerator clock values, so accelerator energy is
    not modeled."""
    from repro_torch.core.cost_model import DeviceProfile
    return DeviceProfile(f_clock=PEAK_FLOPS_BF16 * flops_frac / 2.0,
                         gamma=1.0, kappa=0.0, mem_bw=HBM_BW * bw_frac)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training (fwd 2ND + bwd 4ND), 2*N*D
    forward-only, with N = active params (MoE top-k)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1          # decode: one token
    return 2.0 * n_active * tokens


def save_record(roofline: Roofline, path: str) -> None:
    with open(path, "w") as f:
        json.dump(roofline.to_dict(), f, indent=2)


def load_records(record_dir: str):
    out = []
    for p in sorted(glob.glob(os.path.join(record_dir, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out
