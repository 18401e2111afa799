"""The roofline of one step on one H100, from the counts of
``roofline.op_cost`` (no card needed):

  compute term    = counted FLOPs / the card's peak FLOP/s
  memory term     = counted bytes / the card's HBM bytes/s
  collective term = each axis's collective bytes / that axis's link

The rates are ``launch.mesh``'s data-sheet figures, so the terms are
lower bounds, not measurements. The FLOPs are matmul-class and the bytes
unfused (``op_cost``), and each record says so.

A step on a mesh whose model axis is larger than 1, or under the FSDP
layout on a mesh of more than one data index, is counted as one rank's
program (``launch.steps.build_step``, rank 0): its FLOPs, bytes and the
collective bytes it moves (``coll_gbytes``, by kind in
``coll_breakdown``, by axis in ``coll_by_axis``) are one card's. The
collective term puts each axis's bytes on its link: the model axis's on
NVLink where that axis fits in one node (``mesh.NODE_CARDS``), on the
node's network links where it does not; the data axes' (a train step's
gradient mean over ``pod`` and ``data``, the FSDP layout's all-gathers
and reduce-scatters) on the network links. A one-card program is
counted whole with no collective term (``t_collective`` None), its mesh
changing only the argument bytes each card holds (``launch.sharding``).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, Optional

from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, MODEL_AXIS, NIC_BW,
                                     NODE_CARDS, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32)

PEAKS = {"bf16": PEAK_FLOPS_BF16, "f32": PEAK_FLOPS_F32}
LINK_BW = {"nvlink": NVLINK_BW, "nic": NIC_BW}


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
    # a rank's program: its collective GB, by kind and by axis
    coll_gbytes: Optional[float] = None
    coll_breakdown: Optional[Dict[str, float]] = None
    model_axis: int = 1                   # cards on the model axis
    coll_by_axis: Optional[Dict[str, float]] = None

    @property
    def rank_program(self) -> bool:
        return self.coll_gbytes is not None

    @property
    def model_link(self) -> str:
        return "nvlink" if self.model_axis <= NODE_CARDS else "nic"

    @property
    def t_compute(self) -> float:
        return self.gflops * 1e9 / PEAKS[self.peak]

    @property
    def t_memory(self) -> float:
        return self.gbytes * 1e9 / HBM_BW

    def link(self, axis: str) -> str:
        """The link an axis's collectives run over: the model axis's
        NVLink within a node (else the network), the data axes' the
        network."""
        return self.model_link if axis == MODEL_AXIS else "nic"

    @property
    def t_collective_by_axis(self) -> Optional[Dict[str, float]]:
        """Each axis's collective bytes over its link; None where none
        was counted."""
        if self.coll_gbytes is None:
            return None
        return {a: gb * 1e9 / LINK_BW[self.link(a)]
                for a, gb in self.coll_by_axis.items()}

    @property
    def t_collective(self) -> Optional[float]:
        """The sum of :attr:`t_collective_by_axis` (the axes' links run
        one after another: a lower bound on none of them overlapping the
        others, not on their overlap with compute); None where no
        collective was counted."""
        by_axis = self.t_collective_by_axis
        return None if by_axis is None else sum(by_axis.values())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory}
        if self.t_collective is not None:
            terms["collective"] = self.t_collective
        return max(terms, key=terms.get)

    @property
    def useful_flop_frac(self) -> Optional[float]:
        """The model's FLOPs over the counted ones, a rank's program's
        taken as its card's share of the step (times the mesh's
        cards)."""
        if self.model_gflops is None or self.gflops == 0:
            return None
        cards = self.chips if self.rank_program else 1
        return self.model_gflops / (self.gflops * cards)

    @property
    def fits_80gb(self) -> Optional[bool]:
        if self.arg_bytes_per_card is None:
            return None
        return self.arg_bytes_per_card <= HBM_BYTES

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective,
                 t_collective_by_axis=self.t_collective_by_axis,
                 coll_links=None if self.coll_gbytes is None else {
                     a: self.link(a) for a in self.t_collective_by_axis},
                 bottleneck=self.bottleneck,
                 useful_flop_frac=self.useful_flop_frac,
                 fits_80gb=self.fits_80gb, rank_program=self.rank_program,
                 model_link=self.model_link if self.rank_program else None)
        return d


def analyze(summary, *, arch: str, shape: str, mesh_name: str = "host",
            chips: int = 1, model_flops: Optional[float] = None,
            arg_bytes_per_card: Optional[float] = None, peak: str = "bf16",
            count_s: Optional[float] = None,
            model_axis: int = 1) -> Roofline:
    """A :class:`Roofline` from an ``op_cost.CostSummary``: a rank's
    program — on a model axis of ``model_axis`` > 1 cards, or any program
    that ran collectives (the FSDP layout's over the data axes, on a
    model axis of 1 too) — gets the collective term from
    ``summary.collectives`` (by kind) and ``summary.collectives_by_axis``;
    otherwise there is none."""
    coll = by_axis = None
    if model_axis > 1 or summary.collectives:
        coll = {k: v / 1e9 for k, v in sorted(summary.collectives.items())}
        by_axis = {k: v / 1e9 for k, v in
                   sorted(summary.collectives_by_axis.items())}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        gflops=summary.flops / 1e9, gbytes=summary.bytes / 1e9, peak=peak,
        model_gflops=(model_flops / 1e9) if model_flops else None,
        arg_bytes_per_card=arg_bytes_per_card, count_s=count_s,
        coll_gbytes=sum(coll.values()) if coll is not None else None,
        coll_breakdown=coll, model_axis=model_axis,
        coll_by_axis=by_axis)


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
