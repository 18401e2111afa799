"""Analytic cost model (paper §III, Eq. 1–8 and 13–16, Table II defaults).

Layer granularity: a ``LayerSpec`` carries the three quantities the QPART
optimizer needs — parameter payload ``z_w``, cut-activation payload
``z_x`` and MAC count ``o``. Builders are provided for the paper's
classifiers (Eq. 1–2 exactly) and for every assigned transformer family
(per-block MACs; attention uses the causal-useful S^2/2 term).

The same objective can be instantiated with radio constants (paper
reproduction) or TPU ICI constants (deployment view, DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.configs.classifier import ClassifierConfig, DenseSpec


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    z_w: float      # weight elements
    z_x: float      # output-activation elements (per request batch)
    o: float        # MAC operations (per request batch)
    # -- memory-traffic columns (CostModel v2, DESIGN.md §9). Defaults
    # derive from z_w/z_x at bf16 (2 B/elem; activations read + written);
    # builders or the HLO attribution helper may override with measured
    # numbers. The WEIGHT stream at the deployed (quantized) bit-widths
    # is plan-dependent and lives on PartitionPlan.device_memory_bytes;
    # w_bytes16 is the full-precision stream the SERVER side pays.
    w_bytes16: Optional[float] = None   # weight-stream bytes at bf16
    act_bytes: Optional[float] = None   # activation read+write bytes (bf16,
                                        # per request batch, like z_x/o)
    kv_bytes16: Optional[float] = None  # resident decode-cache footprint at
                                        # the context the specs were built
                                        # for (bf16 storage; per request
                                        # batch). 0.0 for cache-less layers
                                        # (classifiers, prefill-only views).

    def __post_init__(self):
        if self.w_bytes16 is None:
            object.__setattr__(self, "w_bytes16", 2.0 * self.z_w)
        if self.act_bytes is None:
            object.__setattr__(self, "act_bytes", 4.0 * self.z_x)
        if self.kv_bytes16 is None:
            object.__setattr__(self, "kv_bytes16", 0.0)


# ---------------------------------------------------------------------------
# Profiles (paper Table II defaults).

@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    f_clock: float = 200e6          # Hz
    gamma: float = 5.0              # cycles / MAC
    kappa: float = 3e-27            # energy-efficiency (J / cycle / Hz^2)
    tx_power: float = 1.0           # W
    memory_bytes: float = 512e6
    mem_bw: float = 25.6e9          # bytes/s memory bandwidth (LPDDR-class;
                                    # only the roofline/calibrated providers
                                    # read it)


@dataclasses.dataclass(frozen=True)
class ServerProfile:
    f_clock: float = 3e9
    gamma: float = 5.0 / 4.0
    eta_m: float = 3.75e-27
    zeta: float = 1e-2              # $ / s of server compute
    mem_bw: float = 100e9           # bytes/s memory bandwidth (DDR-class)


@dataclasses.dataclass(frozen=True)
class Channel:
    bandwidth_hz: float = 40e6
    snr_db: Optional[float] = None
    capacity_bps: float = 200e6     # direct r (Table II); SNR overrides

    def __post_init__(self):
        # memoized at construction: the SNR log2 path used to recompute
        # per capacity() call, and the pricing hot paths call it per
        # request per window
        if self.snr_db is None:
            cap = self.capacity_bps
        else:
            cap = self.bandwidth_hz * math.log2(1.0 + 10 ** (self.snr_db / 10))
        object.__setattr__(self, "_cap", cap)

    def capacity(self) -> float:
        return self._cap


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    omega: float = 1.0              # time
    tau: float = 1.0                # energy
    eta: float = 1e-6               # server cost (scales $ into the objective)


# ---------------------------------------------------------------------------
# Eq. 24–26 reduced coefficients.

def xi_coeff(w: ObjectiveWeights, d: DeviceProfile) -> float:
    return w.omega * d.gamma / d.f_clock + w.tau * d.gamma * d.kappa * d.f_clock ** 2


def delta_coeff(w: ObjectiveWeights, s: ServerProfile) -> float:
    return (w.omega + w.eta * s.zeta) * s.gamma / s.f_clock


def eps_coeff(w: ObjectiveWeights, d: DeviceProfile, ch: Channel) -> float:
    return (w.omega + d.tx_power * w.tau) / ch.capacity()


# ---------------------------------------------------------------------------
# Raw cost terms (Eq. 5–8, 15–16).

@dataclasses.dataclass
class CostBreakdown:
    t_local: float
    t_server: float
    t_tran: float
    e_local: float
    e_tran: float
    server_cost: float

    @property
    def t_total(self):
        return self.t_local + self.t_server + self.t_tran

    @property
    def e_total(self):
        return self.e_local + self.e_tran

    def objective(self, w: ObjectiveWeights) -> float:
        return (w.omega * self.t_total + w.tau * self.e_total
                + w.eta * self.server_cost)


def cost_breakdown(o1: float, o2: float, payload_bits: float,
                   d: DeviceProfile, s: ServerProfile, ch: Channel) -> CostBreakdown:
    r = ch.capacity()
    t_local = o1 * d.gamma / d.f_clock
    e_local = d.kappa * d.f_clock ** 2 * o1 * d.gamma
    t_server = o2 * s.gamma / s.f_clock
    c = o2 * s.gamma * s.zeta / s.f_clock
    t_tran = payload_bits / r
    e_tran = d.tx_power * t_tran
    return CostBreakdown(t_local, t_server, t_tran, e_local, e_tran, c)


# ---------------------------------------------------------------------------
# Layer specs: classifiers (paper Eq. 1–2).

def classifier_layer_specs(cfg: ClassifierConfig, batch: int = 1) -> List[LayerSpec]:
    specs = []
    for i, l in enumerate(cfg.layers):
        if isinstance(l, DenseSpec):
            o = l.in_dim * l.out_dim                       # Eq. 1
            z_w = l.in_dim * l.out_dim + l.out_dim
            z_x = l.out_dim
        else:
            o = l.c_in * l.c_out * l.f1 * l.f2 * l.u * l.v  # Eq. 2
            z_w = l.f1 * l.f2 * l.c_in * l.c_out + l.c_out
            u, v = l.u // l.pool, l.v // l.pool
            z_x = l.c_out * u * v
        specs.append(LayerSpec(f"layer{i + 1}", z_w, z_x * batch, o * batch))
    return specs


# ---------------------------------------------------------------------------
# Layer specs: assigned transformer families.

def transformer_layer_specs(cfg: ModelConfig, seq_len: int,
                            batch: int = 1, mode: str = "prefill") -> List[LayerSpec]:
    """Per-block specs. ``mode`` prefill counts the full sequence; decode
    counts one token against a seq_len context. The embedding table is
    layer 0 (always on-device: it starts the computation)."""
    d = cfg.d_model
    tokens = batch * (seq_len if mode != "decode" else 1)
    specs = [LayerSpec("embed", cfg.vocab_size * d, tokens * d, 0.0)]
    hd = cfg.resolved_head_dim()
    win = cfg.sliding_window
    kvp, _ = cfg.padded_heads()
    for l in range(cfg.num_layers):
        z_w = float(cfg._block_params(l))
        o = 0.0
        kv_rw_bytes = 0.0     # per-token decode cache read+write traffic
        kv_f16 = 0.0          # resident cache footprint (bf16 storage)
        if cfg.block_kind(l) == ATTN:
            proj = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd + cfg.num_heads * hd * d
            o += tokens * proj
            ctx = min(seq_len, win) if win else seq_len
            if mode == "decode":
                o += tokens * 2 * cfg.num_heads * hd * ctx
            else:
                avg_ctx = ctx if win else seq_len / 2
                o += tokens * 2 * cfg.num_heads * hd * avg_ctx
            z_x_state = 2 * cfg.num_kv_heads * hd * (min(seq_len, win) if win else seq_len)
            # ring buffer {k, v}: (B, ctx, KV_pad, hd) at 2 B/elem; one
            # decode step reads the whole ring and writes one slot
            kv_f16 = batch * 2.0 * (2 * kvp * hd * ctx)
            kv_rw_bytes = batch * 2.0 * (2 * kvp * hd * ctx + 2 * kvp * hd)
        else:
            s = cfg.ssm
            di = s.d_inner(d)
            nh = s.num_heads(d)
            o += tokens * (d * (2 * di + 2 * s.d_state + nh) + di * d)
            o += tokens * s.conv_width * (di + 2 * s.d_state)
            # SSD: state update + readout + intra-chunk quadratic
            o += tokens * nh * (3 * s.d_state * s.head_dim
                                + (0 if mode == "decode" else s.chunk * (s.d_state + s.head_dim)))
            z_x_state = nh * s.d_state * s.head_dim + (s.conv_width - 1) * (di + 2 * s.d_state)
            # recurrent state is f32 (4 B/elem) regardless of storage
            # dtype; the conv ring follows the cache dtype (2 B at bf16).
            # Both are read AND written every decode step.
            state_el = nh * s.d_state * s.head_dim
            conv_el = (s.conv_width - 1) * (di + 2 * s.d_state)
            kv_f16 = batch * (4.0 * state_el + 2.0 * conv_el)
            kv_rw_bytes = batch * (8.0 * state_el + 4.0 * conv_el)
        if cfg.uses_moe(l):
            m = cfg.moe
            mult = 3 if cfg.mlp == "swiglu" else 2
            o += tokens * (d * m.num_experts + m.top_k * mult * d * m.d_ff)
        elif cfg.d_ff:
            mult = 3 if cfg.mlp == "swiglu" else 2
            o += tokens * mult * d * cfg.d_ff
        # cut activation: hidden state(s) crossing the partition
        z_x = tokens * d + (batch * z_x_state if mode == "decode" else 0)
        # decode act_bytes made EXPLICIT: the default 4·z_x would charge
        # the full state transfer as per-layer traffic — the real per-
        # token traffic is the hidden r/w plus the cache r/w above
        ab = 4.0 * tokens * d + kv_rw_bytes if mode == "decode" else None
        specs.append(LayerSpec(f"block{l}", z_w, float(z_x), float(o),
                               act_bytes=ab, kv_bytes16=float(kv_f16)))
    return specs


def kv_bytes_row(specs: List[LayerSpec]) -> np.ndarray:
    """(P+1,) cumulative resident decode-cache footprint of the DEVICE
    segment — candidate c holds layers 1..c's caches for the lifetime of
    the stream (bf16-storage accounting; a quantized segment that stores
    its cache at a narrower dtype only shrinks this, so the feasibility
    mask stays conservative)."""
    return np.concatenate(
        [[0.0], np.cumsum([sp.kv_bytes16 for sp in specs])])


def layer_specs_for(cfg, seq_len: int = 1, batch: int = 1,
                    mode: str = "prefill") -> List[LayerSpec]:
    if isinstance(cfg, ClassifierConfig):
        return classifier_layer_specs(cfg, batch)
    return transformer_layer_specs(cfg, seq_len, batch, mode)


# ---------------------------------------------------------------------------
# CostModel v2: pluggable cost providers (DESIGN.md §9).
#
# Every online decision — Alg. 2 plan selection, ``price_window``'s
# matrix objective, the fleet engine's reservations and SLO admission —
# prices candidates through ONE linear contract:
#
#     obj[r, p] = sum_k  c_k[r] · T_k[p]
#
# where ``c_k`` are per-request coefficients (a provider's ``coeffs``)
# and ``T_k`` per-candidate term vectors (``CandidateRows`` → ``terms``).
# The paper's Eq. 17 is the K=3 instance (xi·O1 + delta·O2 + eps·wire);
# the roofline and calibrated providers extend K with memory-traffic
# terms without giving up the one-matrix-op-per-window hot path.

TERM_NAMES = ("o1", "o2", "wire", "dev_bytes", "srv_bytes")
TERM_O1, TERM_O2, TERM_WIRE, TERM_DEV_BYTES, TERM_SRV_BYTES = range(5)

_COEFF_CACHE_MAX = 4096


@dataclasses.dataclass
class CandidateRows:
    """Per-candidate term vectors of one (model, accuracy level, batch,
    cached) pricing profile; column c = partition point c (c=0 is full
    offload). The byte rows are ``None`` when the provider's term set
    does not use them (the analytic default)."""
    o1: np.ndarray                       # (P+1,) device-side MACs
    o2: np.ndarray                       # (P+1,) server-side MACs
    wire: np.ndarray                     # (P+1,) wire bits
    dev_bytes: Optional[np.ndarray] = None   # device memory traffic at the
    # deployed (quantized) bit-widths + activation read/write
    srv_bytes: Optional[np.ndarray] = None   # server tail traffic at bf16

    def bytes_at(self, c: int):
        """(dev_bytes, srv_bytes) scalars of candidate ``c`` (0.0 when
        the byte rows were not built)."""
        db = float(self.dev_bytes[c]) if self.dev_bytes is not None else 0.0
        sb = float(self.srv_bytes[c]) if self.srv_bytes is not None else 0.0
        return db, sb


def byte_term_rows(layer_act_bytes, layer_w_bytes16):
    """THE canonical byte-term row math, over raw per-layer arrays
    (shared by the online pricing helpers below and the offline solver —
    one implementation, so stored and runtime byte terms can never
    drift): returns ``(ab_cum, srv_row)`` — the cumulative device
    activation-traffic row and the server tail byte row, both (L+1,)
    with column c = partition point c."""
    ab = np.asarray(layer_act_bytes, np.float64)
    wb = np.asarray(layer_w_bytes16, np.float64)
    ab_cum = np.concatenate([[0.0], np.cumsum(ab)])
    tail = wb + ab
    srv = np.concatenate([[tail.sum()], tail.sum() - np.cumsum(tail)])
    return ab_cum, srv


def candidate_byte_rows(specs: List[LayerSpec], mem_row: np.ndarray,
                        ab_cum: np.ndarray):
    """(dev_bytes, srv_bytes) rows for one level/batch profile:
    ``mem_row`` is the store's deployed-bit weight footprint per
    candidate (``OfflineStore.level_memory_rows``), ``ab_cum`` the
    cumulative activation-traffic row for the batch
    (``act_bytes_row``)."""
    _, srv = byte_term_rows([sp.act_bytes for sp in specs],
                            [sp.w_bytes16 for sp in specs])
    return mem_row + ab_cum, srv


def act_bytes_row(specs: List[LayerSpec]) -> np.ndarray:
    """(P+1,) cumulative activation read+write bytes of the device
    segment — candidate c streams layers 1..c's activations."""
    return np.concatenate(
        [[0.0], np.cumsum([sp.act_bytes for sp in specs])])


def plan_cost_terms(plan, specs: List[LayerSpec]):
    """(o1, o2, dev_bytes, srv_bytes) scalars of one deployed plan —
    what the calibration ledger regresses measured stage times
    against."""
    o = np.array([sp.o for sp in specs], dtype=np.float64)
    p = plan.p
    o1, o2 = float(o[:p].sum()), float(o[p:].sum())
    dev_b = plan.device_memory_bytes \
        + float(sum(sp.act_bytes for sp in specs[:p]))
    srv_b = float(sum(sp.w_bytes16 + sp.act_bytes for sp in specs[p:]))
    return o1, o2, dev_b, srv_b


class CostProvider:
    """The pluggable pricing contract. A provider supplies

      * ``coeffs`` — the per-request coefficient vector c_k (cached per
        distinct (weights, device, channel, server) profile),
      * ``terms`` — the (K, P+1) term matrix from a ``CandidateRows``,
      * stage-time estimates (``device_seconds`` / ``server_seconds``)
        the fleet engine's SLO finish estimates, reservations and
        ``CostBreakdown`` assembly run on,
      * ``server_correction`` — the row addend that re-prices a
        candidate row against a different fleet server, and
      * ``wire_coeff`` — the coefficient on the wire term, which the
        engine's segment-cache repricing subtracts per cached candidate.

    Objective rows are accumulated term-by-term in declaration order
    (``objective_rows``), which keeps ``AnalyticCost`` bit-identical to
    the pre-provider ``xi·O1 + delta·O2 + eps·wire`` arithmetic.
    """

    name = "base"
    term_ids: tuple = (TERM_O1, TERM_O2, TERM_WIRE)

    # -- linear pricing contract ---------------------------------------
    def coeffs(self, w: ObjectiveWeights, d: DeviceProfile, ch: Channel,
               s: ServerProfile) -> np.ndarray:
        raise NotImplementedError

    def coeffs_cached(self, w, d, ch, s) -> np.ndarray:
        """One dict lookup per distinct (weights, device, channel,
        server) profile — windows re-use profiles heavily, so the hot
        path never recomputes the reduced coefficients per request."""
        cache = self.__dict__.setdefault("_coeff_cache", {})
        key = (w, d, ch, s)
        out = cache.get(key)
        if out is None:
            if len(cache) >= _COEFF_CACHE_MAX:
                cache.clear()
            out = cache[key] = self.coeffs(w, d, ch, s)
        return out

    @property
    def uses_bytes(self) -> bool:
        return TERM_DEV_BYTES in self.term_ids \
            or TERM_SRV_BYTES in self.term_ids

    def terms(self, rows: CandidateRows) -> List[np.ndarray]:
        """Term vectors in coefficient order (views, no copies)."""
        return [getattr(rows, TERM_NAMES[k]) for k in self.term_ids]

    @staticmethod
    def objective_rows(coeff: np.ndarray, terms) -> np.ndarray:
        """obj = sum_k coeff[k]·terms[k], accumulated left-to-right (the
        fixed association the bit-exactness lock relies on)."""
        obj = coeff[0] * terms[0]
        for k in range(1, len(terms)):
            obj = obj + coeff[k] * terms[k]
        return obj

    def wire_coeff(self, w: ObjectiveWeights, d: DeviceProfile,
                   ch: Channel) -> float:
        """Coefficient multiplying the wire-bits term (the engine's
        segment-cache repricing drops eps·(Z_w) per cached candidate)."""
        return eps_coeff(w, d, ch)

    def server_correction(self, w: ObjectiveWeights, ref: ServerProfile,
                          srv: ServerProfile,
                          rows: CandidateRows) -> np.ndarray:
        """Row addend pricing server ``srv`` from a table built against
        ``ref`` (the fleet's per-server re-pricing, one vector op)."""
        raise NotImplementedError

    # -- stage-time estimates ------------------------------------------
    def device_seconds(self, d: DeviceProfile, o1, dev_bytes=None):
        """Device-segment seconds (scalar or per-candidate vector)."""
        raise NotImplementedError

    def server_seconds(self, s: ServerProfile, o2, srv_bytes=None):
        """Server-segment seconds (scalar or per-candidate vector)."""
        raise NotImplementedError

    # -- cost assembly --------------------------------------------------
    def breakdown(self, o1: float, o2: float, payload_bits: float,
                  d: DeviceProfile, s: ServerProfile, ch: Channel,
                  dev_bytes: float = 0.0,
                  srv_bytes: float = 0.0) -> CostBreakdown:
        """Eq. 5–8/15–16 generalized: compute/memory stage times from
        the provider, transmission and energy kept analytic (the radio
        and the device energy model are not what providers disagree
        about)."""
        r = ch.capacity()
        t_local = self.device_seconds(d, o1, dev_bytes)
        e_local = d.kappa * d.f_clock ** 2 * o1 * d.gamma
        t_server = self.server_seconds(s, o2, srv_bytes)
        t_tran = payload_bits / r
        e_tran = d.tx_power * t_tran
        return CostBreakdown(float(t_local), float(t_server), t_tran,
                             e_local, e_tran, float(t_server) * s.zeta)

    # -- offline (Alg. 1) coefficients ---------------------------------
    _OFFLINE_KEYS = {TERM_O1: "xi", TERM_O2: "delta", TERM_WIRE: "eps",
                     TERM_DEV_BYTES: "c_dev_bytes",
                     TERM_SRV_BYTES: "c_srv_bytes"}

    def offline_coeffs(self, w: ObjectiveWeights, d: DeviceProfile,
                       ch: Channel, s: ServerProfile) -> dict:
        """Coefficients ``build_offline_store`` prices plans with —
        derived from the SAME ``coeffs`` vector the online paths use,
        so stored objectives and online pricing never drift. Terms the
        provider does not price default to 0.0."""
        out = {"xi": 0.0, "delta": 0.0, "eps": 0.0,
               "c_dev_bytes": 0.0, "c_srv_bytes": 0.0}
        for k, c in zip(self.term_ids, self.coeffs(w, d, ch, s)):
            out[self._OFFLINE_KEYS[k]] = float(c)
        return out


class AnalyticCost(CostProvider):
    """The paper's Table II math (Eq. 5–16, reduced coefficients
    Eq. 24–26) — the bit-exact default: every float it produces is
    identical to the pre-provider code path."""

    name = "analytic"
    term_ids = (TERM_O1, TERM_O2, TERM_WIRE)

    def coeffs(self, w, d, ch, s) -> np.ndarray:
        return np.array([xi_coeff(w, d), delta_coeff(w, s),
                         eps_coeff(w, d, ch)])

    def server_correction(self, w, ref, srv, rows) -> np.ndarray:
        return (delta_coeff(w, srv) - delta_coeff(w, ref)) * rows.o2

    def device_seconds(self, d, o1, dev_bytes=None):
        return o1 * d.gamma / d.f_clock

    def server_seconds(self, s, o2, srv_bytes=None):
        return o2 * s.gamma / s.f_clock

    def breakdown(self, o1, o2, payload_bits, d, s, ch,
                  dev_bytes=0.0, srv_bytes=0.0) -> CostBreakdown:
        return cost_breakdown(o1, o2, payload_bits, d, s, ch)


class RooflineCost(CostProvider):
    """Memory-roofline pricing (DESIGN.md §3 made a first-class cost):
    each compute stage pays an additive memory-traffic term on top of
    the analytic MAC term —

        t_local  = O1·gamma/f  +  dev_bytes / mem_bw_device
        t_server = O2·gamma/f  +  srv_bytes / mem_bw_server

    ``dev_bytes`` streams the QUANTIZED segment (the plan's deployed
    bit-widths — quantization's b/16 HBM cut shows up here, not just on
    the radio), ``srv_bytes`` the full-precision tail. Additive rather
    than max(): the objective stays linear in the term vectors, and the
    stage time is always lower-bounded by its compute-only term."""

    name = "roofline"
    term_ids = (TERM_O1, TERM_O2, TERM_WIRE, TERM_DEV_BYTES, TERM_SRV_BYTES)

    def coeffs(self, w, d, ch, s) -> np.ndarray:
        return np.array([xi_coeff(w, d), delta_coeff(w, s),
                         eps_coeff(w, d, ch),
                         w.omega / d.mem_bw,
                         (w.omega + w.eta * s.zeta) / s.mem_bw])

    def server_correction(self, w, ref, srv, rows) -> np.ndarray:
        corr = (delta_coeff(w, srv) - delta_coeff(w, ref)) * rows.o2
        c_sb = (w.omega + w.eta * srv.zeta) / srv.mem_bw \
            - (w.omega + w.eta * ref.zeta) / ref.mem_bw
        return corr + c_sb * rows.srv_bytes

    def device_seconds(self, d, o1, dev_bytes=0.0):
        dev_bytes = 0.0 if dev_bytes is None else dev_bytes
        return o1 * d.gamma / d.f_clock + dev_bytes / d.mem_bw

    def server_seconds(self, s, o2, srv_bytes=0.0):
        srv_bytes = 0.0 if srv_bytes is None else srv_bytes
        return o2 * s.gamma / s.f_clock + srv_bytes / s.mem_bw


@dataclasses.dataclass
class StageRates:
    """Fitted linear rates of one compute stage: seconds ≈
    r_mac·MACs + r_byte·bytes + r_const (the constant is per-dispatch
    overhead; it is charged only when the stage runs at all)."""
    r_mac: float
    r_byte: float
    r_const: float = 0.0

    def seconds(self, macs, nbytes):
        nbytes = 0.0 if nbytes is None else nbytes
        base = self.r_mac * macs + self.r_byte * nbytes
        return base + self.r_const * (np.asarray(macs) > 0)


class CalibratedCost(CostProvider):
    """Measurement-calibrated pricing: per-device/per-server
    ``StageRates`` fitted by the ``CalibrationLedger`` from wall-clock-
    fenced ``Deployment.execute`` stage timings. Coefficients keep the
    analytic energy/wire model (the radio is not measured) and replace
    the TIME rates with the fitted ones; the per-dispatch constants are
    priced into the stage estimates and breakdowns but not into the
    argmin row — a constant shifts every candidate that uses the stage
    equally, so it can only matter at the p=0 / p=L boundary (where one
    stage is skipped): a deliberate approximation that keeps the
    objective linear in the term vectors."""

    name = "calibrated"
    term_ids = (TERM_O1, TERM_O2, TERM_WIRE, TERM_DEV_BYTES, TERM_SRV_BYTES)

    def __init__(self, device_rates: dict, server_rates: dict,
                 default_device: StageRates, default_server: StageRates,
                 accept_rate: Optional[float] = None):
        self.device_rates = device_rates      # DeviceProfile -> StageRates
        self.server_rates = server_rates      # ServerProfile -> StageRates
        self.default_device = default_device
        self.default_server = default_server
        # pooled measured draft-acceptance rate (DESIGN.md §14) — what
        # the fleet engine's speculative lane resolves its default
        # ``accept_rate`` from when pricing through a calibrated
        # provider; None until a speculative generation was recorded
        self.mean_accept_rate = None if accept_rate is None \
            else float(accept_rate)

    def _dev(self, d: DeviceProfile) -> StageRates:
        return self.device_rates.get(d, self.default_device)

    def _srv(self, s: ServerProfile) -> StageRates:
        return self.server_rates.get(s, self.default_server)

    def coeffs(self, w, d, ch, s) -> np.ndarray:
        rd, rs = self._dev(d), self._srv(s)
        c_srv = w.omega + w.eta * s.zeta
        return np.array([
            w.omega * rd.r_mac + w.tau * d.gamma * d.kappa * d.f_clock ** 2,
            c_srv * rs.r_mac,
            eps_coeff(w, d, ch),
            w.omega * rd.r_byte,
            c_srv * rs.r_byte])

    def server_correction(self, w, ref, srv, rows) -> np.ndarray:
        r_ref, r_srv = self._srv(ref), self._srv(srv)
        c_ref, c_srv = w.omega + w.eta * ref.zeta, w.omega + w.eta * srv.zeta
        corr = (c_srv * r_srv.r_mac - c_ref * r_ref.r_mac) * rows.o2
        if rows.srv_bytes is not None:
            corr = corr + (c_srv * r_srv.r_byte
                           - c_ref * r_ref.r_byte) * rows.srv_bytes
        return corr

    def device_seconds(self, d, o1, dev_bytes=None):
        return self._dev(d).seconds(o1, dev_bytes)

    def server_seconds(self, s, o2, srv_bytes=None):
        return self._srv(s).seconds(o2, srv_bytes)


@dataclasses.dataclass
class _LedgerSample:
    device: DeviceProfile
    server: ServerProfile
    o1: float
    o2: float
    dev_bytes: float
    srv_bytes: float
    t_device: float
    t_server: float


class CalibrationLedger:
    """Least-squares closure of the predict → measure loop: collects
    (term scalars, measured stage seconds) samples from executed
    deployments and fits per-device/per-server ``StageRates``.

    The fit solves ``t ≈ r_mac·MACs + r_byte·bytes + r_const`` per
    group by non-negative-clipped least squares; groups (a distinct
    device or server profile) with fewer than ``min_samples`` samples
    fall back to the pooled global fit."""

    def __init__(self, min_samples: int = 3):
        self.samples: List[_LedgerSample] = []
        self.min_samples = min_samples
        # (drafts proposed, drafts accepted) per speculative generation —
        # pooled into ``mean_accept_rate`` (DESIGN.md §14)
        self.accept_samples: List[tuple] = []

    def __len__(self) -> int:
        return len(self.samples)

    def add(self, device: DeviceProfile, server: ServerProfile,
            o1: float, o2: float, dev_bytes: float, srv_bytes: float,
            t_device: float, t_server: float) -> None:
        self.samples.append(_LedgerSample(device, server, o1, o2,
                                          dev_bytes, srv_bytes,
                                          t_device, t_server))

    def record(self, deployment, server: ServerProfile) -> None:
        """Ingest one executed ``Deployment`` (its
        ``result.extra['measured']`` stage timings must exist — run
        ``Deployment.execute`` first). Terms are computed at the
        EXECUTED batch size, not the request's nominal one."""
        meas = deployment.result.extra.get("measured")
        if not meas:
            raise ValueError(
                "deployment has no measured stage timings — call "
                "Deployment.execute(test_x, test_y) before record()")
        specs = deployment.backend.layer_specs(batch=int(meas["batch"]))
        o1, o2, dev_b, srv_b = plan_cost_terms(deployment.plan, specs)
        self.add(deployment.request.device, server, o1, o2, dev_b, srv_b,
                 float(meas["t_device_s"]), float(meas["t_server_s"]))

    def record_decode(self, deployment, server: ServerProfile) -> None:
        """Ingest one streamed generation (``Deployment.generate`` fills
        ``result.extra['measured_decode']``): the aggregate decode stage
        seconds regress against N_tokens × the per-token decode terms —
        same linear model, so decode samples sharpen the same
        ``StageRates`` the prefill samples fit."""
        meas = deployment.result.extra.get("measured_decode")
        if not meas:
            raise ValueError(
                "deployment has no measured decode timings — call "
                "Deployment.generate(prompt, max_new_tokens) first")
        specs = deployment.backend.decode_layer_specs(
            batch=int(meas["batch"]))
        o1, o2, dev_b, srv_b = plan_cost_terms(deployment.plan, specs)
        n = float(meas["new_tokens"])
        self.add(deployment.request.device, server, o1 * n, o2 * n,
                 dev_b * n, srv_b * n,
                 float(meas["t_device_s"]), float(meas["t_server_s"]))
        if meas.get("accept_rate") is not None:
            self.accept_samples.append(
                (float(meas.get("drafts_proposed", 0)),
                 float(meas.get("drafts_accepted", 0))))

    @property
    def mean_accept_rate(self) -> Optional[float]:
        """Pooled measured draft acceptance (accepted / proposed over
        every recorded speculative generation); None until one lands."""
        proposed = sum(p for p, _ in self.accept_samples)
        if proposed <= 0:
            return None
        return sum(a for _, a in self.accept_samples) / proposed

    # ------------------------------------------------------------------
    @staticmethod
    def _fit_stage(macs, nbytes, secs) -> Optional[StageRates]:
        keep = np.asarray(macs) > 0          # stage actually ran
        macs = np.asarray(macs, np.float64)[keep]
        nbytes = np.asarray(nbytes, np.float64)[keep]
        secs = np.asarray(secs, np.float64)[keep]
        if len(secs) == 0:
            return None
        x = np.stack([macs, nbytes, np.ones_like(macs)], axis=1)
        sol, *_ = np.linalg.lstsq(x, secs, rcond=None)
        sol = np.maximum(sol, 0.0)           # rates are physical
        return StageRates(float(sol[0]), float(sol[1]), float(sol[2]))

    def fit(self) -> CalibratedCost:
        if not self.samples:
            raise ValueError("empty calibration ledger — record executed "
                             "deployments first")

        def stage(samples, attr_macs, attr_bytes, attr_t):
            return self._fit_stage(
                [getattr(s, attr_macs) for s in samples],
                [getattr(s, attr_bytes) for s in samples],
                [getattr(s, attr_t) for s in samples])

        glob_dev = stage(self.samples, "o1", "dev_bytes", "t_device") \
            or StageRates(0.0, 0.0, 0.0)
        glob_srv = stage(self.samples, "o2", "srv_bytes", "t_server") \
            or StageRates(0.0, 0.0, 0.0)
        by_dev: dict = {}
        by_srv: dict = {}
        for s in self.samples:
            by_dev.setdefault(s.device, []).append(s)
            by_srv.setdefault(s.server, []).append(s)
        dev_rates = {}
        for d, group in by_dev.items():
            if len(group) >= self.min_samples:
                r = stage(group, "o1", "dev_bytes", "t_device")
                if r is not None:
                    dev_rates[d] = r
        srv_rates = {}
        for sv, group in by_srv.items():
            if len(group) >= self.min_samples:
                r = stage(group, "o2", "srv_bytes", "t_server")
                if r is not None:
                    srv_rates[sv] = r
        return CalibratedCost(dev_rates, srv_rates, glob_dev, glob_srv,
                              accept_rate=self.mean_accept_rate)


def expected_tokens_per_round(draft_k: int, accept_rate: float) -> float:
    """Expected tokens one speculative decode round emits (DESIGN.md
    §14): the verified-prefix emission is 1 (the server's own sample) +
    the accepted drafts, so under a per-draft acceptance rate ``α`` the
    expectation is ``1 + α·k`` — the factor the per-round pricing terms
    divide by to get effective per-token cost, and the mean the fleet
    engine's deterministic fractional accumulator reproduces exactly
    over any window of rounds."""
    k = int(draft_k)
    if k < 0:
        raise ValueError("draft_k must be >= 0")
    a = float(accept_rate)
    if not 0.0 <= a <= 1.0:
        raise ValueError("accept_rate must be within [0, 1]")
    return 1.0 + a * k


ANALYTIC = AnalyticCost()       # the module-wide default provider
