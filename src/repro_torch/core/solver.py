"""Closed-form QPART optimizer (paper §IV, Eq. 23–40).

Problem (per partition point p, Eq. 28 with the segment indices fixed —
the paper's Eq. 23 sums over l>=p but its own system description, Eq. 14
and Alg. 1 quantize the FIRST segment l=1..p; we implement the latter and
note the index typo in DESIGN.md):

    min_b   xi*O1(p) + delta*O2(p) + eps*( b_x * z_x(p) + sum_{l<=p} b_l z_l^w )
    s.t.    s_x(p) e^{-ln4 b_x}/rho_p + sum_{l<=p} s_l e^{-ln4 b_l}/rho_l <= Delta

KKT stationarity (Eq. 38) gives, for every quantized item i:

    eps * z_i = lambda * ln4 * (s_i/rho_i) * e^{-ln4 b_i}
    =>  z_i * rho_i / (s_i e^{-ln4 b_i}) = lambda * ln4 / eps = const   (Eq. 39)

i.e. equalized marginal payload-per-noise (water-filling). With the
constraint active, lambda has the closed form

    sum_i eps*z_i / (lambda ln4) = Delta   =>   lambda = eps * sum_i z_i / (Delta ln4)

and  b_i = log4( s_i ln4 lambda / (eps z_i rho_i) ). Items whose optimal
bit-width falls outside [b_min, b_max] are clamped and the multiplier is
re-solved on the active set (standard water-filling iteration; at most
n_items rounds).

Two execution forms of the same math (DESIGN.md §2):

  * ``waterfill_bits``       — scalar reference, one partition point.
  * ``waterfill_bits_batch`` — all partition points of an accuracy level
    as one (L, L+1) masked-matrix program: row r holds the ragged item
    set of partition p=r+1 (weights 1..p + the cut activation) and the
    active-set clamping iterates batched across the p axis. This is what
    ``build_offline_store`` / ``solve_joint`` run by default, turning
    Alg. 1 from O(levels × L) separate Python solves into O(levels)
    array programs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np

LN4 = math.log(4.0)


@dataclasses.dataclass
class SegmentItems:
    """Quantizable items of the device segment at partition p: the p weight
    tensors followed by the cut activation (the paper's z vector)."""
    z: np.ndarray        # payload sizes (elements)
    s: np.ndarray        # noise scales at output
    rho: np.ndarray      # robustness parameters


@dataclasses.dataclass
class BitSolution:
    bits: np.ndarray          # continuous optimal bit-widths, item-ordered
    lam: float                # KKT multiplier
    psi_total: float          # achieved constraint value
    payload_bits: float       # sum b_i z_i  (+ activation term)


def waterfill_bits(items: SegmentItems, delta: float,
                   b_min: float = 2.0, b_max: float = 16.0) -> BitSolution:
    """Equal-marginal closed form with active-set clamping (scalar
    reference; the batched twin is ``waterfill_bits_batch``)."""
    z = np.asarray(items.z, dtype=np.float64)
    s = np.asarray(items.s, dtype=np.float64)
    rho = np.asarray(items.rho, dtype=np.float64)
    n = len(z)
    assert len(s) == n and len(rho) == n and delta > 0

    free = np.ones(n, dtype=bool)
    bits = np.zeros(n)
    budget = delta
    # lam stays +inf when the budget is infeasible before the first
    # multiplier solve (everything clamps to b_max immediately)
    lam = math.inf
    for _ in range(n + 1):
        if not free.any():
            break
        # noise contributed by clamped items
        clamped_noise = np.sum((s[~free] / rho[~free]) * np.exp(-LN4 * bits[~free]))
        rem = budget - clamped_noise
        if rem <= 0:
            # infeasible at current clamps: push everything to b_max
            bits[free] = b_max
            free[:] = False
            break
        lam = np.sum(z[free]) / (rem * LN4)          # eps cancels in bits
        with np.errstate(divide="ignore"):
            b_free = np.log(s[free] * LN4 * lam / (z[free] * rho[free])) / LN4
        lo, hi = b_free < b_min, b_free > b_max
        newly = np.zeros(n, dtype=bool)
        newly[np.where(free)[0][lo]] = True
        bits[np.where(free)[0][lo]] = b_min
        newly2 = np.zeros(n, dtype=bool)
        newly2[np.where(free)[0][hi]] = True
        bits[np.where(free)[0][hi]] = b_max
        if not (lo.any() or hi.any()):
            bits[free] = b_free
            free[:] = False
            break
        free &= ~(newly | newly2)
    psi = float(np.sum((s / rho) * np.exp(-LN4 * bits)))
    payload = float(np.sum(bits * z))
    return BitSolution(bits=bits, lam=float(lam) if n else 0.0,
                       psi_total=psi, payload_bits=payload)


def _waterfill_invariants(z, s, rho, valid):
    """Per-item loop invariants of the batched solve: masked payloads,
    noise-over-robustness, and the additive log term of Eq. 39
    (b_i = log4(lambda) + C_i on the free set)."""
    z = np.where(valid, np.asarray(z, np.float64), 1.0)
    s = np.where(valid, np.asarray(s, np.float64), 1.0)
    rho = np.where(valid, np.asarray(rho, np.float64), 1.0)
    sr = s / rho
    with np.errstate(divide="ignore", invalid="ignore"):
        c_item = np.log(s * LN4 / (z * rho)) / LN4
    return z, sr, c_item


def waterfill_bits_batch(z, s, rho, valid, delta,
                         b_min: float = 2.0, b_max: float = 16.0,
                         _tile: int = 1):
    """R independent water-filling problems in one vectorized pass.

    ``z``, ``s``, ``rho`` are (R, I) matrices; ``valid`` (R, I) masks the
    ragged item sets; ``delta`` is a scalar or (R,) budget vector. Entries
    outside ``valid`` are ignored (they may hold arbitrary placeholders).
    ``_tile=G`` solves the SAME item matrices under G stacked budget
    groups (delta of length G*R, group-major) while computing the
    transcendental invariants only once on the base — the Alg. 1 case
    where every accuracy level shares the layer profile.

    Returns ``(bits (G*R, I), lam, psi, payload)`` matching
    ``waterfill_bits`` row-by-row to float precision: the active-set
    trajectory (multiplier solve, lo/hi clamping, infeasibility bail-out)
    is replicated per row, just batched across rows (DESIGN.md §2).
    """
    valid = np.asarray(valid, bool)
    z, sr, c_item = _waterfill_invariants(z, s, rho, valid)
    if _tile > 1:
        z, sr, c_item, valid = (np.tile(m, (_tile, 1))
                                for m in (z, sr, c_item, valid))
    R, I = z.shape
    deltas = np.broadcast_to(np.asarray(delta, np.float64), (R,)).copy()
    assert np.all(deltas > 0)
    # a clamped item's noise is its s/rho times a CONSTANT factor
    # (e^{-ln4 b_min} or e^{-ln4 b_max}), so the backlog accumulates
    # incrementally — no per-iteration exp/log over the full matrix
    e_min, e_max = math.exp(-LN4 * b_min), math.exp(-LN4 * b_max)

    out_bits = np.zeros((R, I))
    out_lam = np.full(R, np.inf)
    # compact working set: rows leave it (and are emitted to out_*) as
    # soon as they converge, so late clamp rounds — where only a handful
    # of tight-budget rows remain — run on tiny arrays
    idx = np.flatnonzero(valid.any(axis=1))
    if len(idx) == R:       # common case: no empty rows, skip the gather
        zc, src, cc = z, sr, c_item
        free = valid.copy()
    else:
        zc, src, cc, deltas = z[idx], sr[idx], c_item[idx], deltas[idx]
        free = valid[idx].copy()
    bits = np.zeros((len(idx), I))
    lam = np.full(len(idx), np.inf)
    clamped_noise = np.zeros(len(idx))
    for _ in range(I + 1):
        alive = free.any(axis=1)
        if not alive.all():
            done_rows = ~alive
            out_bits[idx[done_rows]] = bits[done_rows]
            out_lam[idx[done_rows]] = lam[done_rows]
            idx = idx[alive]
            zc, src, cc = zc[alive], src[alive], cc[alive]
            deltas, free, bits = deltas[alive], free[alive], bits[alive]
            lam, clamped_noise = lam[alive], clamped_noise[alive]
        if not len(idx):
            break
        rem = deltas - clamped_noise
        infeas = rem <= 0.0
        if infeas.any():
            bits = np.where(free & infeas[:, None], b_max, bits)
            free &= ~infeas[:, None]
        act = ~infeas
        zsum = np.where(free, zc, 0.0).sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            lam_r = zsum / (rem * LN4)
            b_cand = (np.log(lam_r) / LN4)[:, None] + cc
        lam = np.where(act, lam_r, lam)
        lo = free & act[:, None] & (b_cand < b_min)
        hi = free & act[:, None] & (b_cand > b_max)
        if lo.any() or hi.any():
            bits = np.where(lo, b_min, np.where(hi, b_max, bits))
            clamped_noise = clamped_noise \
                + np.where(lo, src, 0.0).sum(axis=1) * e_min \
                + np.where(hi, src, 0.0).sum(axis=1) * e_max
            done = act & ~(lo | hi).any(axis=1)
        else:
            done = act
        bits = np.where(free & done[:, None], b_cand, bits)
        free &= ~(lo | hi | done[:, None])
    if len(idx):                                    # safety net: emit rest
        out_bits[idx] = bits
        out_lam[idx] = lam
    # psi over the valid entries only (exp is the dominant cost here)
    row_idx, col_idx = np.nonzero(valid)
    noise = sr[row_idx, col_idx] * np.exp(-LN4 * out_bits[row_idx, col_idx])
    psi = np.bincount(row_idx, weights=noise, minlength=R)
    payload = np.bincount(
        row_idx,
        weights=out_bits[row_idx, col_idx] * z[row_idx, col_idx],
        minlength=R)
    return out_bits, out_lam, psi, payload


# ---------------------------------------------------------------------------
# Joint (b, p) search: the paper's Alg. 1 (offline) + Alg. 2 (online).

@dataclasses.dataclass(slots=True)
class PartitionPlan:
    p: int                     # partition point (device runs layers 1..p)
    bits_w: np.ndarray         # per-layer weight bit-widths (len p)
    bits_x: float              # activation bit-width at the cut
    objective: float           # Eq. 17/23 value
    psi_total: float
    payload_bits: float
    breakdown: dict
    payload_w_bits: float = 0.0   # weight share of the wire (Eq. 14 Z_w)
    payload_x_bits: float = 0.0   # activation share (Z_x) — all that is
                                  # left when the device cached the segment
    device_memory_bytes: float = 0.0   # quantized-segment footprint at the
                                       # DEPLOYED (ceil-rounded) bit-widths —
                                       # what DeviceProfile.memory_bytes is
                                       # checked against at plan time


def _byte_rows(layer_act_bytes, layer_w_bytes16):
    """The canonical byte-term rows (``cost_model.byte_term_rows``) for
    the optional memory-roofline objective terms — imported lazily so
    this module keeps no import-time dependency on the cost model."""
    from repro_torch.core.cost_model import byte_term_rows
    return byte_term_rows(layer_act_bytes, layer_w_bytes16)


def plan_for_partition(p: int, layer_z_w, layer_z_x, layer_s_w, layer_s_x,
                       layer_rho, o_cum, o_total, xi, delta_cost, eps,
                       psi_budget, b_min=2.0, b_max=16.0,
                       input_z: float = 0.0,
                       c_dev_bytes: float = 0.0, c_srv_bytes: float = 0.0,
                       ab_cum=None, srv_byte_row=None) -> PartitionPlan:
    """Optimal bits for a fixed partition point p (1-indexed; p=0 means the
    whole model runs on the server: the device uploads the raw input at
    full precision and nothing is quantized). With nonzero
    ``c_dev_bytes``/``c_srv_bytes`` (a roofline/calibrated provider's
    offline coefficients) the objective additionally prices memory
    traffic: the deployed quantized segment + activations on the device,
    the bf16 tail on the server (rows from ``_byte_rows``)."""
    price_bytes = (c_dev_bytes != 0.0 or c_srv_bytes != 0.0) \
        and ab_cum is not None
    if p == 0:
        o1, o2 = 0.0, o_total
        obj = xi * o1 + delta_cost * o2 + eps * 32.0 * input_z
        breakdown = {"compute_local": 0.0,
                     "compute_server": delta_cost * o2,
                     "payload": eps * 32.0 * input_z}
        if price_bytes:
            breakdown["memory_device"] = 0.0
            breakdown["memory_server"] = c_srv_bytes * srv_byte_row[0]
            obj = obj + breakdown["memory_server"]
        return PartitionPlan(0, np.zeros(0), 32.0, float(obj), 0.0,
                             32.0 * input_z, breakdown,
                             payload_w_bits=0.0,
                             payload_x_bits=32.0 * input_z)
    items = SegmentItems(
        z=np.array(list(layer_z_w[:p]) + [layer_z_x[p - 1]], dtype=np.float64),
        s=np.array(list(layer_s_w[:p]) + [layer_s_x[p - 1]], dtype=np.float64),
        rho=np.array(list(layer_rho[:p]) + [layer_rho[p - 1]], dtype=np.float64),
    )
    sol = waterfill_bits(items, psi_budget, b_min, b_max)
    o1 = o_cum[p - 1]
    o2 = o_total - o1
    payload = sol.payload_bits
    payload_x = float(sol.bits[-1] * items.z[-1])
    obj = xi * o1 + delta_cost * o2 + eps * payload
    mem = float(np.sum(np.clip(np.ceil(sol.bits[:-1]), 2, 16)
                       * items.z[:-1]) / 8.0)
    breakdown = {"compute_local": xi * o1, "compute_server": delta_cost * o2,
                 "payload": eps * payload}
    if price_bytes:
        breakdown["memory_device"] = c_dev_bytes * (mem + ab_cum[p])
        breakdown["memory_server"] = c_srv_bytes * srv_byte_row[p]
        obj = obj + breakdown["memory_device"] + breakdown["memory_server"]
    return PartitionPlan(
        p=p, bits_w=sol.bits[:-1], bits_x=float(sol.bits[-1]),
        objective=float(obj), psi_total=sol.psi_total, payload_bits=payload,
        breakdown=breakdown,
        payload_w_bits=payload - payload_x, payload_x_bits=payload_x,
        device_memory_bytes=mem)


def _segment_matrices(layer_z_w, layer_z_x, layer_s_w, layer_s_x, layer_rho):
    """(L, L+1) item matrices for all partitions p=1..L at once: row r is
    partition p=r+1, columns 0..L-1 the weight items (valid for j <= r),
    column L the cut activation at layer p."""
    z_w = np.asarray(layer_z_w, np.float64)
    z_x = np.asarray(layer_z_x, np.float64)
    s_w = np.asarray(layer_s_w, np.float64)
    s_x = np.asarray(layer_s_x, np.float64)
    rho_l = np.asarray(layer_rho, np.float64)
    L = len(z_w)
    valid = np.zeros((L, L + 1), bool)
    valid[:, :L] = np.tril(np.ones((L, L), bool))
    valid[:, L] = True
    z = np.ones((L, L + 1))
    s = np.ones((L, L + 1))
    rho = np.ones((L, L + 1))
    z[:, :L], z[:, L] = z_w[None, :], z_x
    s[:, :L], s[:, L] = s_w[None, :], s_x
    rho[:, :L], rho[:, L] = rho_l[None, :], rho_l
    return z, s, rho, valid


def _plans_from_rows(bits, psi, payload, layer_z_w, layer_z_x, o_cum,
                     o_total, xi, delta_cost, eps,
                     c_dev_bytes: float = 0.0, c_srv_bytes: float = 0.0,
                     ab_cum=None, srv_byte_row=None) -> List[PartitionPlan]:
    """Materialize PartitionPlans for p=1..L from one batched solution
    block (row r = partition p=r+1)."""
    L = bits.shape[0]
    z_w = np.asarray(layer_z_w, np.float64)
    z_x = np.asarray(layer_z_x, np.float64)
    o_cum = np.asarray(o_cum, np.float64)
    payload_x = bits[:, L] * z_x
    o1 = o_cum
    o2 = o_total - o1
    obj = xi * o1 + delta_cost * o2 + eps * payload
    # deployed (ceil-rounded) segment footprint, weight columns 0..r only
    tril = np.tril(np.ones((L, L), bool))
    mem = np.where(tril, np.clip(np.ceil(bits[:, :L]), 2, 16) * z_w[None, :],
                   0.0).sum(axis=1) / 8.0
    price_bytes = (c_dev_bytes != 0.0 or c_srv_bytes != 0.0) \
        and ab_cum is not None
    if price_bytes:
        mem_dev = c_dev_bytes * (mem + ab_cum[1:])
        mem_srv = c_srv_bytes * srv_byte_row[1:]
        obj = obj + mem_dev + mem_srv
        mem_dev_l, mem_srv_l = mem_dev.tolist(), mem_srv.tolist()
    # bulk scalar extraction (tolist) beats per-element numpy-scalar float()
    bits_x_l = bits[:, L].tolist()
    obj_l, psi_l, pay_l = obj.tolist(), psi.tolist(), payload.tolist()
    pay_x_l = payload_x.tolist()
    loc_l, srv_l = (xi * o1).tolist(), (delta_cost * o2).tolist()
    eps_pay_l = (eps * payload).tolist()
    mem_l = mem.tolist()
    plans = []
    for r in range(L):
        p = r + 1
        breakdown = {"compute_local": loc_l[r],
                     "compute_server": srv_l[r],
                     "payload": eps_pay_l[r]}
        if price_bytes:
            breakdown["memory_device"] = mem_dev_l[r]
            breakdown["memory_server"] = mem_srv_l[r]
        plans.append(PartitionPlan(
            p=p, bits_w=bits[r, :p].copy(), bits_x=bits_x_l[r],
            objective=obj_l[r], psi_total=psi_l[r],
            payload_bits=pay_l[r],
            breakdown=breakdown,
            payload_w_bits=pay_l[r] - pay_x_l[r],
            payload_x_bits=pay_x_l[r],
            device_memory_bytes=mem_l[r]))
    return plans


def plan_all_partitions(layer_z_w, layer_z_x, layer_s_w, layer_s_x, layer_rho,
                        o_cum, o_total, xi, delta_cost, eps, psi_budget,
                        b_min=2.0, b_max=16.0,
                        input_z: float = 0.0,
                        c_dev_bytes: float = 0.0, c_srv_bytes: float = 0.0,
                        ab_cum=None, srv_byte_row=None) -> List[PartitionPlan]:
    """All partition points p=0..L of one accuracy level as a single
    vectorized solve — the hot path of Alg. 1 (DESIGN.md §2). Plan-for-plan
    equal to ``[plan_for_partition(p, ...) for p in 0..L]``."""
    L = len(layer_z_w)
    plans = [plan_for_partition(0, layer_z_w, layer_z_x, layer_s_w,
                                layer_s_x, layer_rho, o_cum, o_total, xi,
                                delta_cost, eps, psi_budget, b_min, b_max,
                                input_z=input_z, c_dev_bytes=c_dev_bytes,
                                c_srv_bytes=c_srv_bytes, ab_cum=ab_cum,
                                srv_byte_row=srv_byte_row)]
    if L == 0:
        return plans
    z, s, rho, valid = _segment_matrices(layer_z_w, layer_z_x, layer_s_w,
                                         layer_s_x, layer_rho)
    bits, _lam, psi, payload = waterfill_bits_batch(
        z, s, rho, valid, psi_budget, b_min, b_max)
    plans += _plans_from_rows(bits, psi, payload, layer_z_w, layer_z_x,
                              o_cum, o_total, xi, delta_cost, eps,
                              c_dev_bytes=c_dev_bytes,
                              c_srv_bytes=c_srv_bytes, ab_cum=ab_cum,
                              srv_byte_row=srv_byte_row)
    return plans


def solve_joint(layer_z_w, layer_z_x, layer_s_w, layer_s_x, layer_rho,
                layer_o, xi, delta_cost, eps, psi_budget,
                allow_full_offload: bool = True,
                b_min=2.0, b_max=16.0, input_z: float = 0.0,
                vectorized: bool = True,
                c_dev_bytes: float = 0.0, c_srv_bytes: float = 0.0,
                layer_act_bytes=None, layer_w_bytes16=None):
    """Enumerate partition points (Alg. 2 step 2–5), closed-form bits at
    each, return (best plan, all plans)."""
    L = len(layer_o)
    o_cum = np.cumsum(layer_o)
    o_total = float(o_cum[-1])
    ab_cum = srv_byte_row = None
    if layer_act_bytes is not None and layer_w_bytes16 is not None:
        ab_cum, srv_byte_row = _byte_rows(layer_act_bytes, layer_w_bytes16)
    if vectorized:
        plans = plan_all_partitions(
            layer_z_w, layer_z_x, layer_s_w, layer_s_x, layer_rho, o_cum,
            o_total, xi, delta_cost, eps, psi_budget, b_min, b_max,
            input_z=input_z, c_dev_bytes=c_dev_bytes,
            c_srv_bytes=c_srv_bytes, ab_cum=ab_cum,
            srv_byte_row=srv_byte_row)
        if not allow_full_offload:
            plans = plans[1:]
    else:
        plans = []
        start = 0 if allow_full_offload else 1
        for p in range(start, L + 1):
            plans.append(plan_for_partition(
                p, layer_z_w, layer_z_x, layer_s_w, layer_s_x, layer_rho,
                o_cum, o_total, xi, delta_cost, eps, psi_budget, b_min, b_max,
                input_z=input_z, c_dev_bytes=c_dev_bytes,
                c_srv_bytes=c_srv_bytes, ab_cum=ab_cum,
                srv_byte_row=srv_byte_row))
    best = min(plans, key=lambda pl: pl.objective)
    return best, plans


# ---------------------------------------------------------------------------
# Offline pattern store (Alg. 1) + online lookup (Alg. 2).

@dataclasses.dataclass
class OfflineStore:
    """{(accuracy_level, p) -> PartitionPlan} plus the per-level budgets."""
    levels: Sequence[float]
    plans: dict                 # (a, p) -> PartitionPlan
    budgets: dict               # a -> Delta

    def __post_init__(self):
        self._level_plans_cache: dict = {}
        self._payload_rows_cache: dict = {}
        self._memory_rows_cache: dict = {}

    # -- fast accessors for the batched online path (DESIGN.md §5) ------
    def level_for(self, a: float) -> float:
        """Alg. 2 step 1: largest tabulated level <= a (min level when
        nothing qualifies)."""
        feas = [lv for lv in self.levels if lv <= a]
        return max(feas) if feas else min(self.levels)

    def level_plans(self, a_star: float) -> List[PartitionPlan]:
        """Candidate plans of one level, ordered by partition point."""
        if a_star not in self._level_plans_cache:
            cands = sorted(((p, pl) for (lv, p), pl in self.plans.items()
                            if lv == a_star), key=lambda t: t[0])
            self._level_plans_cache[a_star] = [pl for _, pl in cands]
        return self._level_plans_cache[a_star]

    def level_payload_rows(self, a_star: float):
        """(payload_bits (P+1,), payload_x_bits (P+1,)) of one level's
        candidates, column c = partition point c. Cached: the batched
        online paths (serve_batch / WorkloadBalancer) gather these rows
        instead of walking plan attributes per request."""
        if a_star not in self._payload_rows_cache:
            cands = self.level_plans(a_star)
            self._payload_rows_cache[a_star] = (
                np.array([pl.payload_bits for pl in cands]),
                np.array([pl.payload_x_bits for pl in cands]))
        return self._payload_rows_cache[a_star]

    def level_memory_rows(self, a_star: float) -> np.ndarray:
        """(P+1,) deployed device-segment memory (bytes) of one level's
        candidates — what the plan-time DeviceProfile.memory_bytes check
        compares against (p=0 holds no weights on the device)."""
        if a_star not in self._memory_rows_cache:
            self._memory_rows_cache[a_star] = np.array(
                [pl.device_memory_bytes for pl in self.level_plans(a_star)])
        return self._memory_rows_cache[a_star]

    def lookup(self, a: float, objective_fn,
               feasible_fn=None) -> PartitionPlan:
        """Alg. 2: pick the largest tabulated level <= a, then the partition
        point minimizing the runtime objective (which may differ from the
        offline objective because the channel/device changed).
        ``feasible_fn(plan) -> bool`` drops candidates before the argmin
        (e.g. quantized segments that exceed the device memory); the
        first-minimum tie-break over the surviving candidates matches the
        masked-argmin of the batched window path."""
        cands = self.level_plans(self.level_for(a))
        if feasible_fn is not None:
            cands = [pl for pl in cands if feasible_fn(pl)]
            if not cands:
                raise ValueError("no feasible partition candidate")
        return min(cands, key=objective_fn)


def build_offline_store(levels, budgets, layer_z_w, layer_z_x, layer_s_w,
                        layer_s_x, layer_rho, layer_o, xi, delta_cost, eps,
                        b_min=2.0, b_max=16.0, input_z: float = 0.0,
                        vectorized: bool = True,
                        c_dev_bytes: float = 0.0, c_srv_bytes: float = 0.0,
                        layer_act_bytes=None,
                        layer_w_bytes16=None) -> OfflineStore:
    """Alg. 1 as ONE stacked array program: the (level, partition) grid
    becomes a (levels*L, L+1) batched water-filling solve — every level's
    item matrices are identical, only the budget row-vector differs
    (``vectorized=False`` keeps the O(levels × L) scalar reference the
    equivalence tests and benchmarks compare against). The optional
    ``c_dev_bytes``/``c_srv_bytes`` coefficients (a provider's
    ``offline_coeffs``) add the memory-traffic terms to the stored
    objectives; the water-filling bits are unaffected (the noise budget
    constraint does not price time)."""
    o_cum = np.cumsum(layer_o)
    o_total = float(o_cum[-1])
    L = len(layer_o)
    ab_cum = srv_byte_row = None
    if layer_act_bytes is not None and layer_w_bytes16 is not None:
        ab_cum, srv_byte_row = _byte_rows(layer_act_bytes, layer_w_bytes16)
    byte_kw = dict(c_dev_bytes=c_dev_bytes, c_srv_bytes=c_srv_bytes,
                   ab_cum=ab_cum, srv_byte_row=srv_byte_row)
    plans = {}
    if vectorized and L > 0:
        z, s, rho, valid = _segment_matrices(layer_z_w, layer_z_x, layer_s_w,
                                             layer_s_x, layer_rho)
        A = len(levels)
        deltas = np.repeat([budgets[a] for a in levels], L)
        bits, _lam, psi, payload = waterfill_bits_batch(
            z, s, rho, valid, deltas, b_min, b_max, _tile=A)
        for i, a in enumerate(levels):
            plans[(a, 0)] = plan_for_partition(
                0, layer_z_w, layer_z_x, layer_s_w, layer_s_x, layer_rho,
                o_cum, o_total, xi, delta_cost, eps, budgets[a],
                b_min, b_max, input_z=input_z, **byte_kw)
            rows = slice(i * L, (i + 1) * L)
            for p, plan in enumerate(_plans_from_rows(
                    bits[rows], psi[rows], payload[rows], layer_z_w,
                    layer_z_x, o_cum, o_total, xi, delta_cost, eps,
                    **byte_kw), start=1):
                plans[(a, p)] = plan
    else:
        for a in levels:
            for p in range(0, L + 1):
                plans[(a, p)] = plan_for_partition(
                    p, layer_z_w, layer_z_x, layer_s_w, layer_s_x, layer_rho,
                    o_cum, o_total, xi, delta_cost, eps, budgets[a],
                    b_min, b_max, input_z=input_z, **byte_kw)
    return OfflineStore(levels=list(levels), plans=plans, budgets=dict(budgets))
