"""Baseline offloading schemes the paper compares against (§V, Fig. 7–10,
Table III):

  * no-optimization — the model segment ships at full f32 precision and
    the cut activation uploads at f32 (the paper's "No Optimization").
  * autoencoder     — DeepCOD-style [35]: a linear encoder/decoder pair is
    inserted at the cut; the device uploads the compressed code. Extra
    encode/decode compute is charged to the device/server respectively,
    and the reconstruction perturbs accuracy (really executed).
  * pruning         — two-step-pruning-style [44][45]: weights of the
    device segment are magnitude-pruned to a retention ratio chosen to
    keep measured accuracy degradation comparable to QPART's budget,
    which shrinks the shipped weights.

Every baseline takes a ``ModelBackend`` and returns the same
``ServingResult`` as QPART (priced by the same simulator). All model
execution goes through the backend's forward family / ``run_prefix``.
The pruning baseline assumes the classifier param layout (a list of
per-layer ``{"w", "b"}`` dicts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights, ServerProfile,
                                         cost_breakdown)
from repro_torch.core.solver import PartitionPlan
from repro_torch.serving.backends.base import ModelBackend, to_device
from repro_torch.serving.simulator import ServingResult


def _plan_stub(p: int, payload_bits: float) -> PartitionPlan:
    return PartitionPlan(p=p, bits_w=np.full(max(p, 0), 32.0),
                         bits_x=32.0, objective=0.0, psi_total=0.0,
                         payload_bits=payload_bits, breakdown={})


def _result(plan, specs, device, server, channel, weights,
            extra_dev_macs: float = 0.0,
            extra_srv_macs: float = 0.0) -> ServingResult:
    o = np.array([sp.o for sp in specs], dtype=np.float64)
    o1 = float(o[:plan.p].sum()) + extra_dev_macs
    o2 = float(o[plan.p:].sum()) + extra_srv_macs
    costs = cost_breakdown(o1, o2, plan.payload_bits, device, server, channel)
    res = ServingResult(plan=plan, costs=costs,
                        objective=costs.objective(weights),
                        payload_bits=plan.payload_bits)
    # baselines are priced at zero load, explicitly
    res.extra["queue_delay"] = 0.0
    return res


def _accuracy(logits, y) -> float:
    y = to_device(y, logits.device)
    return float(torch.mean((torch.argmax(logits, -1) == y).float()))


def _measure(res: ServingResult, logits, test_y,
             base_accuracy: Optional[float]) -> None:
    res.accuracy = _accuracy(logits, test_y)
    if base_accuracy is not None:
        res.accuracy_degradation = base_accuracy - res.accuracy


# ---------------------------------------------------------------------------
# 1. No optimization.

def no_opt_offload(backend: ModelBackend, p: int,
                   device: DeviceProfile, server: ServerProfile,
                   channel: Channel, weights: ObjectiveWeights,
                   test_x=None, test_y=None,
                   base_accuracy: Optional[float] = None) -> ServingResult:
    """Ship segment + activation at f32; accuracy == base model."""
    specs = backend.layer_specs()
    wire = sum(specs[i].z_w for i in range(p)) * 32.0
    wire += (specs[p - 1].z_x if p else backend.input_elements()) * 32.0
    res = _result(_plan_stub(p, wire), specs, device, server, channel, weights)
    if test_x is not None:
        _measure(res, backend.forward(test_x), test_y, base_accuracy)
    return res


# ---------------------------------------------------------------------------
# 2. Autoencoder compression at the cut (DeepCOD-style [35]).

@dataclasses.dataclass
class AutoencoderBaseline:
    """Linear AE at the partition point, fitted in closed form (PCA) on
    the calibration activations. The eigendecomposition runs in float64;
    its eigenvectors' signs and order are backend-dependent, the
    projector ``enc @ enc.T`` they span is not."""
    code_ratio: float = 0.25      # code dim = ratio * activation dim

    def offload(self, backend: ModelBackend, p: int, calib_x,
                device, server, channel, weights,
                test_x=None, test_y=None,
                base_accuracy: Optional[float] = None) -> ServingResult:
        if p < 1:
            raise ValueError("autoencoder needs an on-device segment (p >= 1)")
        specs = backend.layer_specs()
        L = backend.num_layers
        acts, logits_c = backend.layer_activations(calib_x)
        # the cut activation = OUTPUT of layer p (input of p+1); at p == L
        # that's the logits themselves
        a = acts[p] if p < L else logits_c
        a = a.reshape(a.shape[0], -1)
        d = a.shape[-1]
        code = max(int(d * self.code_ratio), 1)
        # PCA-style closed-form linear AE: top-`code` principal directions
        mu = a.mean(0)
        ac = a - mu
        cov = (ac.T @ ac) / a.shape[0]
        _, vecs = torch.linalg.eigh(cov.double())
        enc = vecs[:, -code:].float()                  # (d, code)
        # wire: segment at f32 + encoder weights + compressed activation
        # (decoder lives server-side, off the radio link)
        wire = sum(specs[i].z_w for i in range(p)) * 32.0
        wire += d * code * 32.0                          # encoder shipped
        wire += specs[p - 1].z_x * (code / d) * 32.0     # compressed cut
        extra_dev = float(d * code)                    # encode MACs
        extra_srv = float(code * d)                    # decode MACs
        res = _result(_plan_stub(p, wire), specs, device, server, channel,
                      weights, extra_dev, extra_srv)
        if test_x is not None:
            acts_t, logits_t = backend.layer_activations(test_x)
            at = acts_t[p] if p < L else logits_t
            shape_t = at.shape
            at = at.reshape(at.shape[0], -1)
            recon = ((at - mu) @ enc @ enc.T + mu).reshape(shape_t)
            logits = backend.forward_from_layer(recon, p) if p < L else recon
            _measure(res, logits, test_y, base_accuracy)
        res.extra["code_dim"] = code
        return res


# ---------------------------------------------------------------------------
# 3. Magnitude pruning of the device segment ([44][45]).

def _pruned_params(params, p: int, retain: float):
    pruned = [dict(lp) for lp in params]
    kept_elems = []
    for i in range(p):
        w = pruned[i]["w"]
        thresh = torch.quantile(torch.abs(w), 1.0 - retain)
        mask = torch.abs(w) >= thresh
        pruned[i]["w"] = w * mask
        kept_elems.append(float(mask.sum()))
    return pruned, kept_elems


@dataclasses.dataclass
class PruningBaseline:
    retain: float = 0.5           # fraction of weights kept per layer

    def offload(self, backend: ModelBackend, p: int,
                device, server, channel, weights,
                test_x=None, test_y=None,
                base_accuracy: Optional[float] = None) -> ServingResult:
        specs = backend.layer_specs()
        pruned, kept_elems = _pruned_params(backend.params, p, self.retain)
        # wire: sparse encoding ~ (32-bit value + 32-bit index) per kept
        # weight — the honest cost of unstructured sparsity
        wire = sum(k * 64.0 for k in kept_elems)
        wire += (specs[p - 1].z_x if p else backend.input_elements()) * 32.0
        # device MACs shrink with the retained fraction
        o_dev = sum(specs[i].o * self.retain for i in range(p))
        o_full_dev = sum(specs[i].o for i in range(p))
        res = _result(_plan_stub(p, wire), specs, device, server, channel,
                      weights, extra_dev_macs=o_dev - o_full_dev)
        if test_x is not None:
            if p >= 1:
                h = backend.run_prefix(test_x, p, params=pruned)
                logits = backend.forward_from_layer(h, p)
            else:
                logits = backend.forward(test_x)
            _measure(res, logits, test_y, base_accuracy)
        res.extra["retain"] = self.retain
        return res

    def calibrated(self, backend: ModelBackend, p: int, calib_x, calib_y,
                   budget: float, base_accuracy: float):
        """Pick the lowest retention whose measured degradation stays within
        ``budget`` (the paper matches pruning degradation to QPART's)."""
        for retain in (0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 1.0):
            pruned, _ = _pruned_params(backend.params, p, retain)
            h = backend.run_prefix(calib_x, p, params=pruned)
            logits = backend.forward_from_layer(h, p)
            if base_accuracy - _accuracy(logits, calib_y) <= budget:
                return dataclasses.replace(self, retain=retain)
        return dataclasses.replace(self, retain=1.0)
