"""Pricing-only serving fixtures shared by tests, benchmarks and
examples.

A QPART server can be exercised end-to-end through plan → deploy →
(fleet) without ever executing a model: the online path only reads the
offline store and the cost model. ``stub_calibration`` installs
synthetic noise constants (unit energies, flat rho, a linear Delta(a)
table) so ``build_store`` runs the real Alg. 1 solve on them — no
training, no probe forwards, params may be ``None``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights, ServerProfile)
from repro_torch.serving.backends import (ClassifierBackend,
                                          TransformerBackend)
from repro_torch.serving.qpart_server import QPARTServer
from repro_torch.serving.simulator import InferenceRequest


def _stub_noise(srv: QPARTServer, name: str, L: int) -> None:
    m = srv.models[name]
    m.s_w, m.s_x, m.rho = np.ones(L), np.ones(L), np.full(L, 0.1)
    m.delta_table = {a: a * 50 for a in srv.levels}


def stub_calibration(srv: QPARTServer, name: str, cfg,
                     device: DeviceProfile, channel: Channel,
                     weights: ObjectiveWeights) -> None:
    """Register classifier ``cfg`` under ``name`` with synthetic
    calibration constants and build its offline store for the given
    reference context."""
    x = np.zeros((4,) + tuple(np.atleast_1d(cfg.input_shape)), np.float32) \
        if hasattr(cfg, "input_shape") else np.zeros((4, 28, 28), np.float32)
    srv.register(name, ClassifierBackend(cfg, None), x,
                 np.zeros(4, np.int32))
    _stub_noise(srv, name, cfg.num_layers)
    srv.build_store(name, device, channel, weights)


def stub_transformer_calibration(srv: QPARTServer, name: str, cfg,
                                 device: DeviceProfile, channel: Channel,
                                 weights: ObjectiveWeights,
                                 seq_len: int = 32,
                                 decode_max_len: Optional[int] = None,
                                 kv_page_tokens: Optional[int] = None,
                                 ) -> None:
    """Register transformer ``cfg`` under ``name`` with synthetic
    calibration constants (params stay ``None`` — pricing never touches
    them) and build its offline store. A non-None ``decode_max_len``
    marks the backend decode-planned; ``kv_page_tokens`` additionally
    prices KV residency page-granular."""
    srv.register(name, TransformerBackend(cfg, None, seq_len,
                                          decode_max_len=decode_max_len,
                                          kv_page_tokens=kv_page_tokens),
                 np.zeros((4, seq_len), np.int32), np.zeros(4, np.int32))
    _stub_noise(srv, name, cfg.num_layers)
    srv.build_store(name, device, channel, weights)


def stub_classifier_server(configs, server: Optional[ServerProfile] = None,
                           device: Optional[DeviceProfile] = None,
                           channel: Optional[Channel] = None,
                           weights: Optional[ObjectiveWeights] = None,
                           ) -> QPARTServer:
    """A ``QPARTServer`` with every ``(name, cfg)`` of ``configs``
    stub-calibrated against one shared reference context."""
    srv = QPARTServer(server)
    device = device or DeviceProfile()
    channel = channel or Channel(capacity_bps=2e6)
    weights = weights or ObjectiveWeights()
    for name, cfg in configs:
        stub_calibration(srv, name, cfg, device, channel, weights)
    return srv


def poisson_trace(model: str, n: int, rate: float,
                  devices: Sequence[DeviceProfile],
                  channels: Sequence[Channel],
                  weights: ObjectiveWeights,
                  budgets: Sequence[float],
                  deadlines: Sequence[float],
                  batches: Sequence[int] = (1,),
                  device_pool: int = 200, seed: int = 0,
                  ) -> list:
    """A Poisson-arrival request trace over heterogeneous devices,
    channels, budgets, batch sizes and SLOs, with a finite requester
    population (``device_pool`` distinct ``device_id``s)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return [InferenceRequest(
        model, budgets[rng.integers(len(budgets))],
        devices[rng.integers(len(devices))],
        channels[rng.integers(len(channels))], weights,
        batch=int(batches[rng.integers(len(batches))]),
        arrival_time=float(arrivals[i]),
        deadline=float(deadlines[rng.integers(len(deadlines))]),
        device_id=f"dev-{rng.integers(device_pool)}") for i in range(n)]
