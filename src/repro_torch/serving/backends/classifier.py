"""``ClassifierBackend`` — the paper's own MLP/CNN evaluation models
behind the ``ModelBackend`` protocol.

The forward family runs eagerly on the parameters' device (the
reference's compile-once cache has no counterpart). The layers are
plain PyTorch — matmul, conv2d, max-pool — as in the reference, which
reaches no Pallas kernel on this path either. ``calibrate_probes``
loops over the L <= 6 layers in Python with the reference's
construction: the activation probe of layer l re-runs the forward with
``fake_quant`` at the entry of layer l, and the clean side is the same
loop with no layer selected, so both sides of each subtraction run one
op sequence.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.classifier import ClassifierConfig
from repro_torch.core import noise as noise_lib
from repro_torch.core.cost_model import LayerSpec, classifier_layer_specs
from repro_torch.core.partition import DeviceSegment, split_classifier
from repro_torch.core.quantizer import fake_quant
from repro_torch.models.classifier import (apply_layer, classifier_forward,
                                           flat_input, forward_from_layer,
                                           layer_activations)
from repro_torch.serving.backends.base import ModelBackend, to_device


@dataclasses.dataclass
class ClassifierBackend(ModelBackend):
    """cfg: ClassifierConfig; params: list of per-layer {"w", "b"} dicts
    (``models.classifier.init_classifier`` / ``params_from_numpy``; their
    device is the backend's). ``params=None`` serves pricing only."""
    cfg: ClassifierConfig
    params: list

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    @property
    def device(self) -> torch.device:
        if self.params is None:
            return torch.device("cpu")
        return self.params[0]["w"].device

    def layer_specs(self, batch: int = 1,
                    seq_len: Optional[int] = None) -> List[LayerSpec]:
        return self.refine_specs(classifier_layer_specs(self.cfg,
                                                        batch=batch),
                                 batch=batch)

    def input_elements(self) -> float:
        return float(np.prod(self.cfg.input_shape))

    def _x(self, x):
        return to_device(x, self.device)

    def _p(self, params):
        return self.params if params is None else params

    # -- forward family -----------------------------------------------
    def forward(self, x, params=None):
        return classifier_forward(self._p(params), self.cfg, self._x(x))

    def forward_from_layer(self, a, start: int, params=None):
        return forward_from_layer(self._p(params), self.cfg, self._x(a),
                                  start)

    def layer_activations(self, x, params=None):
        return layer_activations(self._p(params), self.cfg, self._x(x))

    def with_layer_quantized(self, layer: int, bits: int):
        noisy = list(self.params)
        noisy[layer] = {k: fake_quant(v, bits)
                        for k, v in self.params[layer].items()}
        return noisy

    # -- Alg. 1 probes ----------------------------------------------------
    def _probe_logits(self, h0, quant_at: int, probe_bits: int):
        """The forward from the flattened input ``h0`` with the
        activation entering layer ``quant_at`` fake-quantized (-1: none,
        the clean side)."""
        h, L = h0, self.num_layers
        for i, (spec, p) in enumerate(zip(self.cfg.layers, self.params)):
            if i == quant_at:
                h = fake_quant(h, probe_bits)
            h = apply_layer(spec, p, h, last=i == L - 1)
        return h

    def calibrate_probes(self, x, probe_bits: int = noise_lib.PROBE_BITS):
        """All L per-layer noise energies (e_w (L,), e_x (L,), clean
        logits)."""
        x = self._x(x)
        L = self.num_layers
        h0 = flat_input(x, self.cfg)
        logits = classifier_forward(self.params, self.cfg, x)
        clean = self._probe_logits(h0, -1, probe_bits)
        e_w, e_x = np.zeros(L), np.zeros(L)
        for l in range(L):
            d_w = classifier_forward(
                self.with_layer_quantized(l, probe_bits), self.cfg, x) \
                - logits
            e_w[l] = float(torch.sum(torch.square(d_w.float())))
            d_x = self._probe_logits(h0, l, probe_bits) - clean
            e_x[l] = float(torch.sum(torch.square(d_x.float())))
        return e_w, e_x, logits

    # -- device-segment execution ---------------------------------------
    def run_prefix(self, x, p: int, params=None):
        """Activation leaving layer p when layers 1..p run with ``params``
        (default: the backend's own; a device segment's quantized list or
        a baseline's pruned list both index the same way)."""
        prm = self._p(params)
        h = flat_input(self._x(x), self.cfg)
        for l in range(p):
            h = apply_layer(self.cfg.layers[l], prm[l], h,
                            last=l == self.num_layers - 1)
        return h

    def split(self, plan) -> DeviceSegment:
        seg, _server = split_classifier(self.params, plan, self.layer_specs())
        return seg

    def run_device_segment(self, seg: DeviceSegment, plan, x):
        h = self.run_prefix(x, plan.p, params=seg.params)
        return fake_quant(h, int(seg.bits_x))
