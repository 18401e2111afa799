"""``ClassifierBackend`` — the paper's own MLP/CNN evaluation models
behind the ``ModelBackend`` protocol.

The layers are plain PyTorch — matmul, conv2d, max-pool — as in the
reference, which reaches no Pallas kernel on this path either. The
forward family runs as the reference's compile-once programs: ``forward``,
``("from_layer", start)``, ``acts``, ``("prefix", p)`` and
``("probe_all", probe_bits)``, each a function of the input and the
leaves of the layers it reads. On a backend whose forward graphs are on
(``forward_graphs``: by default when the parameters live on CUDA) each
program runs through one CUDA graph per (program, input shape and
dtype, the signature of the leaves it reads: their shapes and dtypes),
kept by the backend (``ModelBackend.stage_graphs``), the leaves static
inputs copied in at every replay (``serving.backends.graphs
.graphed_call``). So the backend's own params, a device segment's
quantized list, a pruned list and a ``with_layer_quantized`` list share
one graph whenever their shapes match, as the reference's jit takes the
params as operands. A key's first use runs eagerly, its second eagerly
and then captures, every later use replays; what goes back to a caller
is copied out of the graph's buffers. Off (``forward_graphs=False``, and
on the CPU), the same functions run eagerly.

``calibrate_probes`` is one program over all L probes, with the
reference's construction: the activation probe of layer l re-runs the
forward with ``fake_quant`` at the entry of layer l, and the clean side
is the same loop with no layer selected, so both sides of each
subtraction run one op sequence. The energies stay on the device until
one transfer at the end, f32 sums widened to float64.
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
from repro_torch.serving.backends.graphs import (graphed, graphed_call,
                                                 refuse_off_card)


@dataclasses.dataclass
class ClassifierBackend(ModelBackend):
    """cfg: ClassifierConfig; params: list of per-layer {"w", "b"} dicts
    (``models.classifier.init_classifier`` / ``params_from_numpy``; their
    device is the backend's). ``params=None`` serves pricing only.
    ``forward_graphs`` runs the forward family through the backend's
    graphs: None = on for CUDA parameters, False = eagerly (the twin the
    graphs are held to)."""
    cfg: ClassifierConfig
    params: list
    forward_graphs: Optional[bool] = None

    def __post_init__(self):
        refuse_off_card(self)

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

    # -- the compile-once programs -------------------------------------
    def _run(self, program, fn, x, params, layers):
        """Program ``fn(x, layer_params)`` on input ``x``, reading the
        layers ``layers`` of ``params`` (default: the backend's own):
        through the backend's graph of (``program``, ``x``'s shape and
        dtype, the leaves' shapes and dtypes) when ``graphed(self)``,
        else eagerly. ``layer_params`` maps each layer of ``layers`` to
        its {"w", "b"} dict. Returns ``fn``'s tensor or tuple of
        tensors, never a graph's buffer."""
        prm, x = self._p(params), self._x(x)
        names = [(l, tuple(prm[l])) for l in layers]
        leaves = [prm[l][k] for l, keys in names for k in keys]

        def call(a, *flat):
            it = iter(flat)
            return fn(a, {l: {k: next(it) for k in keys}
                          for l, keys in names})

        if not graphed(self):
            return call(x, *leaves)
        key = (program, tuple(x.shape), x.dtype,
               tuple((l, keys) for l, keys in names),
               tuple((t.shape, t.dtype) for t in leaves))
        out, borrowed = graphed_call(self, key, call, (x, *leaves))
        if not borrowed:
            return out
        if isinstance(out, tuple):
            return tuple(t.clone() for t in out)
        return out.clone()

    def _all(self, lp):
        """The layer list of a program that reads every layer."""
        return [lp[l] for l in range(self.num_layers)]

    # -- forward family -----------------------------------------------
    def forward(self, x, params=None):
        return self._run(
            "forward", lambda a, lp: classifier_forward(self._all(lp),
                                                        self.cfg, a),
            x, params, range(self.num_layers))

    def forward_from_layer(self, a, start: int, params=None):
        def fn(h, lp):
            prm = [lp.get(l) for l in range(self.num_layers)]
            return forward_from_layer(prm, self.cfg, h, start)
        return self._run(("from_layer", start), fn, a, params,
                         range(start, self.num_layers))

    def layer_activations(self, x, params=None):
        def fn(a, lp):
            acts, logits = layer_activations(self._all(lp), self.cfg, a)
            return (*acts, logits)
        out = self._run("acts", fn, x, params, range(self.num_layers))
        return list(out[:-1]), out[-1]

    def with_layer_quantized(self, layer: int, bits: int, params=None):
        """``params`` (default: the backend's own) with layer ``layer``'s
        leaves fake-quantized at ``bits``."""
        noisy = list(self._p(params))
        noisy[layer] = {k: fake_quant(v, bits)
                        for k, v in noisy[layer].items()}
        return noisy

    # -- Alg. 1 probes ----------------------------------------------------
    def _probe_logits(self, prm, h0, quant_at: int, probe_bits: int):
        """The forward from the flattened input ``h0`` with the
        activation entering layer ``quant_at`` fake-quantized (-1: none,
        the clean side)."""
        h, L = h0, self.num_layers
        for i, (spec, p) in enumerate(zip(self.cfg.layers, prm)):
            if i == quant_at:
                h = fake_quant(h, probe_bits)
            h = apply_layer(spec, p, h, last=i == L - 1)
        return h

    def calibrate_probes(self, x, probe_bits: int = noise_lib.PROBE_BITS):
        """All L per-layer noise energies (e_w (L,), e_x (L,), clean
        logits) from one program: the weight probe of layer l is the
        full forward with layer l's leaves fake-quantized
        (``with_layer_quantized``), the activation probe
        ``_probe_logits``."""
        L = self.num_layers

        def probe_all(a, lp):
            prm = self._all(lp)
            h0 = flat_input(a, self.cfg)
            logits = classifier_forward(prm, self.cfg, a)
            clean = self._probe_logits(prm, h0, -1, probe_bits)
            sums_w, sums_x = [], []
            for l in range(L):
                noisy = self.with_layer_quantized(l, probe_bits, prm)
                d_w = classifier_forward(noisy, self.cfg, a) - logits
                sums_w.append(torch.sum(torch.square(d_w.float())))
                d_x = self._probe_logits(prm, h0, l, probe_bits) - clean
                sums_x.append(torch.sum(torch.square(d_x.float())))
            return torch.stack(sums_w + sums_x), logits

        sums, logits = self._run(("probe_all", int(probe_bits)), probe_all,
                                 x, None, range(L))
        e = sums.cpu().numpy().astype(np.float64)
        return e[:L], e[L:], logits

    # -- device-segment execution ---------------------------------------
    def run_prefix(self, x, p: int, params=None):
        """Activation leaving layer p when layers 1..p run with ``params``
        (default: the backend's own; a device segment's quantized list or
        a baseline's pruned list both index the same way)."""
        def fn(a, lp):
            h = flat_input(a, self.cfg)
            for l in range(p):
                h = apply_layer(self.cfg.layers[l], lp[l], h,
                                last=l == self.num_layers - 1)
            return h
        return self._run(("prefix", p), fn, x, params, range(p))

    def split(self, plan) -> DeviceSegment:
        seg, _server = split_classifier(self.params, plan, self.layer_specs())
        return seg

    def run_device_segment(self, seg: DeviceSegment, plan, x):
        h = self.run_prefix(x, plan.p, params=seg.params)
        return fake_quant(h, int(seg.bits_x))
