"""The paper's own evaluation models: MLP / CNN classifiers (§V, Fig. 4).

These are the models QPART's simulation platform quantizes and
partitions; ``layer_activations`` exposes every layer's input so the
noise calibration (Alg. 1 steps 7–9) can probe intermediate layers.

Layout. Activations are NHWC at every layer boundary, as in the
reference, so the first Dense of a CNN flattens its features in the
reference's (H, W, C) order and the cut activation a device ships has
the reference's shape. ``conv2d`` is NCHW/OIHW: each conv permutes its
input to NCHW and its output back. Conv weights are stored OIHW
(``params_from_numpy`` carries the reference's HWIO across);
per-tensor quantization and magnitude pruning do not see the order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.classifier import ClassifierConfig, DenseSpec
from repro_torch.models.common import dense_init


def init_classifier(cfg: ClassifierConfig, generator: torch.Generator,
                    device="cuda"):
    """Seeded random weights: per layer {"w", "b"}, Dense w (in, out),
    conv w OIHW; truncated-normal fan-in init, zero biases.
    ``generator`` must live on ``device``."""
    params = []
    for spec in cfg.layers:
        if isinstance(spec, DenseSpec):
            w = dense_init((spec.in_dim, spec.out_dim), generator,
                           device=device)
            n_out = spec.out_dim
        else:
            w = dense_init((spec.c_out, spec.c_in, spec.f1, spec.f2),
                           generator, in_axis=1, device=device)
            n_out = spec.c_out
        params.append({"w": w, "b": torch.zeros(n_out, device=device)})
    return params


def params_from_numpy(params, cfg: ClassifierConfig, device="cuda"):
    """Carry a reference ``init_classifier`` list across as tensors on
    ``device``: Dense weights as they are, conv weights HWIO -> OIHW."""
    out = []
    for spec, p in zip(cfg.layers, params):
        w = torch.from_numpy(np.array(p["w"], np.float32))
        if not isinstance(spec, DenseSpec):
            w = w.permute(3, 2, 0, 1).contiguous()
        out.append({"w": w.to(device),
                    "b": torch.from_numpy(np.array(p["b"],
                                                   np.float32)).to(device)})
    return out


def _same_pad(size: int, f: int, stride: int):
    """(low, high) padding of XLA's "SAME" along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + f - size, 0)
    return total // 2, total - total // 2


def _apply_layer(spec, p, x, last: bool):
    if isinstance(spec, DenseSpec):
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        x = x @ p["w"] + p["b"]
    else:
        h = x.permute(0, 3, 1, 2)                      # NHWC -> NCHW
        ph = _same_pad(h.shape[2], spec.f1, spec.stride)
        pw = _same_pad(h.shape[3], spec.f2, spec.stride)
        h = F.conv2d(F.pad(h, pw + ph), p["w"], stride=spec.stride)
        h = h + p["b"][:, None, None]
        if spec.pool > 1:
            h = F.max_pool2d(h, spec.pool)             # "VALID" windows
        x = h.permute(0, 2, 3, 1)                      # NCHW -> NHWC
    if not last:
        x = torch.relu(x)
    return x


def _ensure_batched(x, cfg: ClassifierConfig):
    """Accept (B, *input_shape), (B, flattened) or a single unbatched image."""
    if x.dim() == len(cfg.input_shape) and \
            x.numel() == int(np.prod(cfg.input_shape)):
        x = x[None]
    return x


def _flat_input(x, cfg: ClassifierConfig):
    x = _ensure_batched(x, cfg)
    if isinstance(cfg.layers[0], DenseSpec):
        x = x.reshape(x.shape[0], -1)
    return x


def classifier_forward(params, cfg: ClassifierConfig, x):
    """x (B, *input_shape) or (B, flat) -> logits (B, num_classes)."""
    x = _flat_input(x, cfg)
    for i, (spec, p) in enumerate(zip(cfg.layers, params)):
        x = _apply_layer(spec, p, x, last=i == cfg.num_layers - 1)
    return x


def layer_activations(params, cfg: ClassifierConfig, x):
    """The activations entering each layer (x_1..x_L) plus the logits —
    what the QPART noise calibration probes."""
    x = _flat_input(x, cfg)
    acts = []
    for i, (spec, p) in enumerate(zip(cfg.layers, params)):
        acts.append(x)
        x = _apply_layer(spec, p, x, last=i == cfg.num_layers - 1)
    return acts, x


def forward_from_layer(params, cfg: ClassifierConfig, x, start: int):
    """Run layers start..L-1 on an intermediate activation (server-side
    segment inference after the partition point)."""
    for i in range(start, cfg.num_layers):
        x = _apply_layer(cfg.layers[i], params[i], x,
                         last=i == cfg.num_layers - 1)
    return x


# single-layer entry points for the serving backend: partitioned execution
# applies layers one at a time with swapped (quantized / pruned) params
apply_layer = _apply_layer
ensure_batched = _ensure_batched
flat_input = _flat_input
