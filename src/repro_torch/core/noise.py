"""Quantization-noise and accuracy-degradation model (paper Eq. 18–22,
following Zhou et al. AAAI'18 [33]).

Quantities per layer l of the model segment:

  s_l    — noise-energy scale at the OUTPUT (logits) caused by quantizing
           layer l: ``||sigma_l(b)||^2 = s_l * e^(-ln4 b)``, calibrated
           by quantizing layer l at a probe bit-width b0 and measuring
           the output perturbation: s_l = E0 * 4^b0.
  sigma* — adversarial noise: the minimal L2 perturbation of the logits
           that flips the prediction, (z_top1 - z_top2)/sqrt(2).
  rho_l  — robustness of layer l (Eq. 22): mean quantization noise energy
           over the calibration set / mean adversarial noise energy.
  psi_l  — accuracy-degradation measure (Eq. 20–21): ||sigma_l||^2 / rho_l,
           additive across layers.
  Delta(a) — constraint budget for accuracy degradation target a,
           calibrated by injecting output noise at increasing psi and
           measuring the empirical accuracy drop (Alg. 1 step 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quantizer import fake_quant
from repro_torch.tree import tree_map

PROBE_BITS = 8
LN4 = float(np.log(4.0))
DELTA_GRID = 60          # psi grid points of calibrate_delta


@dataclasses.dataclass
class LayerNoiseProfile:
    """Calibrated noise statistics for one partitionable layer."""
    s_w: float          # weight-quantization output-noise scale
    s_x: float          # activation-quantization output-noise scale
    rho: float          # robustness (Eq. 22)


@dataclasses.dataclass
class NoiseCalibration:
    layers: Sequence[LayerNoiseProfile]
    adv_noise_mean: float           # mean ||sigma*||^2 over the calib set
    delta_table: dict               # accuracy target a -> Delta budget

    def delta_for(self, a: float) -> float:
        """Largest tabulated budget whose degradation <= a (Alg. 2 step 1)."""
        keys = sorted(self.delta_table)
        best = self.delta_table[keys[0]]
        for k in keys:
            if k <= a:
                best = self.delta_table[k]
        return best


def adversarial_noise_energy(logits):
    """||sigma*||^2 per example: minimal L2 logit perturbation flipping
    argmax = margin/sqrt(2), energy = margin^2/2."""
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    return torch.square(margin) / 2.0


def output_noise_energy(apply_fn: Callable, params_clean, params_noisy, x):
    """||f(x; W') - f(x; W)||^2 summed over the batch."""
    d = (apply_fn(params_noisy, x) - apply_fn(params_clean, x)).float()
    return torch.sum(torch.square(d))


def calibrate_layer(apply_fn, params, x, layer_idx: int,
                    set_layer_weights, get_layer_weights,
                    activations, probe_bits: int = PROBE_BITS):
    """Measure (s_w, s_x) for one layer. ``set_layer_weights(params, idx,
    w)`` / ``get_layer_weights`` adapt the parameter tree;
    ``activations[idx]`` is the layer's input batch."""
    w = get_layer_weights(params, layer_idx)
    wq = tree_map(lambda t: fake_quant(t, probe_bits), w)
    noisy = set_layer_weights(params, layer_idx, wq)
    e_w = output_noise_energy(apply_fn, params, noisy, x)
    s_w = float(e_w) * 4.0 ** probe_bits
    act = activations[layer_idx]
    d = (apply_fn(params, fake_quant(act, probe_bits), start=layer_idx)
         - apply_fn(params, act, start=layer_idx)).float()
    s_x = float(torch.sum(torch.square(d))) * 4.0 ** probe_bits
    return s_w, s_x


def backend_layer_energies(backend, x, probe_bits: int = PROBE_BITS):
    """Reference SCALAR probe loop for Alg. 1 steps 7–9 over a serving
    ``ModelBackend``: per layer l, quantize the layer's weights / input
    activation at ``probe_bits`` and measure the squared logit
    perturbation — 1 full + 2 suffix forwards per layer. Returns (e_w
    (L,), e_x (L,), clean logits (B, C))."""
    acts, logits = backend.layer_activations(x)
    L = backend.num_layers
    e_w = np.zeros(L)
    e_x = np.zeros(L)
    for l in range(L):
        noisy = backend.with_layer_quantized(l, probe_bits)
        d_w = (backend.forward(x, params=noisy) - logits).float()
        e_w[l] = float(torch.sum(torch.square(d_w)))
        aq = fake_quant(acts[l], probe_bits)
        d = backend.forward_from_layer(aq, l) \
            - backend.forward_from_layer(acts[l], l)
        e_x[l] = float(torch.sum(torch.square(d.float())))
    return e_w, e_x, logits


def accuracy(apply_fn, params, x, y) -> float:
    logits = apply_fn(params, x)
    return float(torch.mean((torch.argmax(logits, -1) == y).float()))


def calibrate_delta(apply_fn, params, x, y, rhos, targets,
                    generator: Optional[torch.Generator] = None,
                    trials: int = 3, draws=None):
    """Map accuracy-degradation targets -> psi budgets Delta (Alg.1 step 8).

    Injects Gaussian noise of increasing energy on the logits, converts
    each energy to the psi it represents, and records the largest psi
    whose measured degradation stays within each target. The noise comes
    from ``generator`` (default: seeded 0 on the logits' device) or, when
    given, from ``draws`` — (DELTA_GRID * trials, *logits.shape) standard
    normal samples consumed in order, so a test can feed the reference's
    own draws."""
    base = accuracy(apply_fn, params, x, y)
    logits = apply_fn(params, x)
    mean_rho = float(np.mean(rhos)) if len(rhos) else 1.0
    if draws is None and generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)

    # Adaptive grid: degradation switches on when the per-example noise
    # energy approaches the adversarial energy, i.e. psi* ~ adv_mean / rho
    # (by Eq. 20–22). Sweep four decades below to one above.
    adv_mean = float(torch.mean(adversarial_noise_energy(logits)))
    psi_star = max(adv_mean / max(mean_rho, 1e-30), 1e-12)
    psis = psi_star * np.logspace(-4, 1, DELTA_GRID)
    degr = np.zeros_like(psis)
    for i, psi in enumerate(psis):
        # psi = ||sigma||^2 / rho -> per-example output-noise energy
        energy = psi * mean_rho
        accs = []
        for t in range(trials):
            if draws is not None:
                g = torch.as_tensor(draws[i * trials + t],
                                    device=logits.device)
            else:
                g = torch.randn(logits.shape, generator=generator,
                                device=logits.device)
            g = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                                min=1e-12)
            # sqrt in f32, as the reference takes it
            noisy = logits + g * torch.sqrt(torch.tensor(
                energy, dtype=torch.float32, device=logits.device))
            accs.append(float(torch.mean(
                (torch.argmax(noisy, -1) == y).float())))
        degr[i] = base - float(np.mean(accs))
    # enforce monotonicity (measurement noise) then invert
    degr = np.maximum.accumulate(degr)
    table = {}
    for a in targets:
        ok = psis[degr <= a + 1e-9]
        table[a] = float(ok[-1]) if len(ok) else float(psis[0])
    return table, base
