"""``TransformerBackend`` — decoder LMs behind the ``ModelBackend``
protocol, so a transformer goes through the same calibrate →
``build_store`` → serve pipeline as the paper's classifiers.

Mapping onto the protocol:

  * partitionable layers = the decoder blocks (the embedding table always
    stays on-device and carries no payload term; the embed row of
    ``transformer_layer_specs`` is dropped).
  * "logits" = next-token logits at the LAST sequence position, shape
    (B, V), with y = the next token.
  * the forward family runs exactly the layers a call needs
    (``graphs.run_blocks``, bitwise ``transformer.segment_forward``),
    each block through the backend's graph of its shape when
    ``forward_graphs`` is on (by default on CUDA); the backend's device
    is its parameters' device, and inputs (NumPy arrays or tensors) move
    to it.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import noise as noise_lib
from repro_torch.core.cost_model import (LayerSpec, kv_bytes_row as _kv_row,
                                         transformer_layer_specs)
from repro_torch.core.partition import DeviceSegment, split_blocks
from repro_torch.core.quantizer import fake_quant
from repro_torch.models import transformer as T
from repro_torch.serving.backends.base import ModelBackend, to_device
from repro_torch.serving.backends.graphs import refuse_off_card, run_blocks
from repro_torch.serving.decode.cache import paged_kv_ctx
from repro_torch.tree import tree_map

PROBE_CHUNK = 4      # the reference's layers per probe step (see below)
_STACKED_CACHE_SLOTS = 4     # stacked quantized trees kept per backend


@dataclasses.dataclass
class TransformerBackend(ModelBackend):
    """cfg: ModelConfig; params: a ``transformer.init_params`` /
    ``params_from_numpy`` tree (its device is the backend's). ``seq_len``
    is the reference sequence length requests are planned at; ``mode``
    follows ``transformer_layer_specs`` ("prefill" | "decode").
    ``forward_graphs`` runs the forward family through the backend's
    block graphs (``serving.backends.graphs``): None = on for CUDA
    parameters, False = eagerly (the twin the graphs are held to)."""
    cfg: ModelConfig
    params: dict
    seq_len: int
    mode: str = "prefill"
    # context length decode streams are planned against (the KV cache is
    # allocated at this length); None = no cache-feasibility term
    decode_max_len: Optional[int] = None
    # KV page size in ring slots: set -> admission prices streams at their
    # page-rounded actual context instead of decode_max_len
    kv_page_tokens: Optional[int] = None
    forward_graphs: Optional[bool] = None

    supports_decode = True

    def __post_init__(self):
        refuse_off_card(self)

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    @property
    def device(self) -> torch.device:
        """The parameters' device (the CPU for a pricing-only backend
        with ``params=None``)."""
        if self.params is None:
            return torch.device("cpu")
        return self.params["embed"].device

    def layer_specs(self, batch: int = 1,
                    seq_len: Optional[int] = None) -> List[LayerSpec]:
        specs = transformer_layer_specs(
            self.cfg, seq_len or self.seq_len, batch=batch,
            mode=self.mode)[1:]                      # drop the embed row
        return self.refine_specs(specs, batch=batch)

    def decode_layer_specs(self, batch: int = 1,
                           context_len: Optional[int] = None) -> List[LayerSpec]:
        """ONE decode step's per-layer terms at a ``context_len`` (default
        ``decode_max_len`` or ``seq_len``) context; cost overrides are
        measured on prefill and deliberately not applied."""
        ctx = context_len or self.decode_max_len or self.seq_len
        return transformer_layer_specs(self.cfg, ctx, batch=batch,
                                       mode="decode")[1:]

    def kv_bytes_row(self, batch: int = 1, tokens: Optional[int] = None):
        """Cumulative device-KV bytes by cut point for ONE decode stream:
        the dense worst case (``decode_max_len`` slots per attention
        layer), or with ``kv_page_tokens`` and the stream's ``tokens``
        its page-rounded context."""
        if self.decode_max_len is None:
            return None
        if tokens is None or self.kv_page_tokens is None:
            ctx = self.decode_max_len
        else:
            ctx = paged_kv_ctx(int(tokens), self.kv_page_tokens,
                               self.decode_max_len)
        cache = self.__dict__.setdefault("_kv_row_cache", {})
        key = (batch, ctx)
        row = cache.get(key)
        if row is None:
            row = cache[key] = _kv_row(
                self.decode_layer_specs(batch, context_len=ctx))
        return row

    def input_elements(self) -> float:
        return float(self.seq_len)                   # token ids per example

    def _tokens(self, x):
        return to_device(x, self.device)

    def _p(self, params):
        return self.params if params is None else params

    # -- decode entry points -----------------------------------------------
    def embed(self, tokens, params=None):
        return T.embed_tokens(self._p(params), self.cfg, self._tokens(tokens))

    def decode_segment(self, x, caches, pos, start, stop, params=None):
        return T.segment_decode_step(self._p(params), self.cfg, x, caches,
                                     pos, start, stop)

    def prefill_segment(self, h, cache0, start, stop, params=None):
        """Blocks ``[start, stop)`` over a whole prompt, filling the
        ring caches ``cache0`` (the prefill of configs whose ring wraps:
        sliding windows)."""
        return T.segment_prefill(self._p(params), self.cfg, h, cache0,
                                 start, stop)

    def extend_segment(self, h, caches, pos0, start, stop, params=None):
        return T.segment_extend(self._p(params), self.cfg, h, caches, pos0,
                                start, stop)

    def verify_segment(self, h, caches, pos0, start, stop, params=None):
        """Speculative verify: the ``s`` drafted rows of ``h`` through
        blocks ``[start, stop)`` + per-row unembed -> ``(logits (B, S,
        V), caches)``, bitwise ``s`` sequential ``decode_segment`` +
        ``hidden_logits`` calls."""
        return T.segment_verify(self._p(params), self.cfg, h, caches, pos0,
                                start, stop)

    def hidden_logits(self, h, params=None):
        """Unembed hidden state ``h`` (B, S, D) -> (B, V) at the last
        position."""
        return T.unembed(self._p(params), self.cfg, h[:, -1:, :])[:, -1, :]

    # -- forward family ---------------------------------------------------
    # The reference's tokens_logits / h_logits / acts / cut programs: the
    # embed, the last position's unembed and the cut's quantization run
    # eagerly, the blocks through run_blocks (one graph per block shape).
    def forward(self, x, params=None):
        params = self._p(params)
        h = T.embed_tokens(params, self.cfg, self._tokens(x))
        return self.hidden_logits(
            run_blocks(self, params, h, 0, self.num_layers), params)

    def forward_from_layer(self, a, start: int, params=None):
        params = self._p(params)
        return self.hidden_logits(
            run_blocks(self, params, a, start, self.num_layers), params)

    def layer_activations(self, x, params=None):
        params = self._p(params)
        h = T.embed_tokens(params, self.cfg, self._tokens(x))
        h, acts = run_blocks(self, params, h, 0, self.num_layers,
                             collect=True)
        return list(acts), self.hidden_logits(h, params)

    def with_layer_quantized(self, layer: int, bits: int):
        per, pos = divmod(layer, T.period_len(self.cfg))

        def quantize_slice(t):
            t = t.clone()
            t[per] = fake_quant(t[per], bits)
            return t

        blocks = list(self.params["blocks"])
        blocks[pos] = tree_map(quantize_slice, blocks[pos])
        return {**self.params, "blocks": blocks}

    def calibrate_probes(self, x, probe_bits: int = noise_lib.PROBE_BITS,
                         chunk: int = PROBE_CHUNK):
        """All L per-layer noise energies from one clean pass plus suffix
        passes. The weight probe of layer l resumes from the clean
        activation entering l with only block l fake-quantized (per
        period slice, as ``with_layer_quantized``) — the same function
        as a full forward of the perturbed model, whose layers below l
        are untouched. The clean suffix from that activation is the clean
        logits themselves.

        ``chunk`` is the reference's layers per ``lax.map`` step, a
        memory/parallelism knob that does not change the result. Here it
        is accepted and changes nothing: the probes run one layer at a
        time, each bit for bit the port's scalar loop of perturbed
        forwards (``noise.backend_layer_energies``), which batching probes
        of different layers into one forward would not keep.

        The probed block and both suffixes run through the forward
        family's block graphs (the perturbed leaves copied in), and the
        energies stay on the device until one transfer at the end, as
        the reference's ``np.asarray``: f32 sums widened to float64."""
        cfg, L = self.cfg, self.num_layers
        acts, logits = self.layer_activations(x)
        sums_w, sums_x = [], []
        for l in range(L):
            bp, _ = T.block_at(self.params, cfg, l)
            qbp = tree_map(lambda t: fake_quant(t, probe_bits), bp)
            h = run_blocks(self, self.params, acts[l], l, L,
                           replace={l: qbp})
            d_w = self.hidden_logits(h) - logits
            sums_w.append(torch.sum(torch.square(d_w.float())))
            d_x = self.forward_from_layer(fake_quant(acts[l], probe_bits),
                                          l) - logits
            sums_x.append(torch.sum(torch.square(d_x.float())))
        e = torch.stack(sums_w + sums_x).cpu().numpy().astype(np.float64)
        return e[:L], e[L:], logits

    # -- device-segment execution ---------------------------------------
    def _device_blocks(self, p: int):
        return [T.block_at(self.params, self.cfg, l)[0] for l in range(p)]

    def split(self, plan) -> DeviceSegment:
        return split_blocks(self._device_blocks(plan.p), plan,
                            self.layer_specs())

    def stacked_for(self, seg: DeviceSegment, plan) -> dict:
        """The parameter tree that runs the quantized segment: the full-
        precision stack with the segment's fake-quantized layer trees in
        front (``segment_blocks``, read by ``transformer.block_at``), so
        no stacked leaf is copied — at OLMoE's width a copy of the expert
        stacks would take 26 GB. One tree per segment while the segment
        lives, so every session on it reads the same tree (and replays
        the stage graphs that read it). ``plan`` is accepted for the
        reference's signature."""
        cache = self.__dict__.setdefault("_stacked_cache", {})
        tree = cache.get(id(seg))
        if tree is None:
            tree = cache[id(seg)] = {**self.params,
                                     "segment_blocks": list(seg.params)}
            weakref.finalize(seg, cache.pop, id(seg), None)
        return tree

    def run_device_segment(self, seg: DeviceSegment, plan, x):
        params = self.stacked_for(seg, plan)
        h = T.embed_tokens(params, self.cfg, self._tokens(x))
        h = run_blocks(self, params, h, 0, plan.p)
        return fake_quant(h, int(seg.bits_x))

    # -- quantized-kernel device segment ---------------------------------
    def qstacked_for(self, seg: DeviceSegment, plan) -> dict:
        """``stacked_for``'s kernel twin: in each device layer the routed
        projection/MLP weights (``transformer.KERNEL_ROUTED``) are
        quantized WIRE STRUCTS ({codes, scale, mu}, per tensor, at the
        layer's deployed bits) that the models run through the
        dequantize-fused qmatmul/qmatmul4 kernels; every other leaf is
        the segment's fake-quantized one. Plans deploying > 8 bits fall
        back to ``stacked_for`` (the uint8 wire cannot carry them).
        Built on first execution and cached per DEPLOYED plan
        (bounded; an evicted tree's stage graphs are dropped with it)."""
        bits_w = [int(b) for b in np.asarray(seg.bits_w)]
        if any(b > 8 for b in bits_w):
            return self.stacked_for(seg, plan)
        key = (plan.p, tuple(bits_w), int(seg.bits_x))
        cache = self.__dict__.setdefault("_qstacked_cache", {})
        if key not in cache:
            while len(cache) >= _STACKED_CACHE_SLOTS:
                self.drop_stage_graphs(cache.pop(next(iter(cache))))
            cache[key] = self._build_qstacked(seg, bits_w)
        return cache[key]

    def clear_qstacked(self) -> None:
        """Free every cached ``qstacked_for`` tree and the stage graphs
        that read it."""
        for tree in self.__dict__.pop("_qstacked_cache", {}).values():
            self.drop_stage_graphs(tree)

    def _build_qstacked(self, seg: DeviceSegment, bits_w: list) -> dict:
        """Routed leaves of each device layer quantized from the master
        weights at that layer's bits; a period position whose device
        layers are all <= 4 bits packs two codes per byte (so every layer
        at a position runs one kernel). Other leaves come from
        ``seg.params`` (``split_blocks``' fake-quantization, leaf for
        leaf what ``stacked_for`` runs)."""
        cfg, routed = self.cfg, T.KERNEL_ROUTED
        plen = T.period_len(cfg)
        pack = [max(bits_w[pos::plen], default=8) <= 4
                for pos in range(plen)]

        def struct(leaf, bits: int, packed: bool):
            mu, phi = torch.amin(leaf), torch.amax(leaf)
            lv = torch.full((), 2.0 ** bits - 1.0, dtype=torch.float32,
                            device=leaf.device)
            scale = torch.clamp((phi - mu) / lv, min=1e-12)
            codes = torch.minimum(torch.clamp(
                torch.round((leaf - mu) / scale), min=0), lv)
            one = (1,) * leaf.dim()
            out = {"scale": scale.float().reshape(one),
                   "mu": mu.float().reshape(one)}
            codes = codes.to(torch.uint8)
            if packed and leaf.shape[-1] % 2 == 0:
                out["codes_packed"] = \
                    codes[..., 0::2] | (codes[..., 1::2] << 4)
            else:
                out["codes"] = codes
            return out

        def layer(l: int):
            master, pos = T.block_at(self.params, cfg, l)

            def walk(node, fq, parent=None):
                if not isinstance(node, dict):
                    return fq
                return {k: (struct(v, bits_w[l], pack[pos])
                            if parent in routed and k in routed[parent]
                            and not isinstance(v, dict)
                            else walk(v, fq[k], k))
                        for k, v in node.items()}

            return walk(master, seg.params[l])

        return {**self.params,
                "segment_blocks": [layer(l) for l in range(len(bits_w))]}
