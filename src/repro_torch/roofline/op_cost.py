"""The FLOPs and bytes of a step, counted in PyTorch's own terms — the
port's counterpart of ``repro/roofline/hlo_cost.py``.

``hlo_cost.py`` walks the HLO text XLA compiles, which nothing in the
port produces, so it is not copied. Here :func:`count` runs a step once
on fake tensors (shapes and dtypes only: nothing is computed or
allocated) under two counters:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  matmul-class ops (mm, bmm, addmm, einsum's products, convolutions) at
  2 FLOPs per multiply-add. Elementwise ops count none, where HLO's
  count gives each one FLOP per output element.
* bytes: a ``TorchDispatchMode`` that sums each op's input and output
  bytes. Every op is its own pass over memory, as the port's eager ops
  are on the card, so these are UNFUSED bytes: an upper bound on the
  card's DRAM traffic (an L2 hit moves less). Views and empty
  allocations move nothing and count nothing, nor do queries of a
  tensor's metadata; ``copy_`` reads only its source, and a broadcast
  (stride-0) dimension counts once.

The kernel entry points of ``kernels/ops.py`` are costed as one op
each. While :func:`count` runs, stand-ins replace ``flash_attention``
(its backward through an ``autograd.Function``), ``decode_attention``,
``qdense`` and the quantize entry points. Each records its kernel's own
FLOPs and its input and output bytes — the formulas of the kernels'
bound column in ``chip_smoke.py`` — and returns an empty output of the
right shape and dtype. The models reach them as ``ops.<name>``, so the
hot path carries no check (a ``torch.library`` custom op would instead
add dispatcher time to every launch of the real, host-bound loop). A stand-in raises on a tensor that is not
fake: it never computes on a real path. (Tracing the plain versions
instead is too slow: their blocked attention loops over block pairs in
Python.) Swapping module attributes makes :func:`count` neither
reentrant nor thread-safe.

A decode position on the device (a 0-d integer tensor, as the serving
launcher's compile-once step and the dry run's ``build_step`` pass it)
is costed as the host int it stands for: the position's own bookkeeping
(its (B, 1) RoPE rows and each ring's slot write, ``models.attention``'s
``_decode_rows`` and ``_write_ring``) runs the host-int route on slot 0,
which moves the same bytes at every slot; the ``decode_attention``
stand-in reads the whole ring, as the kernel's grid is sized for it. A
fake position has no value to address a slot with, and counted as it
runs, an ``index_copy_`` would book the whole ring read and written.

A rank's program over a model axis (``launch.steps.build_step`` with a
mesh) calls ``launch.model_parallel``'s collectives, its backward's
included; while :func:`count` runs, its ``_collective`` is a stand-in
too. Each call records, under its kind (``all-reduce``, ``all-gather``,
``all-to-all``), the bytes it moves as ``repro/roofline/hlo_cost.py``
counts a collective — the larger of its operand's and its result's, once
per call, so a layer's collective counts once per layer — into
``CostSummary.collectives``, the same bytes under the axis it runs over
(``model``, or ``data`` for a train step's gradient mean) into
``collectives_by_axis``, and its operand and result bytes into ``bytes``
as any op's. A one-card program calls none: both stay empty.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Dict

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops
from repro_torch.launch import model_parallel
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

_aten = torch.ops.aten
# allocations whose contents are undefined, and a reshape that aliases
# its input: nothing is read or written
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.empty_strided.default, _aten._unsafe_view.default}


@dataclasses.dataclass
class CostSummary:
    """What :func:`count` counted: ``flops`` (matmul-class),
    ``bytes`` (unfused) and their split by op (a stand-in's bytes under
    its kernel's name), ``collectives`` (bytes moved by kind; empty for a
    one-card program) and the same bytes by axis
    (``collectives_by_axis``), and the stand-ins' calls by kernel."""
    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)


def _has_tensor(tree) -> bool:
    return any(isinstance(t, torch.Tensor) for t in _pytree_leaves(tree))


def _tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` views: a broadcast (stride-0) dimension reads its
    one row again, not new memory."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st) * \
        t.element_size()


def _nbytes(tree) -> int:
    return sum(_tensor_bytes(t) for t in _pytree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """Sums each op's input and output bytes; the stand-ins add their
    kernels' FLOPs and bytes through :meth:`kernel`."""

    def __init__(self):
        super().__init__()
        self.bytes = collections.Counter()        # by op
        self.collectives = collections.Counter()  # moved bytes, by kind
        self.by_axis = collections.Counter()      # the same, by axis
        self.kernel_flops = 0
        self.calls = collections.Counter()
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # a query (a tensor's device, size) returns no tensor and moves
        # nothing
        if not self.paused and not func.is_view and \
                func not in _NO_TRAFFIC and _has_tensor(out):
            moved = args[1:] if func is _aten.copy_.default else (args,
                                                                   kwargs)
            self.bytes[func.__name__] += _nbytes(moved) + _nbytes(out)
        return out

    @contextlib.contextmanager
    def pause(self):
        """Count no bytes for the ops run inside."""
        self.paused = True
        try:
            yield
        finally:
            self.paused = False

    def kernel(self, name: str, flops: float, inputs, make_out):
        """One launch of kernel ``name``: make its output with the byte
        count paused, record ``flops`` and the inputs' and output's
        bytes."""
        with self.pause():
            out = make_out()
        self.kernel_flops += flops
        self.bytes[name] += _nbytes(inputs) + _nbytes(out)
        self.calls[name] += 1
        return out

    def collective(self, kind: str, x, make_out, axis: str):
        """One collective of ``kind`` on ``x`` over ``axis``: its result
        made with the byte count paused, the moved bytes (the larger of
        operand and result) recorded under ``kind`` and under ``axis``,
        operand and result bytes under ``bytes``."""
        with self.pause():
            out = make_out()
        moved, io = max(_nbytes(x), _nbytes(out)), _nbytes(x) + _nbytes(out)
        self.collectives[kind] += moved
        self.by_axis[axis] += moved
        self.bytes[kind] += io
        return out


def _require_fake(name: str, *args) -> None:
    for t in _pytree_leaves(args):
        if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
            raise TypeError(f"the {name} stand-in got a real tensor on "
                            f"{t.device}: it only costs fake ones")


def _attention_pairs(s: int, block_q: int, block_k: int) -> int:
    """(query, key) positions of the blocks a causal blocked attention
    visits: each query block walks the key blocks up to its last row."""
    nq, nk = -(-s // block_q), -(-s // block_k)
    blocks = sum(min(((i + 1) * block_q - 1) // block_k + 1, nk)
                 for i in range(nq))
    return blocks * block_q * block_k


class _FlashStandIn(torch.autograd.Function):
    """``ops.flash_attention``'s stand-in. Forward: the score and PV
    products over the visited blocks, 4 * B * H * pairs * hd FLOPs, q, k,
    v read and out written. Backward: the gradient's four products (dV,
    dP, dQ, dK), twice the forward's FLOPs — what autodiff of the blocked
    attention counts (the card's backward kernel also recomputes the
    scores, which this leaves out) — q, k, v, out, lse, dout read and
    dq, dk, dv written."""

    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k, counter):
        b, s, kvh, g, hd = q.shape
        flops = 4 * b * kvh * g * hd * _attention_pairs(s, block_q, block_k)
        ctx.counter, ctx.flops = counter, flops
        ctx.save_for_backward(q, k, v)
        return counter.kernel("flash_attention", flops, (q, k, v),
                              lambda: torch.empty_like(q))

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        b, s, kvh, g, _ = q.shape
        counter = ctx.counter
        # the forward's out and row log-sum-exp, as the kernel reads them
        with counter.pause():
            out = torch.empty_like(q)
            lse = torch.empty((b, s, kvh, g), dtype=torch.float32)
        grads = counter.kernel(
            "flash_attention_bwd", 2 * ctx.flops, (q, k, v, out, lse, d_out),
            lambda: tuple(torch.empty_like(t) for t in (q, k, v)))
        return (*grads, None, None, None)


def _stand_ins(counter: _Counter) -> dict:
    """The entry points of ``kernels.ops`` and their stand-ins."""

    def flash_attention(q, k, v, block_q, block_k):
        _require_fake("flash_attention", q, k, v)
        return _FlashStandIn.apply(q, k, v, block_q, block_k, counter)

    def decode_attention(q, ck, cv, pos, kv0=None):
        _require_fake("decode_attention", q, ck, cv, pos)
        b, kvp, gp, hd = q.shape
        # a position on the device is never read: the kernel's grid is
        # sized for the whole ring; given kv0, it reads KVp of the heads
        n_valid = ck.shape[1] if torch.is_tensor(pos) else \
            min(int(pos) + 1, ck.shape[1])
        heads = slice(kv0 or 0, (kv0 or 0) + kvp)
        live = (ck[:, :n_valid, heads], cv[:, :n_valid, heads])
        return counter.kernel("decode_attention",
                              4 * b * kvp * gp * n_valid * hd, (q, *live),
                              lambda: torch.empty_like(q))

    def decode_attention_shard(q, ck, cv, pos, slot0, ring):
        _require_fake("decode_attention_shard", q, ck, cv, pos)
        b, kvp, gp, hd = q.shape
        n = ck.shape[1]
        # the shard's live slots; a device position: the whole shard
        n_valid = n if torch.is_tensor(pos) else \
            min(max((ring if int(pos) + 1 >= ring else int(pos) % ring + 1)
                    - slot0, 0), n)
        live = (ck[:, :n_valid], cv[:, :n_valid])
        return counter.kernel(
            "decode_attention_shard", 4 * b * kvp * gp * n_valid * hd,
            (q, *live),
            lambda: (torch.empty(q.shape, dtype=torch.float32),
                     torch.empty((b, kvp, gp), dtype=torch.float32)))

    def qdense(x, w, n_contract=1, out_dtype=None):
        _require_fake("qdense", x, w)
        x2, codes2, scale, mu, out_shape = ops.qdense_operands(x, w,
                                                               n_contract)
        packed = "codes_packed" in w
        (m, k), n = x2.shape, codes2.shape[1] * (2 if packed else 1)
        out = counter.kernel(
            "qmatmul4" if packed else "qmatmul", 2 * m * k * n,
            (x2, codes2, scale, mu),
            lambda: torch.empty((m, n), dtype=out_dtype or x.dtype))
        return out.reshape(out_shape)

    def quantize_tensor(x, scale, mu, bits=8, in_x_dtype=False):
        _require_fake("quantize", x, scale, mu)
        scale, mu = ops._quant_meta(x, scale, mu)
        return counter.kernel("quantize", 0, (x, scale, mu),
                              lambda: torch.empty(x.shape,
                                                  dtype=torch.uint8))

    def quantize_pack4(x, scale, mu):
        _require_fake("quantize_pack4", x, scale, mu)
        scale, mu = ops._quant_meta(x, scale, mu)
        if x.shape[1] % 2:
            raise ValueError(f"quantize_pack4: int4 packing pairs adjacent "
                             f"columns, N = {x.shape[1]} is odd")
        return counter.kernel(
            "quantize_pack4", 0, (x, scale, mu),
            lambda: torch.empty((x.shape[0], x.shape[1] // 2),
                                dtype=torch.uint8))

    def dequantize_tensor(codes, scale, mu, out_dtype=torch.bfloat16):
        _require_fake("dequantize", codes, scale, mu)
        scale, mu = ops._quant_meta(codes, scale, mu)
        return counter.kernel("dequantize", 0, (codes, scale, mu),
                              lambda: torch.empty(codes.shape,
                                                  dtype=out_dtype))

    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "decode_attention_shard": decode_attention_shard,
            "qdense": qdense,
            "quantize_tensor": quantize_tensor,
            "quantize_pack4": quantize_pack4,
            "dequantize_tensor": dequantize_tensor}


def _host_positions() -> dict:
    """``models.attention``'s position bookkeeping, a device position run
    as the host int 0 (the module docstring says why)."""
    rows, write = attention._decode_rows, attention._write_ring
    shard = attention._write_ring_shard

    def host(pos):
        return 0 if torch.is_tensor(pos) else pos

    return {"_decode_rows": lambda pos, b, device: rows(host(pos), b,
                                                        device),
            "_write_ring": lambda cache, k, v, pos: write(cache, k, v,
                                                          host(pos)),
            "_write_ring_shard": lambda cache, k, v, pos, first, ring: shard(
                cache, k, v, host(pos), first, ring)}


def _collective_stand_in(counter: _Counter) -> dict:
    """``model_parallel._collective``'s stand-in: an empty result of the
    collective's shape, its bytes recorded (``_Counter.collective``)."""

    def collective(kind, x, axis, dim=0):
        _require_fake(kind, x)
        shape = list(x.shape)
        if kind == "all-gather":
            shape[dim] *= axis.size
        elif kind == "reduce-scatter":
            shape[dim] //= axis.size
        return counter.collective(kind, x, lambda: torch.empty(
            shape, dtype=x.dtype), axis.name)

    return {"_collective": collective}


@contextlib.contextmanager
def _swapped(module, replacements: dict):
    saved = {name: getattr(module, name) for name in replacements}
    for name, fn in replacements.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def count(fn, *args, **kwargs) -> CostSummary:
    """Run ``fn(*args, **kwargs)`` once on the fake tensors of ``args``
    (all of one ``FakeTensorMode``) and return its :class:`CostSummary`;
    the kernel entry points are the stand-ins meanwhile."""
    mode = detect_fake_mode(_pytree_leaves((args, kwargs)))
    if mode is None:
        raise TypeError("count runs a step on fake tensors; its arguments "
                        "hold none")
    counter = _Counter()
    flop_counter = FlopCounterMode(display=False)
    with _swapped(ops, _stand_ins(counter)), \
            _swapped(attention, _host_positions()), \
            _swapped(model_parallel, _collective_stand_in(counter)), mode, \
            flop_counter, counter:
        fn(*args, **kwargs)
    return CostSummary(
        flops=float(flop_counter.get_total_flops() + counter.kernel_flops),
        bytes=float(counter.bytes.total()),
        collectives={k: float(v) for k, v in counter.collectives.items()},
        collectives_by_axis={k: float(v) for k, v in counter.by_axis.items()},
        kernel_calls=dict(counter.calls),
        bytes_by_op={k: float(v) for k, v in counter.bytes.items()})


def layer_costs(params, cfg, batch: int, seq: int, layer_w_bytes=None,
                spread_residual: bool = True) -> list:
    """Per-layer cost overrides for ``ModelBackend
    .set_layer_cost_overrides`` (the role of the reference's
    ``layer_costs_from_hlo``): the forward of each block
    (``segment_forward(h, l, l + 1)``) counted on fake ``params`` at
    ``batch`` x ``seq``, each entry ``{"o": MACs, "act_bytes": bytes}``
    at that batch (the backend rescales per request batch). FLOPs halve
    into MACs; the residual — the embedding and the unembedding — is
    spread evenly over the layers unless ``spread_residual`` is False.

    A block's bytes include its weight reads, which do not scale with
    the batch and are priced apart (``LayerSpec.w_bytes16``): pass
    ``layer_w_bytes`` (per-layer weight bytes) to subtract them, leaving
    ``act_bytes`` the batch-scaled activation traffic."""
    mode = detect_fake_mode(tree_leaves(params))
    if mode is None:
        raise TypeError("layer_costs counts fake params (param_shapes)")
    with mode:
        tokens = torch.zeros((batch, seq), dtype=torch.int32)
        h = torch.empty((batch, seq, cfg.d_model), dtype=T.model_dtype(cfg))
    L = cfg.num_layers
    per_layer = [count(lambda p, x, l=l: T.segment_forward(p, cfg, x, l,
                                                           l + 1), params, h)
                 for l in range(L)]
    residual = count(lambda p, t: T.unembed(p, cfg, T.embed_tokens(p, cfg, t)),
                     params, tokens)
    rf = residual.flops / L if spread_residual else 0.0
    rb = residual.bytes / L if spread_residual else 0.0
    if layer_w_bytes is None:
        layer_w_bytes = [0.0] * L
    return [{"o": (c.flops + rf) / 2.0,
             "act_bytes": max(c.bytes + rb - float(wb), 0.0)}
            for c, wb in zip(per_layer, layer_w_bytes, strict=True)]
