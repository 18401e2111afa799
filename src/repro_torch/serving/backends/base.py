"""The ``ModelBackend`` protocol: everything architecture-specific the
QPART serving pipeline needs, behind one interface.

The serving stack (``QPARTServer``, ``pricing``) is model-agnostic: it
speaks plans, costs and accuracy. A backend owns the model family — its
config, parameters, layer-spec builder, forward functions and the
quantized device-segment execution.

Conventions shared by all backends:

  * "layers" are the partitionable units. ``layer_specs()[l]`` describes
    layer ``l+1`` in the paper's 1-indexed notation; a plan with ``p``
    runs layers ``1..p`` on-device.
  * ``forward``-family methods return the logits the calibration probes:
    shape (batch, num_classes) — for decoder LMs the next-token logits
    at the last position.
  * every forward method accepts a ``params`` override (default: the
    backend's own) so the calibration can probe perturbed weights.

The reference's compile-once cache (``jitted`` / ``trace_count``) has
its counterpart in ``stage_graphs`` / ``capture_count``: CUDA graphs
that live on the backend, keyed by what each bakes in, and that every
later caller of the backend replays. Two families share them:

  * the decode sessions' stage graphs (``serving.decode.graphs``:
    ring prefills, prefill chunks, plain steps, speculative rounds). A
    stage graph bakes in tensor addresses and segment bounds, so a new
    cut or a new cache slot captures once more;
  * the forward family's graphs (``serving.backends.graphs``:
    ``forward``, ``forward_from_layer``, ``layer_activations``, the
    calibration probes and the quantized device segment): a
    transformer's one per block shape, a classifier's one per program
    and shape, with the weights copied in at each replay, so a capture
    serves every layer, cut, plan and probe. ``forward_graphs``
    switches them (default: on when the parameters live on CUDA).

The backend keeps only the keys used last, of both families together.
"""
from __future__ import annotations

import abc
import collections
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import noise as noise_lib
from repro_torch.core.cost_model import LayerSpec
from repro_torch.core.partition import DeviceSegment, segment_memory_bytes
from repro_torch.core.solver import PartitionPlan

_EVAL_MEMO_SLOTS = 4         # distinct test sets remembered per backend
_STAGE_GRAPH_KEYS = 16       # stage-graph keys a backend keeps (LRU)


def to_device(x, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor, NumPy array or nested list
    (the serving entry points accept all three)."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           dtype=dtype, device=device)


class StageGraphs:
    """The stage graphs of one key (a pair of stages, device then
    server): ``graphs``, stage name -> graph in capture order; ``uses``,
    stage name -> the eager runs of that stage under the key; ``reads``,
    the params trees the graphs read, held while they live."""

    def __init__(self, reads=()):
        self.reads = tuple(reads)
        self.graphs = {}
        self.uses = {}


def _free_graphs(entries) -> None:
    """Drop the graphs of ``entries``; where one was captured, hand the
    memory pools it leaves free back to the card (the caching allocator
    would keep them reserved)."""
    captured = any(entry.graphs for entry in entries)
    for entry in entries:
        entry.graphs.clear()
    if captured and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class ModelBackend(abc.ABC):
    """Architecture adapter for the QPART serving pipeline."""

    cfg: object          # the family's config dataclass
    params: object       # canonical full-precision parameters
    # the forward family through graphs (serving.backends.graphs): None =
    # on when the parameters live on CUDA; False = eagerly
    forward_graphs = None

    # -- shared stage graphs -------------------------------------------
    # Kept in __dict__ so the dataclass backends need not declare them.
    def stage_graphs(self, key, reads=()) -> "StageGraphs":
        """The stage graphs cached under ``key`` — the counterpart of the
        reference's ``jitted`` —, new and empty on a miss; the caller
        captures into it and counts each capture (``count_capture``).
        ``reads`` are the params trees the graphs read by address, held
        with them. The backend keeps the ``_STAGE_GRAPH_KEYS`` keys used
        last: an older key's graphs go, and their memory pools back to
        the card, so the graphs' memory stays bounded however many
        prompt lengths, cuts and slots the traffic brings. A key holds
        the cache slots its graphs write, so neither a slot nor a tree
        is freed while a graph of it can replay."""
        cache = self.__dict__.setdefault("_stage_graphs",
                                         collections.OrderedDict())
        entry = cache.get(key)
        if entry is None:
            if len(cache) >= _STAGE_GRAPH_KEYS:
                _free_graphs([cache.popitem(last=False)[1]])
            entry = cache[key] = StageGraphs(reads)
        else:
            cache.move_to_end(key)
        return entry

    def drop_stage_graphs(self, obj) -> int:
        """Drop the cached stage graphs whose key holds ``obj`` (a cache
        slot) or that read it (a params tree); returns how many went."""
        cache = self.__dict__.get("_stage_graphs", {})
        gone = [cache.pop(key) for key in list(cache)
                if any(x is obj for x in (*key, *cache[key].reads))]
        dropped = sum(len(entry.graphs) for entry in gone)
        _free_graphs(gone)
        return dropped

    @property
    def capture_count(self) -> int:
        """Graphs captured for this backend — its decode sessions' stage
        graphs and its forward family's graphs —, the counterpart
        of the reference's ``trace_count``: at most one per stage of a
        key, whatever the number of sessions, tokens, layers, cuts or
        probes (once more if the key was evicted and comes back), 0 on
        the CPU."""
        return self.__dict__.get("_capture_count", 0)

    def count_capture(self) -> None:
        self.__dict__["_capture_count"] = self.capture_count + 1

    # -- structure ------------------------------------------------------
    @property
    @abc.abstractmethod
    def num_layers(self) -> int:
        """Number of partitionable layers L."""

    @abc.abstractmethod
    def layer_specs(self, batch: int = 1,
                    seq_len: Optional[int] = None) -> List[LayerSpec]:
        """(z_w, z_x, o, byte columns) per partitionable layer for a
        request shape, passed through ``refine_specs``."""

    def set_layer_cost_overrides(self, per_layer,
                                 batch: int = 1) -> None:
        """Install measured per-layer cost columns: a list of ``{"o":
        MACs, "act_bytes": B, "w_bytes16": B}`` dicts measured at
        ``batch``, re-scaled per request batch in ``refine_specs``.
        ``None`` entries / missing keys keep the analytic value; pass
        ``per_layer=None`` to clear."""
        if per_layer is None:
            self.__dict__.pop("_spec_overrides", None)
            return
        if len(per_layer) != self.num_layers:
            raise ValueError(
                f"need {self.num_layers} per-layer overrides, "
                f"got {len(per_layer)}")
        norm = []
        for ov in per_layer:
            ov = dict(ov or {})
            for k in ("o", "act_bytes"):        # batch-scaled columns
                if k in ov:
                    ov[k] = float(ov[k]) / batch
            norm.append(ov)
        self.__dict__["_spec_overrides"] = norm

    def refine_specs(self, specs: List[LayerSpec],
                     batch: int = 1) -> List[LayerSpec]:
        """Apply installed per-layer cost overrides to an analytic spec
        list (identity when none are installed)."""
        overrides = self.__dict__.get("_spec_overrides")
        if overrides is None:
            return specs
        out = []
        for sp, ov in zip(specs, overrides):
            kw = {}
            if "o" in ov:
                kw["o"] = ov["o"] * batch
            if "act_bytes" in ov:
                kw["act_bytes"] = ov["act_bytes"] * batch
            if "w_bytes16" in ov:
                kw["w_bytes16"] = float(ov["w_bytes16"])
            out.append(dataclasses.replace(sp, **kw) if kw else sp)
        return out

    @abc.abstractmethod
    def input_elements(self) -> float:
        """Elements of one raw input example — what a full offload (p=0)
        uploads at 32 bits."""

    # -- forward family (calibration + measurement) ---------------------
    @abc.abstractmethod
    def forward(self, x, params=None):
        """Full forward: input batch -> logits (B, C)."""

    @abc.abstractmethod
    def forward_from_layer(self, a, start: int, params=None):
        """Resume from the activation ENTERING layer ``start`` (0-based)."""

    @abc.abstractmethod
    def layer_activations(self, x, params=None):
        """(activations entering each layer [x_1..x_L], logits)."""

    @abc.abstractmethod
    def with_layer_quantized(self, layer: int, bits: int):
        """Params tree with layer ``layer``'s weights fake-quantized at
        ``bits`` — the Alg. 1 noise probe's perturbed model."""

    # -- autoregressive decode (optional capability) --------------------
    supports_decode: bool = False

    def decode_layer_specs(self, batch: int = 1,
                           context_len: Optional[int] = None) -> List[LayerSpec]:
        """Per-layer specs of ONE decode step against a ``context_len``
        context."""
        raise NotImplementedError(
            f"{type(self).__name__} has no autoregressive decode path")

    def kv_bytes_row(self, batch: int = 1):
        """(P+1,) cumulative device-resident decode-cache footprint per
        candidate cut, or ``None`` when no cache feasibility term
        applies."""
        return None

    # -- calibration probes (Alg. 1 steps 7-9) --------------------------
    def calibrate_probes(self, x, probe_bits: int = noise_lib.PROBE_BITS):
        """Per-layer output-noise energies (e_w (L,), e_x (L,), clean
        logits). Default: the scalar reference loop (``core.noise
        .backend_layer_energies``)."""
        return noise_lib.backend_layer_energies(self, x, probe_bits)

    # -- quantized device-segment execution -----------------------------
    @abc.abstractmethod
    def split(self, plan: PartitionPlan) -> DeviceSegment:
        """Materialize the quantized device segment (layers 1..p at the
        plan's per-layer bit-widths)."""

    @abc.abstractmethod
    def run_device_segment(self, seg: DeviceSegment, plan: PartitionPlan, x):
        """Run layers 1..p on the quantized segment and return the cut
        activation, quantized at the plan's ``bits_x`` for the uplink."""

    # -- shared logic (family-independent) ------------------------------
    def device_executor(self, plan: PartitionPlan) -> "DeviceExecutor":
        """Callable quantized device segment for ``plan``."""
        return DeviceExecutor(self, plan, self.split(plan))

    def execute_plan(self, plan: PartitionPlan, x,
                     executor: Optional["DeviceExecutor"] = None):
        """Run the partitioned, quantized model: quantized device
        segment, quantized cut activation, full-precision server tail."""
        if plan.p == 0:
            return self.forward(x)
        h = (executor or self.device_executor(plan))(x)
        return self.forward_from_layer(h, plan.p)

    def evaluate(self, x, y, params=None) -> float:
        """Top-1 accuracy of the (full-precision) forward on (x, y),
        memoized per test-set IDENTITY on the backend's own params."""
        if params is not None:
            return self._measure(x, y, params)
        memo = self.__dict__.setdefault("_eval_memo", [])
        for mx, my, val in memo:
            if mx is x and my is y:
                return val
        val = self._measure(x, y, self.params)
        memo.append((x, y, val))
        del memo[:-_EVAL_MEMO_SLOTS]
        return val

    def _measure(self, x, y, params) -> float:
        logits = self.forward(x, params=params)
        y = to_device(y, logits.device)
        return float(torch.mean((torch.argmax(logits, -1) == y).float()))


@dataclasses.dataclass
class DeviceExecutor:
    """A materialized quantized device segment, callable on inputs: maps
    a raw input batch to the quantized cut activation (the uplink
    payload)."""
    backend: ModelBackend
    plan: PartitionPlan
    segment: DeviceSegment

    def __call__(self, x):
        return self.backend.run_device_segment(self.segment, self.plan, x)

    @property
    def payload_bits(self) -> float:
        return self.segment.payload_bits

    @property
    def memory_bytes(self) -> float:
        return segment_memory_bytes(self.segment)
