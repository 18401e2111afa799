"""Plan → deploy → execute: the objects the online pipeline hands out.

``QPARTServer`` keys its offline stores by a ``ReferenceContext`` (the
device/channel/weights Alg. 1 optimized for) and its online entry points
(``serve`` / ``serve_batch``) return a ``Deployment``: the chosen plan,
its priced costs, and a callable quantized device segment — with
measurement (really running the partitioned, quantized model on a test
set) an explicit separate step, ``Deployment.execute``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core.cost_model import (Channel, DeviceProfile,
                                         ObjectiveWeights)
from repro_torch.core.solver import PartitionPlan
from repro_torch.serving.backends.base import (DeviceExecutor, ModelBackend,
                                             to_device)
from repro_torch.serving.simulator import InferenceRequest, ServingResult


def _fence(t):
    """Wait for the device work behind ``t`` (a wall-clock stage fence)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return t


@dataclasses.dataclass(frozen=True)
class ReferenceContext:
    """The (device, channel, weights) a pattern store was built against
    (Alg. 1's reference request). Hashable, so one model holds stores
    for many contexts side by side."""
    device: DeviceProfile
    channel: Channel
    weights: ObjectiveWeights


@dataclasses.dataclass
class Deployment:
    """One served request: the plan Alg. 2 picked, its priced costs, and
    the means to really run it. The quantized segment materializes
    lazily on first ``device_segment()``/``execute``."""
    model: str
    backend: ModelBackend
    request: InferenceRequest
    plan: PartitionPlan
    result: ServingResult
    _segment: Optional[DeviceExecutor] = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- convenience views over the priced result -----------------------
    @property
    def costs(self):
        return self.result.costs

    @property
    def objective(self) -> float:
        return self.result.objective

    @property
    def payload_bits(self) -> float:
        return self.result.payload_bits

    @property
    def extra(self) -> dict:
        return self.result.extra

    @property
    def queue_delay(self) -> float:
        """Server queue delay priced into this deployment's objective —
        0.0 on the queue-less paths (``serve``/``serve_batch``)."""
        return self.result.extra.get("queue_delay", 0.0)

    @property
    def accuracy(self):
        return self.result.accuracy

    @property
    def accuracy_degradation(self):
        return self.result.accuracy_degradation

    # -- deploy ---------------------------------------------------------
    def device_segment(self) -> DeviceExecutor:
        """The callable quantized device segment (lazily materialized,
        cached)."""
        if self._segment is None:
            self._segment = self.backend.device_executor(self.plan)
        return self._segment

    # -- execute --------------------------------------------------------
    def execute(self, test_x, test_y) -> ServingResult:
        """Really run the partitioned, quantized model on (test_x,
        test_y): quantized device segment, quantized cut activation,
        full-precision server tail. Fills ``result.accuracy`` and
        ``result.accuracy_degradation`` (vs the full-precision model on
        the SAME test set). The two compute stages are wall-clock fenced
        and recorded into ``result.extra['measured']`` beside the
        predicted breakdown, and so feedable into
        ``QPARTServer.record_execution`` / the calibration ledger. First
        execution of a (p, shape) pays the segment's fake-quantization
        and the block graphs' eager first uses and capture; re-execute
        (the segment and the graphs persist) before trusting the
        timings."""
        t0 = time.perf_counter()
        if self.plan.p:
            h = _fence(self.device_segment()(test_x))
            t1 = time.perf_counter()
            logits = _fence(self.backend.forward_from_layer(h, self.plan.p))
        else:
            t1 = t0
            logits = _fence(self.backend.forward(test_x))
        t2 = time.perf_counter()
        self.result.extra["measured"] = {
            "batch": int(test_x.shape[0]),
            "t_device_s": t1 - t0,
            "t_server_s": t2 - t1,
            "t_total_s": t2 - t0,
            "t_device_pred_s": self.result.costs.t_local,
            "t_server_pred_s": self.result.costs.t_server,
        }
        y = to_device(test_y, logits.device)
        acc = float(torch.mean((torch.argmax(logits, -1) == y).float()))
        base = self.backend.evaluate(test_x, test_y)
        self.result.accuracy = acc
        self.result.accuracy_degradation = base - acc
        return self.result

    # -- generate (autoregressive decode) -------------------------------
    def decode_session(self, max_len: Optional[int] = None,
                       prefill_chunk_tokens: Optional[int] = None,
                       draft_tokens: int = 0,
                       graphs: Optional[bool] = None):
        """A fresh ``DecodeSession`` on this deployment's plan, reusing
        the lazily-materialized quantized device segment. The serving-
        shape knobs pass through: ``prefill_chunk_tokens`` admits the
        prompt in chunks, ``draft_tokens`` turns decode rounds
        speculative, ``graphs`` (default: on CUDA) replays the plain
        decode step as CUDA graphs."""
        from repro_torch.serving.decode import DecodeSession
        seg = self.device_segment().segment if self.plan.p else None
        if max_len is None:
            max_len = getattr(self.backend, "decode_max_len", None) \
                or 2 * getattr(self.backend, "seq_len", 1)
        return DecodeSession(self.backend, self.plan, max_len=max_len,
                             segment=seg,
                             prefill_chunk_tokens=prefill_chunk_tokens,
                             draft_tokens=draft_tokens, graphs=graphs)

    def generate(self, prompt, max_new_tokens: int, *,
                 max_len: Optional[int] = None, stream_cb=None,
                 prefill_chunk_tokens: Optional[int] = None,
                 draft_tokens: int = 0, graphs: Optional[bool] = None):
        """Stream ``max_new_tokens`` greedy tokens through the
        partitioned prefill→decode pipeline. Wall-clock stage seconds
        land in ``result.extra['measured_decode']`` (what
        ``QPARTServer.record_decode`` regresses). Returns a
        ``decode.GenerationResult``."""
        sess = self.decode_session(max_len=max_len,
                                   prefill_chunk_tokens=prefill_chunk_tokens,
                                   draft_tokens=draft_tokens,
                                   graphs=graphs)
        out = sess.generate(prompt, max_new_tokens, stream_cb=stream_cb)
        self.result.extra["measured_decode"] = {
            "batch": int(out.tokens.shape[0]),
            "new_tokens": out.new_tokens,
            "ttft_s": out.ttft_s,
            "t_device_s": out.t_device_s,
            "t_server_s": out.t_server_s,
            "t_total_s": out.t_total_s,
            "tokens_per_s": out.tokens_per_s,
            "device_cache_bytes": out.device_cache_bytes,
            "device_cache_dtype": out.device_cache_dtype,
            "rounds": out.rounds,
            "draft_tokens": out.draft_tokens,
            "drafts_proposed": out.drafts_proposed,
            "drafts_accepted": out.drafts_accepted,
            "accept_rate": out.accept_rate,
            "prefill_chunks": out.prefill_chunks,
        }
        return out
