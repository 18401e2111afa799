"""The port's ``WorkloadBalancer`` (dynamic workload balancing over one
shared server) against the JAX package's, on stub-calibrated servers
(synthetic noise constants, the real Alg. 1 store; no training): the
schedule plan for plan and objective for objective, ``total_latency``,
the scalar per-request re-pricing ``_serve_under_load`` it is locked
against, and the fleet metrics' columnar aggregates against their
record-by-record legacy loop."""
import dataclasses

import numpy as np
import pytest

from repro.configs.classifier import CIFAR_CNN as J_CIFAR
from repro.configs.classifier import MNIST_MLP as J_MNIST
from repro.core import cost_model as jcm
from repro.serving.scheduler import WorkloadBalancer as JBalancer
from repro.serving.scheduler import total_latency as j_total_latency
from repro.serving.simulator import InferenceRequest as JRequest
from repro.serving.testing import stub_classifier_server as j_stub
from repro_torch.configs.classifier import CIFAR_CNN as T_CIFAR
from repro_torch.configs.classifier import MNIST_MLP as T_MNIST
from repro_torch.core import cost_model as tcm
from repro_torch.serving.engine import (FleetEngine, FleetMetrics,
                                        RetryPolicy, churn_trace,
                                        degrade_trace, materialize,
                                        mmpp_arrivals)
from repro_torch.serving.scheduler import WorkloadBalancer as TBalancer
from repro_torch.serving.scheduler import total_latency as t_total_latency
from repro_torch.serving.simulator import InferenceRequest as TRequest
from repro_torch.serving.testing import stub_classifier_server as t_stub
# the parity helpers cap torch's threads at this worker's share
import tests._torch_parity  # noqa: F401

SIDES = {"j": (jcm, JRequest, JBalancer, j_total_latency, j_stub,
               (("mnist", J_MNIST), ("cifar", J_CIFAR))),
         "t": (tcm, TRequest, TBalancer, t_total_latency, t_stub,
               (("mnist", T_MNIST), ("cifar", T_CIFAR)))}


def _side(key, n=12, mixed=False):
    """One package's stub server (default 3 GHz server: attractive at low
    load, so the queue is what pushes work device-side) and a window of
    heterogeneous requests: strong and weak devices, two budgets,
    cached and uncached segments, optionally two models."""
    cm, Request, Balancer, total, stub, configs = SIDES[key]
    dev, ch, w = cm.DeviceProfile(), cm.Channel(capacity_bps=2e6), \
        cm.ObjectiveWeights()
    srv = stub(configs if mixed else configs[:1], device=dev, channel=ch,
               weights=w)
    strong = dataclasses.replace(dev, f_clock=2e9)
    reqs = [Request(("mnist", "cifar")[i % 2] if mixed else "mnist",
                    0.01 if i % 2 else 0.004,
                    strong if i % 3 == 0 else dev, ch, w,
                    segment_cached=bool(i % 2)) for i in range(n)]
    return srv, reqs, cm, Balancer, total


def _facts(sr):
    plan = sr.result.plan
    return (plan.p, np.asarray(plan.bits_w).tolist(), plan.bits_x,
            sr.result.objective, sr.result.payload_bits, sr.queue_delay,
            sr.start_order, sr.result.extra["queue_delay"])


@pytest.mark.parametrize("mixed", [False, True], ids=["mnist", "mixed"])
@pytest.mark.parametrize("policy", ["fcfs", "balanced"])
def test_schedule_matches_reference(policy, mixed):
    """``schedule`` plan for plan, objective for objective, and the
    window's ``total_latency``, exactly."""
    out = {}
    for key in "jt":
        srv, reqs, cm, Balancer, total = _side(key, n=24, mixed=mixed)
        sched = Balancer(cm.ServerProfile(), policy=policy).schedule(srv,
                                                                     reqs)
        assert [sr.request for sr in sched] == reqs
        out[key] = ([_facts(sr) for sr in sched], total(sched))
    assert out["t"] == out["j"]
    # the queue really built up and moved some plan device-side
    facts = out["t"][0]
    assert max(f[5] for f in facts) > 0
    assert len({f[0] for f in facts}) > 1


@pytest.mark.parametrize("mixed", [False, True], ids=["mnist", "mixed"])
def test_scalar_reference_pricing(mixed):
    """The port's window pricing reproduces the per-request Alg. 2
    re-pricing (``_serve_under_load``) decision for decision, as the
    reference's does; and the port's scalar pricing equals the
    reference's scalar pricing exactly at every queue it sees."""
    scalar = {}
    for key in "jt":
        srv, reqs, cm, Balancer, _ = _side(key, mixed=mixed)
        bal = Balancer(cm.ServerProfile(), policy="fcfs")
        queue, rows = 0.0, []
        for sr in bal.schedule(srv, reqs):
            ref = bal._serve_under_load(srv, sr.request, queue)
            assert sr.result.plan is ref.plan
            assert sr.result.objective == pytest.approx(ref.objective,
                                                        rel=1e-9)
            rows.append((ref.plan.p, np.asarray(ref.plan.bits_w).tolist(),
                         ref.objective, ref.payload_bits,
                         dataclasses.astuple(ref.costs),
                         ref.extra["queue_delay"],
                         bal._server_seconds(srv, sr.request, queue)))
            queue += ref.costs.t_server
        scalar[key] = rows
    assert scalar["t"] == scalar["j"]


def test_total_latency_of_unqueued_results():
    """``serve_batch`` deployments carry no queue delay: ``total_latency``
    reads it as 0 in both packages and sums the same stage times."""
    out = {}
    for key in "jt":
        srv, reqs, _, _, total = _side(key, n=6)
        deps = srv.serve_batch(reqs)
        assert all(d.queue_delay == 0.0 for d in deps)
        out[key] = total(deps)
    assert out["t"] == out["j"]


def test_columnar_metrics_match_legacy_aggregation():
    """Every ``FleetMetrics`` aggregate of the columnar fast path equals
    the record-by-record legacy loop on materialized dataclasses —
    exactly, except the float means of ``mean_stage_seconds()``, held to
    ``rel=1e-12``. Both walk the same stage durations in the same trace
    order, but the columnar path adds them with the built-in ``sum()``,
    which for floats is compensated (Neumaier) summation since Python
    3.12, while the legacy loop accumulates with plain ``+``: the two
    can differ in the last ulp (here ``ship``, by one ulp)."""
    dev, w = tcm.DeviceProfile(), tcm.ObjectiveWeights()
    slow = tcm.ServerProfile(f_clock=1e7)
    srv = t_stub([("mnist", T_MNIST)], server=slow, device=dev,
                 channel=tcm.Channel(), weights=w)
    arrivals = mmpp_arrivals(250, rates=(100.0, 900.0),
                             mean_dwell=(0.3, 0.1), seed=4)
    trace = materialize("mnist", arrivals, [dev], [tcm.Channel()], w,
                        budgets=(0.004, 0.01, 0.02), deadlines=(0.05, 0.2),
                        batches=(1,), device_pool=24, seed=4)
    horizon = trace[-1].arrival_time + 0.5
    devs = [f"dev-{i}" for i in range(24)]
    faults = (churn_trace(devs[::2], horizon, mean_uptime=0.2,
                          mean_downtime=0.1, seed=4)
              + degrade_trace(devs[1::2], horizon, mean_interval=0.5,
                              mean_duration=0.1, seed=5))
    m = FleetEngine(srv, servers=[slow, tcm.ServerProfile(f_clock=4e7),
                                  tcm.ServerProfile(f_clock=1e7)],
                    retry=RetryPolicy(max_attempts=3, base_backoff_s=0.01,
                                      max_backoff_s=0.1,
                                      degrade_on_retry=True),
                    faults=faults, slo="degrade",
                    epoch_interval=0.005).run(trace)
    legacy = FleetMetrics(
        records=[m.records[i] for i in range(len(m.records))],
        server_busy=m.server_busy,
        queue_samples=[(float(t), int(d)) for t, d in m.queue_samples],
        horizon=m.horizon, dead_letters=m.dead_letters,
        journal=m.journal, store=None)
    assert legacy.summary() == m.summary()
    assert legacy.deadline_miss_rate() == m.deadline_miss_rate()
    assert legacy.drop_reasons() == m.drop_reasons()
    assert legacy.retry_rate() == m.retry_rate()
    assert legacy.goodput_rps() == m.goodput_rps()
    assert legacy.tokens_per_s() == m.tokens_per_s()
    assert legacy.utilization() == m.utilization()
    assert legacy.mean_queue_depth() == m.mean_queue_depth()
    assert legacy.retried() == m.retried() > 0
    assert legacy.disrupted() == m.disrupted()
    stages, legacy_stages = m.mean_stage_seconds(), \
        legacy.mean_stage_seconds()
    assert list(legacy_stages) == list(stages)
    for k, v in stages.items():
        assert legacy_stages[k] == pytest.approx(v, rel=1e-12, abs=0.0), k
    assert np.array_equal(legacy.latencies(), m.latencies())
    assert np.array_equal(legacy.ttfts(), m.ttfts())
    assert [r.index for r in legacy.completed()] \
        == [r.index for r in m.completed()]
    legacy.assert_terminal()
    m.assert_terminal()
