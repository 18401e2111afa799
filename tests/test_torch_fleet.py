"""The port's fleet engine against the JAX package's, on the CPU: both
are NumPy, so every run is held to the reference EXACTLY — the event
journal byte for byte (``to_jsonl``), the metrics summary, every
record's plan, payload, server and stage timeline, the drop reasons
and the dead letters. Each case builds the stub servers (synthetic
calibration constants, the real Alg. 1 store) and the trace from each
package's own modules with the same seed, so the inputs are equal by
construction and nothing crosses from one package to the other except
a reference journal read back by the port."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.configs.base as j_base
import repro.configs.classifier as j_classifier
import repro.core.cost_model as jcm
import repro.serving.engine as j_engine
import repro.serving.qpart_server as j_qs
import repro.serving.testing as j_testing
import repro_torch.configs.base as t_base
import repro_torch.configs.classifier as t_classifier
import repro_torch.core.cost_model as tcm
import repro_torch.serving.engine as t_engine
import repro_torch.serving.qpart_server as t_qs
import repro_torch.serving.testing as t_testing
# the parity helpers cap torch's threads at this worker's share
import tests._torch_parity  # noqa: F401

J = SimpleNamespace(E=j_engine, cm=jcm, testing=j_testing, qs=j_qs,
                    cfg=j_classifier, base=j_base)
T = SimpleNamespace(E=t_engine, cm=tcm, testing=t_testing, qs=t_qs,
                    cfg=t_classifier, base=t_base)
POLICIES = ("fcfs", "balanced", "edf", "least_loaded")


# -- the fleet benchmark's two recipes, built from one package ------------
@dataclasses.dataclass
class Bench:
    P: SimpleNamespace
    srv: object
    fleet: list
    trace: list
    chaos_trace: list
    ambient: object


def _bench(P) -> Bench:
    """``benchmarks/fleet_bench.py``: 1,200 requests over 3 slow servers,
    heterogeneous devices and channels, mixed budgets, deadlines and
    batches, 200 repeat requesters; the chaos trace is MMPP arrivals
    with churn, drift and permanent losses."""
    devices = [P.cm.DeviceProfile(f_clock=f) for f in (4e8, 1e9, 2e9)]
    channels = [P.cm.Channel(capacity_bps=c) for c in (2e6, 1e7, 2e8)]
    weights = P.cm.ObjectiveWeights()
    fleet = [P.cm.ServerProfile(f_clock=3e8)] * 3
    srv = P.testing.stub_classifier_server(
        [("mnist", P.cfg.MNIST_MLP)], server=fleet[0], device=devices[0],
        channel=channels[1], weights=weights)
    mix = dict(budgets=(0.004, 0.01, 0.02), deadlines=(0.020, 0.035, 0.060),
               batches=(1, 1, 4), device_pool=200, seed=0)
    trace = P.testing.poisson_trace("mnist", 1200, 700.0, devices, channels,
                                    weights, **mix)
    arrivals = P.E.mmpp_arrivals(1200, rates=(200.0, 1400.0),
                                 mean_dwell=(0.5, 0.1), seed=0)
    chaos = P.E.materialize("mnist", arrivals, devices, channels, weights,
                            **mix)
    horizon = chaos[-1].arrival_time + 0.5
    flappy = [f"dev-{i}" for i in range(0, 200, 4)]
    drifty = [f"dev-{i}" for i in range(1, 200, 4)]
    doomed = [f"dev-{i}" for i in range(2, 200, 16)]
    rng = np.random.default_rng(2)
    deaths = P.E.FaultInjector([
        P.E.FaultEvent(float(rng.uniform(0.3 * horizon, 0.9 * horizon)),
                       P.E.DISCONNECT, d) for d in doomed])
    ambient = (P.E.churn_trace(flappy, horizon, mean_uptime=0.35,
                               mean_downtime=0.12, seed=0)
               + P.E.degrade_trace(drifty, horizon, mean_interval=1.0,
                                   mean_duration=0.15, seed=1)
               + deaths)
    return Bench(P, srv, fleet, trace, chaos, ambient)


def _targeted_cuts(P, baseline, n_cuts=150, downtime=0.03, seed=0):
    """Disconnect/reconnect pairs aimed mid-transfer at the baseline
    run's longest radio windows (the benchmark's recipe)."""
    done = [r for r in baseline.completed()
            if r.request.device_id is not None
            and r.timeline.transfer_done > r.timeline.admit]
    done.sort(key=lambda r: r.timeline.transfer_done - r.timeline.admit,
              reverse=True)
    rng = np.random.default_rng(seed)
    events = []
    for r in done[:n_cuts]:
        t0, t1 = r.timeline.admit, r.timeline.transfer_done
        cut = float(t0 + rng.uniform(0.25, 0.75) * (t1 - t0))
        events.append(P.E.FaultEvent(cut, P.E.DISCONNECT,
                                     r.request.device_id))
        events.append(P.E.FaultEvent(cut + downtime, P.E.RECONNECT,
                                     r.request.device_id))
    return P.E.FaultInjector(events)


def _retry(P):
    return P.E.RetryPolicy(max_attempts=3, base_backoff_s=0.01,
                           max_backoff_s=0.1, degrade_on_retry=True)


@pytest.fixture(scope="module")
def benches():
    return _bench(J), _bench(T)


# -- the comparison ------------------------------------------------------
def _plan_facts(dep):
    if dep is None:
        return None
    plan = dep.plan
    return (plan.p, np.asarray(plan.bits_w).tolist(), plan.bits_x,
            dep.payload_bits, dep.result.objective, dep.queue_delay)


def _record_facts(r):
    tl = None if r.timeline is None else dataclasses.astuple(r.timeline)
    return (r.index, r.server, r.start_order, r.backlog_at_admission,
            r.queue_delay, r.degraded_to, r.rejected, r.drop_reason,
            r.attempts, r.faults, r.parked, r.decode_tokens,
            r.tokens_emitted, r.decode_done, tl, _plan_facts(r.deployment))


def assert_same_run(jm, tm):
    """Exact equality of two packages' runs of one trace."""
    if isinstance(jm.journal, j_engine.EventJournal):
        assert tm.journal.to_jsonl() == jm.journal.to_jsonl()
    elif jm.journal is not None:
        assert np.array_equal(tm.journal.times, jm.journal.times)
        assert np.array_equal(tm.journal.kinds, jm.journal.kinds)
    else:
        assert tm.journal is None
    assert tm.summary() == jm.summary()
    assert tm.drop_reasons() == jm.drop_reasons()
    assert tm.mean_stage_seconds() == jm.mean_stage_seconds()
    assert [d.to_dict() for d in tm.dead_letters] \
        == [d.to_dict() for d in jm.dead_letters]
    assert len(tm.records) == len(jm.records)
    for jr, tr in zip(jm.records, tm.records):
        assert _record_facts(tr) == _record_facts(jr), jr.index


# -- the recipes -------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_recipe(benches, policy):
    """The Poisson fleet recipe: identical decisions, timelines, caches
    (payloads) and SLO degrades under each policy."""
    runs = [b.P.E.FleetEngine(b.srv, servers=b.fleet, policy=policy,
                              slo="degrade", epoch_interval=0.005)
            .run(b.trace) for b in benches]
    assert_same_run(*runs)
    s = runs[1].summary()
    assert s["completed"] + s["rejected"] == 1200


@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_chaos_recipe(benches, policy):
    """The chaos recipe: ambient churn/drift/losses plus cuts aimed at
    each package's own baseline schedule, retried with degraded
    budgets — every cancellation, retry and dead letter equal."""
    runs = []
    for b in benches:
        kw = dict(servers=b.fleet, policy=policy, slo="degrade",
                  epoch_interval=0.005)
        baseline = b.P.E.FleetEngine(b.srv, **kw).run(b.chaos_trace)
        faults = b.ambient + _targeted_cuts(b.P, baseline)
        m = b.P.E.FleetEngine(b.srv, retry=_retry(b.P), faults=faults,
                              **kw).run(b.chaos_trace)
        m.assert_terminal()
        runs.append(m)
    assert_same_run(*runs)
    assert runs[1].retried() > 0 and runs[1].dead_letters


def test_reference_journal_replays_in_the_port(benches):
    """A journal the reference wrote, read by the port's
    ``EventJournal.from_jsonl``, replays in the port entry for entry."""
    jb, tb = benches
    faults = [b.ambient for b in benches]
    kw = dict(policy="fcfs", slo="degrade", epoch_interval=0.005)
    jm = j_engine.FleetEngine(jb.srv, servers=jb.fleet, retry=_retry(J),
                              faults=faults[0], **kw).run(jb.chaos_trace)
    text = jm.journal.to_jsonl()
    journal = t_engine.EventJournal.from_jsonl(text)
    assert journal.to_jsonl() == text
    replayed = journal.verify_replay(tb.srv, tb.chaos_trace,
                                     servers=tb.fleet)
    assert replayed.summary() == jm.summary()


@pytest.mark.parametrize("policy", POLICIES)
def test_admission_modes(benches, policy):
    """``admission="reference"`` (the scalar per-server loop) equals the
    reference's, and equals the port's own vectorized admission."""
    runs = {}
    for pkg, b in zip("jt", benches):
        for mode in ("reference", "vectorized"):
            runs[pkg, mode] = b.P.E.FleetEngine(
                b.srv, servers=b.fleet, policy=policy, slo="degrade",
                epoch_interval=0.005, retry=_retry(b.P), faults=b.ambient,
                admission=mode).run(b.chaos_trace[:400])
    assert_same_run(runs["j", "reference"], runs["t", "reference"])
    assert runs["t", "reference"].journal.diff(
        runs["t", "vectorized"].journal) is None


@pytest.mark.parametrize("knobs", [dict(journal="light"),
                                   dict(journal="off"),
                                   dict(records="light"),
                                   dict(reprice_cache=False)],
                         ids=["journal-light", "journal-off",
                              "records-light", "no-reprice-cache"])
def test_bookkeeping_modes(benches, knobs):
    """The scale knobs change bookkeeping only: each equals the
    reference's run under the same knob."""
    runs = [b.P.E.FleetEngine(b.srv, servers=b.fleet, policy="edf",
                              slo="degrade", epoch_interval=0.005,
                              retry=_retry(b.P), faults=b.ambient, **knobs)
            .run(b.chaos_trace[:400]) for b in benches]
    assert_same_run(*runs)
    if knobs.get("records") == "light":
        assert all(r.deployment is None for r in runs[1].completed())


@pytest.mark.parametrize("policy", POLICIES)
def test_calibrated_provider(benches, policy):
    """A ``CalibratedCost`` from the same ``StageRates`` in both packages
    re-prices admission and the reservation timelines identically."""
    runs = []
    for b in benches:
        cal = b.P.cm.CalibratedCost(
            {}, {}, b.P.cm.StageRates(2e-9, 1e-9, 5e-5),
            b.P.cm.StageRates(4e-10, 2e-10, 1e-5))
        runs.append(b.P.E.FleetEngine(
            b.srv, servers=b.fleet, policy=policy, slo="degrade",
            epoch_interval=0.005, provider=cal).run(b.trace[:400]))
    assert_same_run(*runs)


# -- the LM decode lane ----------------------------------------------------
def _lm(P, kv_page_tokens):
    cfg = dataclasses.replace(P.base.get_config("smollm-135m").reduced(),
                              dtype="float32")
    dev = P.cm.DeviceProfile(memory_bytes=2e9)
    ch = P.cm.Channel(capacity_bps=2e10)
    w = P.cm.ObjectiveWeights(eta=1e5)
    srv = P.qs.QPARTServer()
    P.testing.stub_transformer_calibration(
        srv, "lm", cfg, dev, ch, w, seq_len=16, decode_max_len=64,
        kv_page_tokens=kv_page_tokens)
    devs = [dev, dataclasses.replace(dev, f_clock=2e9)]
    chans = [ch, P.cm.Channel(capacity_bps=2e6)]
    trace = P.testing.poisson_trace("lm", 48, 200.0, devs, chans, w,
                                    budgets=(0.01, 0.05),
                                    deadlines=(0.05, 0.5), device_pool=10,
                                    seed=3)
    rng = np.random.default_rng(3)
    trace = [dataclasses.replace(r, max_new_tokens=int(n)) for r, n in
             zip(trace, rng.integers(4, 40, len(trace)))]
    return srv, trace


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shape", ["dense", "paged", "paged-chunked"])
def test_lm_decode_lane(policy, shape):
    """Decode streams on the fleet's continuous-batching lane with
    device-KV residency (dense worst case or page-granular), chunked
    prefill, and a mid-stream disconnect that severs a stream."""
    page = None if shape == "dense" else 16
    chunk = 4 if shape == "paged-chunked" else None
    runs, ledgers = [], []
    for P in (J, T):
        srv, trace = _lm(P, page)
        horizon = trace[-1].arrival_time
        faults = [P.E.FaultEvent(horizon / 2, P.E.DISCONNECT, "dev-0"),
                  P.E.FaultEvent(horizon, P.E.RECONNECT, "dev-0")]
        eng = P.E.FleetEngine(srv, servers=[srv.server] * 2, policy=policy,
                              slo="degrade", epoch_interval=0.002,
                              retry=_retry(P), faults=faults,
                              prefill_chunk_tokens=chunk)
        m = eng.run(trace)
        m.assert_terminal()
        runs.append(m)
        led = eng.kv_ledger
        ledgers.append((led.peak_bytes, led.total_page_allocs,
                        led.total_page_frees, led.open_streams))
    assert_same_run(*runs)
    assert ledgers[1] == ledgers[0]
    assert runs[1].summary()["tokens_per_s"] > 0
    if page is not None:
        assert ledgers[1][1] == ledgers[1][2] > 0


def test_lm_backend_kv_row_is_the_reference_row():
    """``TransformerBackend.kv_bytes_row`` — what the decode lane's
    residency accounting reads — is the reference's float64 NumPy row,
    dense and page-rounded."""
    srvs = [_lm(P, 16)[0] for P in (J, T)]
    jb, tb = (s.models["lm"].backend for s in srvs)
    for batch, tokens in ((1, None), (2, 20), (1, 64), (4, 33)):
        jr, tr = jb.kv_bytes_row(batch, tokens), tb.kv_bytes_row(batch,
                                                                 tokens)
        assert isinstance(tr, np.ndarray) and tr.dtype == np.float64
        assert np.array_equal(tr, jr)


# -- trace and fault generators ---------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
def test_trace_generators(seed):
    """``mmpp_arrivals`` / ``diurnal_arrivals`` / ``churn_trace`` /
    ``degrade_trace`` equal element for element."""
    out = []
    for P in (J, T):
        devs = [f"dev-{i}" for i in range(12)]
        out.append((
            P.E.mmpp_arrivals(500, rates=(100.0, 900.0),
                              mean_dwell=(0.3, 0.1), seed=seed),
            P.E.diurnal_arrivals(500, base_rate=300.0, seed=seed),
            [e.to_dict() for e in P.E.churn_trace(
                devs, 3.0, mean_uptime=0.2, mean_downtime=0.1,
                seed=seed).events],
            [e.to_dict() for e in P.E.degrade_trace(
                devs, 3.0, mean_interval=0.5, mean_duration=0.1,
                seed=seed).events]))
    (jm, jd, jc, jg), (tm, td, tc, tg) = out
    assert np.array_equal(tm, jm) and np.array_equal(td, jd)
    assert tc == jc and tg == jg and tc and tg
