"""The training programs as CUDA graphs, on the CPU lane: the donated
step (``train.graphs.DonatedStep``) runs the plain step on CPU tensors,
still holds the reference's jitted step, and raises when asked for a
graph off the card; a whole train step (dense, MoE, ``embeds=``, remat,
``accum_steps=2``) and the token stream's sampler read nothing on the
host, so a capture can take them; the sampler's draw is
``torch.multinomial``'s, so the stream's tokens are unchanged; the
donation's write-back, through a CPU stand-in for the graph, gives the
functional step's trees; ``launch.train.main`` and the dry run's train
count are unchanged. The graphs themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Every comparison is exact (``torch.equal``, equal floats, equal counts)
except the reference's losses, held at ``tests/test_torch_train.py``'s
``RTOL_LOSS``. The exact ones run at one intra-op thread: the CPU's
threaded scatter-add in the embedding's backward sums in a varying
order, so its gradient is not bitwise repeatable at several threads (on
the card every kernel of the step is)."""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs.base import InputShape
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.data import pipeline
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as TT
from repro_torch.models.frontend import stub_embeddings
from repro_torch.roofline import op_cost
from repro_torch.train import graphs
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_eval_step, make_train_step
from repro_torch.tree import tree_leaves, tree_map
from tests._torch_parity import FakeGraph, lm_configs, lm_weights
from tests._torch_parity import no_host_reads as parity_no_host_reads
from tests._torch_parity import to_numpy, to_torch, zoo_weights

RTOL_LOSS = 1e-5                 # tests/test_torch_train.py's
B, S = 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_host_reads(monkeypatch):
    return parity_no_host_reads(monkeypatch)


class DryGraph(FakeGraph):
    """``StageGraph`` on the CPU for a step that writes its inputs: the
    capture runs ``fn`` on copies of its static inputs (a CUDA capture
    executes nothing, so the donated state must not move before the
    first replay); a replay runs ``fn`` on the static inputs."""

    def __init__(self, fn, inputs, pool=None, generators=()):
        self.fn, self.inputs, self.pool = fn, tuple(inputs), pool
        self.generators = generators
        self.outputs = fn(*[t.clone() for t in self.inputs])
        self.log.append(("capture", self))


@pytest.fixture
def graphed(monkeypatch):
    """``DonatedStep`` and ``TokenStream`` capture on the CPU, through
    ``DryGraph``."""
    on = lambda graphs, device: graphs is not False      # noqa: E731
    for module in (graphs, pipeline):
        monkeypatch.setattr(module, "use_graphs", on)
        monkeypatch.setattr(module, "StageGraph", DryGraph)


@pytest.fixture(scope="module")
def dense():
    """smollm-8m at 2 layers in f32: (jax cfg, torch cfg, NumPy weights)."""
    jcfg, tcfg = (dataclasses.replace(c, num_layers=2) for c in lm_configs())
    return jcfg, tcfg, lm_weights(tcfg)


def _params(tcfg, tree):
    return TT.params_from_numpy(tree, tcfg, device="cpu")


def _batches(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _tbatch(b):
    return {k: to_torch(v) for k, v in b.items()}


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# The CPU lane

def test_cpu_lane_is_the_plain_step_and_holds_the_reference(dense,
                                                            one_thread):
    """``graphs=None`` on CPU tensors: the plain step, call for call (no
    capture), and four losses within ``RTOL_LOSS`` of the reference's
    jitted step."""
    jcfg, tcfg, tree = dense
    batches = _batches(tcfg.vocab_size, 4)
    step = make_train_step(tcfg, AdamWConfig(**OPT), remat=False)
    donated = graphs.DonatedStep(step)
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**OPT),
                                          remat=False),
                    donate_argnums=(0, 1))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init_opt_state(jp)
    p = _params(tcfg, tree)
    tp, ts, dp, ds = p, init_opt_state(p), p, init_opt_state(p)
    jl, tl = [], []
    for b in batches:
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = step(tp, ts, _tbatch(b))
        dp, ds, dm = donated(dp, ds, _tbatch(b))
        assert _same((dp, ds, dm), (tp, ts, tm))
        jl.append(float(jm["loss"]))
        tl.append(float(dm["loss"]))
    assert donated.captures == 0
    np.testing.assert_allclose(tl, jl, rtol=RTOL_LOSS)


@pytest.mark.parametrize("what", ["step", "stream", "launcher"])
def test_graphs_true_off_the_card_raises(dense, what):
    _, tcfg, tree = dense
    if what == "step":
        step = graphs.DonatedStep(make_eval_step(tcfg), donate=0,
                                  graphs=True)
        with pytest.raises(ValueError, match="CUDA"):
            step(_params(tcfg, tree), _tbatch(_batches(tcfg.vocab_size, 1)[0]))
    elif what == "stream":
        with pytest.raises(ValueError, match="CUDA"):
            pipeline.TokenStream(pipeline.TokenStreamConfig(
                vocab_size=64, seq_len=9, batch_size=2), device="cpu",
                graphs=True)
    else:
        with pytest.raises(ValueError, match="CUDA"):
            t_train.main(["--reduced", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16"], graphs=True)


# ---------------------------------------------------------------------------
# Nothing read on the host: what a capture needs

def _train_case(kind, dense):
    """(step, params, opt state, batch) of a small train step."""
    if kind in ("moe", "embeds"):
        arch = "olmoe-1b-7b" if kind == "moe" else "musicgen-medium"
        _, _, cfg, params = zoo_weights(arch)
    else:
        _, cfg, tree = dense
        params = _params(cfg, tree)
    batch = _tbatch(_batches(cfg.vocab_size, 1)[0])
    if kind == "embeds":
        batch = {"embeds": stub_embeddings(torch.Generator().manual_seed(1),
                                           cfg, B, S, torch.float32),
                 "labels": batch["labels"]}
    step = make_train_step(cfg, AdamWConfig(**OPT), remat=kind == "remat",
                           accum_steps=2 if kind == "accum2" else 1)
    return step, params, init_opt_state(params), batch


@pytest.mark.parametrize("kind", ["dense", "moe", "embeds", "remat",
                                  "accum2"])
def test_a_train_step_reads_nothing_on_the_host(dense, kind, no_host_reads):
    step, params, opt_state, batch = _train_case(kind, dense)
    with no_host_reads:
        p, o, m = step(params, opt_state, batch)
    assert int(o["step"]) == 1 and np.isfinite(float(m["loss"]))


def test_the_sampler_reads_nothing_on_the_host(no_host_reads):
    stream = pipeline.TokenStream(pipeline.TokenStreamConfig(
        vocab_size=300, seq_len=17, batch_size=3), device="cpu")
    with no_host_reads:
        toks = stream._sample(torch.Generator().manual_seed(5))
    assert toks.shape == (3, 17) and toks.dtype == torch.int32


# ---------------------------------------------------------------------------
# The sampler's draw and the stream's tokens

@pytest.mark.parametrize("shape", [(1, 7), (5, 300), (8, 2048)],
                         ids=["1x7", "5x300", "8x2048"])
@pytest.mark.parametrize("seed", [0, 1, 1_000_003])
def test_draw_is_multinomials(shape, seed):
    logits = torch.randn(shape, generator=torch.Generator().manual_seed(
        seed + 1)) * 8
    probs = torch.softmax(logits, -1)
    want = torch.multinomial(probs, 1, generator=torch.Generator()
                             .manual_seed(seed))[:, 0]
    got = pipeline.draw(probs, torch.Generator().manual_seed(seed))
    assert torch.equal(got, want)


def _multinomial_batch(stream, step):
    """The stream's batch ``step`` as the sampler drew it with
    ``torch.multinomial`` and a fresh generator per batch."""
    cfg = stream.cfg
    g = torch.Generator().manual_seed((cfg.seed + 1) * 1_000_003 + step)
    tok = torch.randint(0, cfg.vocab_size, (cfg.batch_size,), generator=g)
    toks = []
    for _ in range(cfg.seq_len):
        logits = (stream._emb_in[tok] @ stream._emb_out) * (
            cfg.sharpness / cfg.temperature)
        tok = torch.multinomial(torch.softmax(logits, -1), 1,
                                generator=g)[:, 0]
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32)


@pytest.mark.parametrize("start", [0, 3])
def test_stream_tokens_are_unchanged(start):
    stream = pipeline.TokenStream(pipeline.TokenStreamConfig(
        vocab_size=300, seq_len=17, batch_size=5, seed=3), device="cpu")
    it = stream.batches(start)
    for step in range(start, start + 3):
        b, want = next(it), _multinomial_batch(stream, step)
        assert torch.equal(b["tokens"], want[:, :-1])
        assert torch.equal(b["labels"], want[:, 1:])
    assert stream.captures == 0


def test_graphed_stream_is_the_eager_stream(graphed):
    """Through the stand-in: the first batch eager, the second the
    capture, every later one a replay with the batch's seed set on the
    registered generator; the batches (a resume included) bitwise the
    eager stream's, each the caller's own tensor."""
    cfg = pipeline.TokenStreamConfig(vocab_size=300, seq_len=17,
                                     batch_size=5, seed=2)
    for start in (0, 4):
        eager = pipeline.TokenStream(cfg, device="cpu", graphs=False)
        stream = pipeline.TokenStream(cfg, device="cpu")
        got, want = stream.batches(start), eager.batches(start)
        seen = []
        for _ in range(4):
            b, w = next(got), next(want)
            assert _same(b, w)
            seen.append(b["tokens"])
        assert stream.captures == 1 and eager.captures == 0
        assert stream._graph.generators == (stream._gen,)
        assert torch.equal(seen[2], next(eager.batches(start + 2))[
            "tokens"])                     # not overwritten by later replays


# ---------------------------------------------------------------------------
# The donation

def test_donated_write_back_is_the_functional_step(dense, graphed,
                                                   one_thread):
    """Through the stand-in: call 1 eager, call 2 the capture (on copies)
    then one replay, later calls replays. From call 2 on the trees handed
    in are the graph's buffers, updated in place and handed back; each
    step's metrics and trees bitwise the plain step's; a state that is
    not the graph's is copied in; the caller's batch is never written; a
    new batch shape is a new key."""
    _, tcfg, tree = dense
    batches = [_tbatch(b) for b in _batches(tcfg.vocab_size, 5)]
    step = make_train_step(tcfg, AdamWConfig(**OPT), remat=False)
    donated = graphs.DonatedStep(step)
    p0 = _params(tcfg, tree)
    tp, ts = p0, init_opt_state(p0)
    dp, ds = _params(tcfg, tree), init_opt_state(p0)
    for i, b in enumerate(batches):
        kept = tree_map(torch.clone, b)
        handed = (dp, ds)
        if i == 3:                       # a state that is not the graph's
            dp, ds = tree_map(torch.clone, (dp, ds))
        tp, ts, tm = step(tp, ts, b)
        dp, ds, dm = donated(dp, ds, b)
        assert _same((dp, ds, dm), (tp, ts, tm)), i
        assert _same(b, kept)
        if i == 1:
            static = (dp, ds)
            assert dp is handed[0] and ds is handed[1]
        if i >= 1:
            assert dp is static[0] and ds is static[1]
    assert donated.captures == 1
    # the same state at another batch shape: a new key, eager on first use
    short = {k: v[:, :16] for k, v in batches[0].items()}
    want = step(dp, ds, short)
    assert _same(donated(*tree_map(torch.clone, (dp, ds)), short), want)
    assert donated.captures == 1


def test_undonated_step_copies_its_inputs_in(dense, graphed, one_thread):
    """``donate=0`` (the eval step): the inputs' static buffers are the
    graph's own copies, so a replay on other params and another batch
    gives the plain step's metrics, and the caller's params are never
    written."""
    _, tcfg, tree = dense
    batches = [_tbatch(b) for b in _batches(tcfg.vocab_size, 4)]
    eval_step = make_eval_step(tcfg)
    donated = graphs.DonatedStep(eval_step, donate=0)
    params = [_params(tcfg, tree)]
    params.append(tree_map(lambda t: t * 1.01, params[0]))
    for i, b in enumerate(batches):
        p = params[i % 2]
        kept = tree_map(torch.clone, p)
        assert _same(donated(p, b), eval_step(p, b))
        assert _same(p, kept)
    assert donated.captures == 1


def _one_leaf_step(state, x):
    """A donated step that hands its ``kept`` leaf back as it is and
    replaces its ``moved`` leaf."""
    return {"kept": state["kept"], "moved": state["moved"] + x}, x.sum()


@pytest.mark.parametrize("kind", ["new_trees", "in_place", "one_leaf"])
def test_write_back_skips_the_leaves_that_are_their_buffers(dense, graphed,
                                                            one_thread, kind):
    """Through the stand-in, the capture copies back exactly the state
    leaves whose new tensor is not the graph's buffer: every leaf of a
    step that makes new trees (params, ``mu``, ``nu``, ``step``), none of
    an in-place step (``make_train_step(in_place=True)``: the update and
    the ``step`` counter written into the trees it was handed), one of a
    step that hands one leaf back; four calls bitwise the plain step."""
    if kind == "one_leaf":
        step, n = _one_leaf_step, 1
        state, want = ({"kept": torch.ones(3), "moved": torch.zeros(2)}
                       for _ in range(2))
        args = [torch.full((2,), float(i)) for i in range(4)]
        donated = graphs.DonatedStep(step, donate=1)
    else:
        _, tcfg, tree = dense
        step = make_train_step(tcfg, AdamWConfig(**OPT), remat=False,
                               in_place=kind == "in_place")
        p, q = _params(tcfg, tree), _params(tcfg, tree)
        state, want = (p, init_opt_state(p)), (q, init_opt_state(q))
        n = 0 if kind == "in_place" else len(tree_leaves(state))
        args = [_tbatch(b) for b in _batches(tcfg.vocab_size, 4)]
        donated = graphs.DonatedStep(step)
    for x in args:
        if kind == "one_leaf":
            state, got = donated(state, x)
            want, out = step(want, x)
        else:
            *state, got = donated(*state, x)
            *want, out = step(*want, x)
        assert _same((state, got), (want, out))
    assert donated.captures == 1 and donated.write_back == [n]


def test_a_step_that_changes_its_state_leaves_raises(graphed):
    def bad(state, x):
        return {"w": state["w"].double()}, x.sum()

    donated = graphs.DonatedStep(bad, donate=1)
    state = {"w": torch.ones(3)}
    donated(state, torch.ones(2))
    with pytest.raises(ValueError, match="leaves"):
        donated(state, torch.ones(2))


# ---------------------------------------------------------------------------
# The launcher and the dry run

def test_launch_train_main_on_cpu_is_unchanged(one_thread):
    """``main`` on the CPU: no capture, each step's metrics those of the
    plain step on the multinomial stream's batches, and ``graphs=False``
    printing the same lines (but their seconds)."""
    argv = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq", "16", "--lr", "3e-3", "--log-every", "2"]
    logs, stats = [], [{}, {}]
    for mode, st in zip((None, False), stats):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = t_train.main(argv, graphs=mode, stats=st)
        logs.append(re.sub(r"\(\d+\.\ds\)", "", buf.getvalue()))
    assert logs[0] == logs[1] and "step     4 loss" in logs[0]
    assert stats[0]["captures"] == {"step": 0, "sampler": 0}
    assert stats[0]["metrics"] == stats[1]["metrics"]
    cfg = t_get_config("smollm-135m").reduced()
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    o = init_opt_state(p)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, total_steps=6,
                                            warmup_steps=1), remat=False)
    stream = pipeline.TokenStream(pipeline.TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=17, batch_size=2), device="cpu")
    for i, m_main in enumerate(stats[0]["metrics"]):
        toks = _multinomial_batch(stream, i)
        p, o, m = step(p, o, {"tokens": toks[:, :-1],
                              "labels": toks[:, 1:]})
        assert m_main == {k: float(v) for k, v in m.items()}, i
    assert _same((p, o), (stats[0]["params"], stats[0]["opt_state"]))
    assert rc in (0, 1)


@pytest.mark.parametrize("accum,nbytes", [(1, 18204026942.0),
                                          (2, 21232406246.0)])
def test_dry_run_train_count_is_unchanged(accum, nbytes):
    """``launch.steps.build_step``'s train step (remat, the dry run's
    builder) of smollm-135m at 2 layers, B 8 x S 256, counted on fake
    tensors: the FLOPs, the bytes and the kernel calls the tree before
    the training graphs counted, to the byte."""
    cfg = dataclasses.replace(t_get_config("smollm-135m"), num_layers=2)
    spec = t_steps.build_step(cfg, InputShape("train_small", 256, 8,
                                              "train"), accum_steps=accum)
    summary = op_cost.count(spec.fn, *spec.args)
    assert summary.flops == 493115932672.0
    assert summary.bytes == nbytes
    assert summary.kernel_calls == {"flash_attention": 4 * accum,
                                    "flash_attention_bwd": 2 * accum}
