"""The serving launcher's decode step at a device position, on the CPU
lane: ``transformer.decode_step`` with a 0-d int32 / int64 position
tensor bitwise its host-int call (logits and caches, at every step of a
generation) on a dense, a MoE and an SSM arch, at ``--quant`` 0 / 8 / 4
for the dense one, and never read on the host; ``launch.serve.generate``
with ``graphs=False`` streaming the reference's tokens with no graph
captured; ``graphs=True`` raising off the card; and the dry run's decode
count at the fake position tensor ``build_step`` now passes equal to the
host-int count at the last slot of a full cache. The graph itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Every comparison here is exact (``torch.equal``, equal token streams,
equal counts)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import \
    quantize_params_for_serving as jax_quantize_params
from repro.launch import serve as jserve
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.core.quantizer import quantize_params_for_serving
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as TT
from repro_torch.roofline import op_cost
from repro_torch.tree import tree_leaves, tree_map
from tests._torch_parity import lm_configs, lm_weights
from tests._torch_parity import no_host_reads as parity_no_host_reads
from tests._torch_parity import to_torch, zoo_weights

B, S, GEN = 2, 12, 6


@pytest.fixture
def no_host_reads(monkeypatch):
    return parity_no_host_reads(monkeypatch)


def _dense(quant):
    _, cfg = lm_configs()
    params = TT.params_from_numpy(lm_weights(cfg), cfg, device="cpu")
    return cfg, quantize_params_for_serving(params, quant) if quant \
        else params


def _zoo(arch):
    _, _, cfg, params = zoo_weights(arch)
    return cfg, params


def _copy(caches):
    return tree_map(torch.clone, caches)


@pytest.mark.parametrize("model", [
    pytest.param(lambda: _dense(0), id="dense-q0"),
    pytest.param(lambda: _dense(8), id="dense-q8"),
    pytest.param(lambda: _dense(4), id="dense-q4"),
    pytest.param(lambda: _zoo("olmoe-1b-7b"), id="moe-olmoe"),
    pytest.param(lambda: _zoo("mamba2-1.3b"), id="ssm-mamba2")])
def test_decode_step_tensor_pos_bitwise_host_int(model, no_host_reads):
    """At every step of a 6-token generation after a 12-token prompt,
    ``decode_step`` at a 0-d int32 and an int64 position tensor gives the
    host-int call's logits and caches bit for bit, reading no tensor on
    the host on the way."""
    cfg, params = model()
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    logits, caches, _ = TT.prefill(params, cfg, prompt, max_len=S + GEN)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    lanes = {dt: _copy(caches) for dt in (torch.int32, torch.int64)}
    for i in range(GEN - 1):
        want, caches = TT.decode_step(params, cfg, tok, caches, S + i)
        for dt, lane in lanes.items():
            with no_host_reads:
                got, lane = TT.decode_step(params, cfg, tok, lane,
                                           torch.tensor(S + i, dtype=dt))
            assert torch.equal(got, want), (dt, i)
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(lane), tree_leaves(caches))), (dt, i)
        tok = torch.argmax(want[:, 0:1], -1).to(torch.int32)


@pytest.fixture(scope="module", params=[0, 8, 4], ids=["q0", "q8", "q4"])
def served(request):
    """Both packages' weight trees at ``--quant`` q, a prompt and the
    reference launcher's greedy tokens."""
    quant = request.param
    jcfg, tcfg = lm_configs()
    tree = lm_weights(tcfg)
    jparams = tree_map(jnp.asarray, tree)
    tparams = TT.params_from_numpy(tree, tcfg, device="cpu")
    if quant:
        jparams = jax_quantize_params(jparams, quant)
        tparams = quantize_params_for_serving(tparams, quant)
    prompt = np.random.default_rng(quant).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jtoks = jserve.generate(jparams, jcfg, jnp.asarray(prompt),
                            max_len=S + GEN, gen=GEN)
    return dict(tcfg=tcfg, tparams=tparams, prompt=prompt,
                tokens=np.asarray(jtoks))


def test_generate_eager_streams_reference_tokens(served):
    """``generate(graphs=False)`` (the CPU's default too) steps at the
    device position and streams the reference's greedy tokens, with no
    capture and the last step's logits kept."""
    for graphs in (False, None):
        stats = {}
        toks = tserve.generate(served["tparams"], served["tcfg"],
                               to_torch(served["prompt"]), max_len=S + GEN,
                               gen=GEN, stats=stats, graphs=graphs)
        np.testing.assert_array_equal(toks.numpy(), served["tokens"])
        assert stats["captures"] == 0
        assert tuple(stats["last_logits"].shape) == \
            (B, 1, served["tcfg"].padded_vocab())
        assert torch.equal(torch.argmax(stats["last_logits"], -1)
                           .to(torch.int32), toks[:, -1:])


def test_graphs_off_the_card_raise():
    """``generate(graphs=True)`` and ``run(graphs=True)`` on the CPU
    raise; nothing runs eagerly instead."""
    _, cfg = lm_configs()
    params = TT.params_from_numpy(lm_weights(cfg), cfg, device="cpu")
    prompt = torch.zeros((B, S), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA graphs"):
        tserve.generate(params, cfg, prompt, max_len=S + GEN, gen=GEN,
                        graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs"):
        tserve.run(cfg, batch=B, prompt_len=S, gen=GEN, device="cpu",
                   graphs=True)


def test_dry_run_decode_count_tensor_pos_equals_host_int():
    """The dry run's decode step (smollm-135m, ``decode_32k``) at
    ``build_step``'s fake 0-d int32 position counts exactly what the
    host-int step counts at the last slot of the full cache: FLOPs,
    bytes, bytes by op and kernel calls."""
    shape = INPUT_SHAPES["decode_32k"]
    spec = t_steps.build_step(t_get_config("smollm-135m"), shape,
                              serve_dtype=torch.bfloat16)
    params, token, caches, pos = spec.args
    assert torch.is_tensor(pos) and pos.shape == () and \
        pos.dtype == torch.int32
    got = op_cost.count(spec.fn, params, token, caches, pos)
    want = op_cost.count(spec.fn, params, token, caches, shape.seq_len - 1)
    assert got.flops == want.flops and got.bytes == want.bytes
    assert got.bytes_by_op == want.bytes_by_op
    assert got.kernel_calls == want.kernel_calls == {
        "decode_attention": spec.cfg.num_layers}
