"""The zoo through the port's serving path against the JAX package, on
the 2-layer ``.reduced()`` f32 variants and the same weights: greedy
``DecodeSession`` tokens over split SSM and MoE stacks (with the
quantized-kernel device segment on the MoE arch equal to the dense one:
its expert stacks are not kernel-routed), and
``quantize_params_for_serving`` byte for byte on the 4-D expert stacks
and the SSM mixer leaves. Exact throughout. The launcher and training
on the zoo are in tests/test_torch_zoo_launch.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.quantizer import \
    quantize_params_for_serving as jax_quantize_params
from repro.core.solver import PartitionPlan as JPlan
from repro.serving.backends import TransformerBackend as JBackend
from repro.serving.decode import DecodeSession as JSession
from repro_torch.core.quantizer import quantize_params_for_serving
from repro_torch.core.solver import PartitionPlan as TPlan
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT
from repro_torch.serving.backends import TransformerBackend as TBackend
from repro_torch.serving.decode import DecodeSession as TSession
from repro_torch.tree import tree_leaves, tree_map
from tests._torch_parity import to_numpy, zoo_weights

SEQ, MAX_LEN, GEN = 16, 32, 6


def _prompt(cfg, b=2, s=SEQ, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _plans(p, bits=8.0):
    kw = dict(p=p, bits_w=np.full(p, float(bits)), bits_x=float(bits),
              objective=0.0, psi_total=0.0, payload_bits=0.0, breakdown={})
    return JPlan(**kw), TPlan(**kw)


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "mamba2-1.3b"])
def pair(request):
    jcfg, jparams, tcfg, tparams = zoo_weights(request.param)
    return (JBackend(jcfg, jparams, seq_len=SEQ, decode_max_len=MAX_LEN),
            TBackend(tcfg, tparams, seq_len=SEQ, decode_max_len=MAX_LEN))


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_session_tokens(pair, bits, monkeypatch):
    """Greedy tokens of the partitioned pipeline at every cut p in
    {0, 1, L}: the reference's dense session's exactly, the cache bytes
    on both sides too; the port's quantized-kernel session (routed
    attention weights as wire structs, expert stacks and SSM mixers
    dense) gives the same tokens. A mamba2 session prefills through
    ``segment_prefill`` (its stack cannot be extended chunk by chunk)."""
    monkeypatch.setenv("REPRO_KERNELS", "reference")
    jb, tb = pair
    prompt = _prompt(tb.cfg)[:, :12]
    for p in range(tb.num_layers + 1):
        jplan, tplan = _plans(p, bits)
        jr = JSession(jb, jplan, max_len=MAX_LEN,
                      qkernels=False).generate(prompt, GEN)
        ts = TSession(tb, tplan, max_len=MAX_LEN, qkernels=False)
        tr = ts.generate(prompt, GEN)
        np.testing.assert_array_equal(tr.tokens, jr.tokens, err_msg=f"p={p}")
        assert tr.device_cache_dtype == jr.device_cache_dtype
        assert tr.device_cache_bytes == jr.device_cache_bytes
        assert tr.server_cache_bytes == jr.server_cache_bytes
        qs = TSession(tb, tplan, max_len=MAX_LEN, qkernels=True)
        np.testing.assert_array_equal(qs.generate(prompt, GEN).tokens,
                                      tr.tokens, err_msg=f"qkernels p={p}")
        if p and tb.cfg.moe is not None:
            layer = qs.dev_params["segment_blocks"][0]
            assert ops.is_wire_struct(layer["attn"]["wq"])
            assert not any(ops.is_wire_struct(v)
                           for v in layer["moe"].values())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b",
                                  "jamba-v0.1-52b"])
def test_quantize_params_for_serving_bytes(arch, bits):
    """Wire structs of the expert stacks (P, E, D, F), per period and
    per output column, and of the SSM mixer leaves, byte for byte."""
    _, _, tcfg, tparams = zoo_weights(arch)
    tree = tree_map(lambda t: t.numpy(), tparams)
    got = quantize_params_for_serving(tparams, bits)
    want = jax_quantize_params(jax.tree.map(jnp.asarray, tree), bits)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(tree_leaves(got))

    def at(tree, path):
        for k in path:
            tree = tree[getattr(k, "key", getattr(k, "idx", None))]
        return tree

    for path, w in flat_w:
        g = at(got, path)
        w = np.asarray(w)
        assert to_numpy(g).dtype == w.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(to_numpy(g), w,
                                      err_msg=jax.tree_util.keystr(path))
    blocks = got["blocks"]
    structs = sorted({k for b in blocks for part in b.values()
                      if isinstance(part, dict)
                      for k, v in part.items() if ops.is_wire_struct(v)})
    if tcfg.moe is not None:
        moe = next(b["moe"] for b in blocks if "moe" in b)
        nper = TT.num_periods(tcfg)
        assert moe["w_gate"]["scale"].shape == (nper, 1, 1, tcfg.moe.d_ff)
        assert not ops.is_wire_struct(moe["w_router"])
    if tcfg.ssm is not None:
        assert {"w_z", "w_x", "w_B", "w_C", "w_dt", "w_out"} <= set(structs)
