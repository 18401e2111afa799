"""The port's quantize / quantize-and-pack-int4 / dequantize entry points
and its serving quantizer against the JAX package, on the same NumPy
inputs. The CUDA kernels run only on the card (``chip_smoke.py`` holds
them against these plain versions bit for bit); here the CPU lane of
``kernels.ops`` meets the reference's Pallas kernels in interpret mode
and its ``quantize_stacked`` / ``quantize_params_for_serving``.

Everything is exact (integer codes, packed bytes, f32 metadata) except
one noted case: the reference's jitted dequantize contracts ``codes *
scale + mu`` into one FMA on the CPU, where the port rounds after the
product and after the sum (as two PyTorch ops do on the card). There
the port equals the reference's eager oracle bit for bit and the
interpret-mode kernel to the product's and the sum's f32 rounding (one
bf16 step after a bf16 cast).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jq
from repro.kernels import ref as jref
from repro.kernels.quantize import (dequantize_pallas, quantize_pack4_pallas,
                                    quantize_pallas)
from repro_torch.core import quantizer as tq
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qk
from repro_torch.tree import tree_map
from tests._torch_parity import lm_configs, lm_weights, to_numpy, to_torch

# (64, 128) is one reference block; (512, 1024) a 2 x 2 grid of them
SHAPES = [(64, 128), (512, 1024)]


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 3).astype(np.float32)


def _grid(x, bits, per_column):
    """The reference's grid of ``x``: per tensor or per column (1, N)."""
    axis = 0 if per_column else None
    mu = x.min(axis=axis, keepdims=True).reshape(1, -1)
    scale = ((x.max(axis=axis, keepdims=True).reshape(1, -1) - mu)
             / np.float32((1 << bits) - 1)).astype(np.float32)
    return scale, mu.astype(np.float32)


class TestEntryPoints:
    @pytest.mark.parametrize("shape", SHAPES, ids=["one-block", "2x2"])
    @pytest.mark.parametrize("per_column", [False, True],
                             ids=["tensor", "column"])
    @pytest.mark.parametrize("bits", [2, 4, 5, 8])
    def test_quantize_tensor(self, shape, per_column, bits):
        x = _x(shape, bits)
        scale, mu = _grid(x, bits, per_column)
        got = ops.quantize_tensor(to_torch(x), to_torch(scale),
                                  to_torch(mu), bits)
        assert got.dtype == torch.uint8
        want = quantize_pallas(x, scale, mu, bits, interpret=True)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))

    def test_rounds_half_to_even(self):
        """Exact ties (x - mu) / scale = k + 1/2 round to the even k."""
        x = (np.arange(-8, 120, dtype=np.float32) * 0.5).reshape(2, 64)
        one, zero = np.ones((1, 1), np.float32), np.zeros((1, 1), np.float32)
        got = to_numpy(ops.quantize_tensor(to_torch(x), 1.0, 0.0, 5))
        np.testing.assert_array_equal(
            got, np.asarray(quantize_pallas(x, one, zero, 5, interpret=True)))
        assert got[0, 9] == 0 and got[0, 11] == 2 and got[0, 13] == 2

    @pytest.mark.parametrize("shape", SHAPES, ids=["one-block", "2x2"])
    @pytest.mark.parametrize("per_column", [False, True],
                             ids=["tensor", "column"])
    def test_quantize_pack4(self, shape, per_column):
        x = _x(shape, 1)
        scale, mu = _grid(x, 4, per_column)
        got = ops.quantize_pack4(to_torch(x), to_torch(scale), to_torch(mu))
        assert tuple(got.shape) == (shape[0], shape[1] // 2)
        want = quantize_pack4_pallas(x, scale, mu, interpret=True)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
        # the same bytes as quantize then pack_int4
        np.testing.assert_array_equal(
            to_numpy(got), to_numpy(ops.pack_int4(ops.quantize_tensor(
                to_torch(x), to_torch(scale), to_torch(mu), 4))))

    @pytest.mark.parametrize("shape", SHAPES, ids=["one-block", "2x2"])
    @pytest.mark.parametrize("per_column", [False, True],
                             ids=["tensor", "column"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dequantize_tensor(self, shape, per_column, dtype):
        rng = np.random.default_rng(2)
        codes = rng.integers(0, 256, shape, np.uint8)
        scale, mu = _grid(_x(shape, 2), 8, per_column)
        got = to_numpy(ops.dequantize_tensor(
            to_torch(codes), to_torch(scale), to_torch(mu),
            getattr(torch, dtype)))
        eager = np.asarray(jref.dequantize_ref(codes, scale, mu,
                                               getattr(jnp, dtype)))
        np.testing.assert_array_equal(got, eager.astype(np.float32))
        kernel = np.asarray(dequantize_pallas(
            codes, scale, mu, getattr(jnp, dtype), interpret=True)
        ).astype(np.float32)
        if dtype == "float32":      # the product's and the sum's rounding
            prod = codes.astype(np.float32) * scale
            assert (np.abs(got - kernel) <= np.spacing(np.abs(prod))
                    + np.spacing(np.abs(kernel))).all()
            assert (got != kernel).any()        # the contraction is real
        else:               # one bf16 step: 2^-7 of the value's binade
            assert (np.abs(got - kernel) <= 2.0 ** -7 * np.abs(kernel)).all()

    def test_grouped_metadata_is_per_group(self):
        """(G, N) metadata: rows r use metadata row r // (R / G) — the same
        codes as quantizing each group of rows on its own."""
        x = _x((4 * 6, 10), 3)
        groups = x.reshape(4, 6, 10)
        mu = groups.min(axis=1)
        scale = ((groups.max(axis=1) - mu) / np.float32(255)).astype(
            np.float32)
        got = to_numpy(ops.quantize_tensor(to_torch(x), to_torch(scale),
                                           to_torch(mu), 8))
        for g in range(4):
            want = quantize_pallas(groups[g], scale[g:g + 1], mu[g:g + 1], 8,
                                   interpret=True)
            np.testing.assert_array_equal(got[6 * g:6 * g + 6],
                                          np.asarray(want))

    def test_rejects_what_no_version_takes(self):
        x = torch.zeros(4, 6)
        with pytest.raises(ValueError, match="odd"):
            ops.quantize_pack4(torch.zeros(4, 5), 1.0, 0.0)
        with pytest.raises(ValueError, match="bits"):
            ops.quantize_tensor(x, 1.0, 0.0, 9)
        with pytest.raises(ValueError, match="2-D"):
            ops.quantize_tensor(torch.zeros(2, 4, 6), 1.0, 0.0)
        with pytest.raises(ValueError, match="does not fit"):
            ops.dequantize_tensor(x.to(torch.uint8), torch.ones(5), 0.0)
        with pytest.raises(ValueError):           # no CUDA kernel on CPU
            qk.quantize_cuda(x, torch.ones(1, 1), torch.zeros(1, 1))


# smollm-8m's stacked leaves: 4 periods, d 256, 4/2 heads of 64, d_ff 768
LEAVES = {"wq": (4, 256, 4, 64), "wo": (4, 4, 64, 256),
          "w_up": (4, 256, 768), "w_down": (4, 768, 256),
          "odd": (4, 16, 33)}


def _assert_struct_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = to_numpy(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


class TestQuantizeStacked:
    @pytest.mark.parametrize("leaf", sorted(LEAVES))
    @pytest.mark.parametrize("per_channel", [True, False],
                             ids=["channel", "tensor"])
    @pytest.mark.parametrize("bits", [4, 8])
    def test_struct_equals_reference(self, leaf, per_channel, bits):
        x = _x(LEAVES[leaf], 4) * 0.05
        got = tq.quantize_stacked(to_torch(x), bits, per_channel=per_channel)
        want = jq.quantize_stacked(jnp.asarray(x), bits,
                                   per_channel=per_channel, use_pallas=False)
        _assert_struct_equal(got, want)
        if bits == 4 and leaf == "odd":     # odd width keeps int8 codes
            assert "codes" in got and int(got["codes"].max()) <= 15

    def test_struct_equals_reference_pallas_route(self):
        """A leaf that tiles the reference's blocks takes its vmapped
        quantize_pack4_pallas route (interpret mode): the same bytes."""
        x = _x(LEAVES["w_down"], 5) * 0.05
        got = tq.quantize_stacked(to_torch(x), 4)
        want = jq.quantize_stacked(jnp.asarray(x), 4, use_pallas=True)
        _assert_struct_equal(got, want)

    def test_bf16_leaf_at_4_bits_equals_reference(self):
        x = jnp.asarray(_x((4, 64, 32), 6)).astype(jnp.bfloat16)
        for per_channel in (True, False):
            _assert_struct_equal(
                tq.quantize_stacked(to_torch(x), 4, per_channel=per_channel),
                jq.quantize_stacked(x, 4, per_channel=per_channel,
                                    use_pallas=False))

    @pytest.mark.parametrize("per_channel", [True, False],
                             ids=["channel", "tensor"])
    @pytest.mark.parametrize("bits,shape", [(8, (4, 256, 96)),
                                            (5, (4, 256, 96)),
                                            (3, (3, 64, 33))],
                             ids=["8bit", "5bit", "3bit-odd-width"])
    def test_bf16_leaf_on_the_int8_branch_equals_reference(
            self, bits, shape, per_channel):
        """The reference computes ``(leaf - mu) / scale`` in the leaf's
        dtype there: bf16 differences and quotients give other codes than
        f32 ones, and the port's codes are the reference's byte for
        byte."""
        x = jnp.asarray(_x(shape, 8) * 0.05).astype(jnp.bfloat16)
        got = tq.quantize_stacked(to_torch(x), bits, per_channel=per_channel)
        want = jq.quantize_stacked(x, bits, per_channel=per_channel,
                                   use_pallas=False)
        _assert_struct_equal(got, want)
        assert "codes" in got
        f32 = tq.quantize_stacked(to_torch(x).float(), bits,
                                  per_channel=per_channel)
        if bits == 8:       # the bf16 rounding matters at 8 bits
            assert not torch.equal(f32["codes"], got["codes"])


@pytest.mark.parametrize("tp_pad", [1, 16], ids=["smollm-8m", "tp_pad16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_params_for_serving_equals_reference(tp_pad, bits):
    _, tcfg = lm_configs(tp_pad=tp_pad)
    tree = lm_weights(tcfg)
    got = tq.quantize_params_for_serving(tree_map(torch.from_numpy, tree),
                                         bits)
    want = jq.quantize_params_for_serving(
        tree_map(jnp.asarray, tree), bits)

    def walk(g, w, path="params"):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, list):
            assert len(g) == len(w), path
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}[{i}]")
        else:
            w = np.asarray(w)
            assert to_numpy(g).dtype == w.dtype, path
            np.testing.assert_array_equal(to_numpy(g), w, err_msg=path)

    walk(got, want)
    structs = [k for part in ("attn", "mlp")
               for k, v in got["blocks"][0][part].items()
               if ops.is_wire_struct(v)]
    assert sorted(structs) == sorted(tq.QUANTIZABLE[:7])


def test_quantize_tree_and_noise_scale():
    x = _x((16, 48), 7)
    tree = {"a": x, "b": [x[:4] * 2.0, x[4:]]}
    bits = {"a": 3, "b": [5, 8]}
    got = tq.quantize_tree(tree_map(to_torch, tree), bits)
    want = jq.quantize_tree(tree_map(jnp.asarray, tree), bits)
    np.testing.assert_array_equal(to_numpy(got["a"]), np.asarray(want["a"]))
    for g, w in zip(got["b"], want["b"]):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    np.testing.assert_array_equal(
        to_numpy(tq.quantize_tree({"a": to_torch(x)}, 6)["a"]),
        np.asarray(jq.quantize_tree({"a": jnp.asarray(x)}, 6)["a"]))
    np.testing.assert_allclose(float(tq.analytic_noise_scale(to_torch(x))),
                               float(jq.analytic_noise_scale(x)), rtol=1e-6)


def test_unported_frontend_configs_raise():
    """A frontend (embeds=) config, which the port once refused, now
    runs: smollm-8m with an audio frontend takes precomputed frame
    embeddings, and its forward logits are the reference's (f32 sums in
    another order through 4 layers: 1e-4)."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    jcfg, tcfg = (dataclasses.replace(c, frontend="audio")
                  for c in lm_configs())
    tree = lm_weights(tcfg)
    embeds = _x((2, 8, tcfg.d_model), 3) * tcfg.d_model ** -0.5
    want, _ = JT.forward(tree_map(jnp.asarray, tree), jcfg,
                         embeds=jnp.asarray(embeds))
    got, _ = TT.forward(TT.params_from_numpy(tree, tcfg, "cpu"), tcfg,
                        embeds=to_torch(embeds))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
