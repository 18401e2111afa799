"""The port's quantizer, float8 storage cast and noise calibration
against the JAX package, on the same NumPy inputs: integer results and
the Delta table bit for bit, float energies to f32 summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jnoise
from repro.core import quantizer as jq
from repro_torch.core import noise as tnoise
from repro_torch.core import quantizer as tq
from repro_torch.models.common import to_storage
from tests._torch_parity import to_numpy, to_torch


def _x(seed=0, shape=(16, 48), scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


class TestQuantizer:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    def test_codes_scale_mu_exact(self, bits):
        x = _x(bits)
        codes, scale, mu = tq.quantize(to_torch(x), bits)
        jc, js, jm = jq.quantize(jnp.asarray(x), bits)
        np.testing.assert_array_equal(to_numpy(codes), np.asarray(jc))
        assert float(scale) == float(js) and float(mu) == float(jm)
        np.testing.assert_array_equal(
            to_numpy(tq.fake_quant(to_torch(x), bits)),
            np.asarray(jq.fake_quant(jnp.asarray(x), bits)))

    def test_pinned_grid_and_noise_energy(self):
        """Caller-pinned per-row grids (the channel hop's form) and the
        measured noise energy."""
        x = _x(7)
        mu = x.min(axis=1, keepdims=True)
        phi = x.max(axis=1, keepdims=True)
        codes, _, _ = tq.quantize(to_torch(x), 6, mu=to_torch(mu),
                                  phi=to_torch(phi))
        jc, _, _ = jq.quantize(jnp.asarray(x), 6, mu=mu, phi=phi)
        np.testing.assert_array_equal(to_numpy(codes), np.asarray(jc))
        np.testing.assert_allclose(
            float(tq.quant_noise_energy(to_torch(x), 5)),
            float(jq.quant_noise_energy(jnp.asarray(x), 5)), rtol=1e-5)

    def test_bit_rounding_and_payload(self):
        b = np.array([0.3, 2.0, 2.01, 7.5, 15.99, 30.0])
        np.testing.assert_array_equal(tq.round_bits(b),
                                      np.asarray(jq.round_bits(b)))
        assert tq.payload_bits(1000, 6) == int(jq.payload_bits(1000, 6))
        q = {"codes_packed": torch.zeros(3, 8, 4, dtype=torch.uint8),
             "scale": torch.zeros(3, 1, 1), "mu": torch.zeros(3, 1, 1)}
        jqs = {"codes_packed": jnp.zeros((3, 8, 4), jnp.uint8),
               "scale": jnp.zeros((3, 1, 1)), "mu": jnp.zeros((3, 1, 1))}
        assert tq.stacked_wire_bits(q) == jq.stacked_wire_bits(jqs)


class TestFloat8StorageCast:
    """Every float8 cache write reproduces the reference's cast bit for
    bit, including nan for magnitudes that round past 448 (a bare torch
    cast saturates them to +-448)."""

    SWEEP = np.array([0.0, -0.0, 1.0, -1.5, 447.0, 448.0, 449.0, 463.9,
                      464.0, 464.1, 465.0, 470.0, 480.0, 1e6, -464.0,
                      -464.1, -1e6, np.inf, -np.inf, np.nan, 1e-9, 2 ** -9,
                      2 ** -10, 3 * 2 ** -11], np.float32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bitwise_against_reference(self, dtype):
        rng = np.random.default_rng(0)
        x = np.concatenate([self.SWEEP, rng.standard_normal(512) * 300])
        jx = jnp.asarray(x, jnp.float32).astype(dtype)
        want = np.asarray(jx.astype(jnp.float8_e4m3fn)).view(np.uint8)
        got = to_storage(to_torch(jx), torch.float8_e4m3fn)
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)
        # and it is a real correction: torch's own cast saturates
        assert (to_torch(jx).to(torch.float8_e4m3fn).view(torch.uint8)
                .numpy() != want).any()

    def test_other_storage_dtypes_are_plain_casts(self):
        x = to_torch(_x(1))
        assert torch.equal(to_storage(x, torch.bfloat16),
                           x.to(torch.bfloat16))


class TestNoise:
    def test_adversarial_energy(self):
        logits = _x(2, (12, 40))
        np.testing.assert_allclose(
            to_numpy(tnoise.adversarial_noise_energy(to_torch(logits))),
            np.asarray(jnoise.adversarial_noise_energy(logits)), rtol=1e-6)

    def test_calibrate_delta_table_exact_with_reference_draws(self):
        """Fed the reference's own Gaussian draws (jax.random with key 0,
        folded per grid point and trial), the Delta table is bit for bit
        the reference's."""
        rng = np.random.default_rng(3)
        logits = (rng.standard_normal((32, 64)) * 2).astype(np.float32)
        y = np.argmax(logits + rng.standard_normal(logits.shape) * 0.5, -1)
        rhos = np.array([0.02, 0.05, 0.01])
        targets = (0.001, 0.01, 0.05)
        trials = 3
        key = jax.random.key(0)
        draws = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key, i), logits.shape))
            for i in range(tnoise.DELTA_GRID * trials)])
        want, jbase = jnoise.calibrate_delta(
            lambda p, a: jnp.asarray(logits), None, None, jnp.asarray(y),
            rhos, targets, trials=trials)
        got, tbase = tnoise.calibrate_delta(
            lambda p, a: to_torch(logits), None, None, to_torch(y), rhos,
            targets, trials=trials, draws=draws)
        assert tbase == jbase
        assert got == want
