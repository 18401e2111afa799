"""The port's kernel plain versions against the JAX package: its pure-jnp
oracles (``repro.kernels.ref``) and its Pallas kernels run in interpret
mode, on the same NumPy inputs. The CUDA kernels themselves run only on
the card (``chip_smoke.py`` holds each against these plain versions).

Tolerances: f32 products summed in another order differ by a few ulp
of the row sum, so f32 outputs agree to 1e-4 (the reference's own
kernel tests use 2e-6 against a same-order oracle); bf16 and float8
caches round probabilities and values to bf16, so 2e-2 as in
tests/test_decode_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention
from repro.models.attention import \
    _blocked_causal_attention as jax_blocked_attention
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import _blocked_causal_attention
from tests._torch_parity import to_numpy, to_torch

TOL_F32 = 1e-4
TOL_BF16 = 2e-2


def _rng(seed=0):
    return np.random.default_rng(seed)


def _meta(rng, n, per_column):
    shape = (1, n) if per_column else (1, 1)
    scale = rng.uniform(0.005, 0.02, shape).astype(np.float32)
    mu = rng.uniform(-0.5, 0.0, shape).astype(np.float32)
    return scale, mu


class TestQMatmul:
    """qmatmul (int8 codes) and qmatmul4 (packed nibbles) plain versions
    == the reference oracle and the interpret-mode Pallas kernels, at a
    576-wide contraction no 512 tile divides."""

    @staticmethod
    def _case(packed, per_column):
        rng = _rng(1)
        m, k, n = 6, 576, 128
        x = rng.standard_normal((m, k)).astype(np.float32)
        codes = rng.integers(0, 16 if packed else 256, (k, n), np.uint8)
        scale, mu = _meta(rng, n, per_column)
        w = (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8) \
            if packed else codes
        t_fn = ref.qmatmul4_ref if packed else ref.qmatmul_ref
        got = to_numpy(t_fn(to_torch(x), to_torch(w), to_torch(scale),
                            to_torch(mu)))
        return x, w, scale, mu, got

    @pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
    @pytest.mark.parametrize("per_column", [False, True],
                             ids=["per_tensor", "per_column"])
    def test_plain_matches_reference(self, packed, per_column):
        x, w, scale, mu, got = self._case(packed, per_column)
        j_fn = jref.qmatmul4_ref if packed else jref.qmatmul_ref
        np.testing.assert_allclose(got, np.asarray(j_fn(x, w, scale, mu)),
                                   atol=TOL_F32, rtol=TOL_F32)

    @pytest.mark.parametrize("packed,per_column", [(False, True),
                                                   (True, False)],
                             ids=["int8_per_column", "int4_per_tensor"])
    def test_plain_matches_pallas(self, packed, per_column, monkeypatch):
        """The interpret-mode Pallas kernels, through the reference's
        qdense (which picks tiles dividing K = 576)."""
        x, w, scale, mu, got = self._case(packed, per_column)
        key = "codes_packed" if packed else "codes"
        monkeypatch.setenv("REPRO_KERNELS", "interpret")
        pallas = np.asarray(jops.qdense(
            jnp.asarray(x), {key: w, "scale": scale, "mu": mu}))
        np.testing.assert_allclose(got, pallas, atol=TOL_F32, rtol=TOL_F32)

    def test_qdense_layouts(self, monkeypatch):
        """Trailing-axis peeling and the ``_meta2d`` layout: a 3-D QKV
        output and a 2-axis output-projection contraction with
        per-head-dim metadata, through both packages' qdense."""
        monkeypatch.setenv("REPRO_KERNELS", "reference")
        rng = _rng(2)
        x = rng.standard_normal((2, 3, 64)).astype(np.float32)
        wq = {"codes": rng.integers(0, 256, (64, 4, 16), np.uint8),
              "scale": rng.uniform(0.01, 0.02, (1, 1, 16)).astype(np.float32),
              "mu": rng.uniform(-1, 0, (1, 1, 16)).astype(np.float32)}
        out = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
        wo = {"codes_packed": rng.integers(0, 256, (4, 16, 32), np.uint8),
              "scale": np.float32(0.01).reshape(1, 1, 1),
              "mu": np.float32(-0.1).reshape(1, 1, 1)}
        for a, w, nc in ((x, wq, 1), (out, wo, 2)):
            tw = {k: to_torch(v) for k, v in w.items()}
            got = to_numpy(ops.qdense(to_torch(a), tw, n_contract=nc))
            want = np.asarray(jops.qdense(jnp.asarray(a), w, n_contract=nc))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=TOL_F32, rtol=TOL_F32)


class TestDecodeAttention:
    """One-query ring-buffer attention: f32, bf16 and float8 caches, on a
    partially filled ring and on a wrapped one, GQA groups of 4."""

    B, KVP, GP, BUF, HD = 2, 2, 4, 64, 64

    def _inputs(self, cache_dtype):
        rng = _rng(3)
        q = rng.standard_normal((self.B, self.KVP, self.GP, self.HD))
        kv = rng.standard_normal((2, self.B, self.BUF, self.KVP, self.HD))
        ck = jnp.asarray(kv[0], jnp.float32).astype(cache_dtype)
        cv = jnp.asarray(kv[1], jnp.float32).astype(cache_dtype)
        return jnp.asarray(q, jnp.float32), ck, cv

    @pytest.mark.parametrize("cache_dtype,tol", [
        (jnp.float32, TOL_F32), (jnp.bfloat16, TOL_BF16),
        (jnp.float8_e4m3fn, TOL_BF16)], ids=["f32", "bf16", "float8"])
    @pytest.mark.parametrize("pos", [5, 100], ids=["partial", "wrapped"])
    def test_plain_matches_reference(self, cache_dtype, tol, pos):
        q, ck, cv = self._inputs(cache_dtype)
        got = to_numpy(ops.decode_attention(to_torch(q), to_torch(ck),
                                            to_torch(cv), pos))
        want = np.asarray(jref.decode_attention_ref(q, ck, cv, pos))
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)

    def test_plain_matches_pallas(self):
        """The interpret-mode Pallas kernel on a wrapped float8 ring, two
        cache blocks."""
        q, ck, cv = self._inputs(jnp.float8_e4m3fn)
        got = to_numpy(ops.decode_attention(to_torch(q), to_torch(ck),
                                            to_torch(cv), 100))
        pallas = np.asarray(decode_attention_pallas(q, ck, cv, 100,
                                                    block_k=32,
                                                    interpret=True))
        np.testing.assert_allclose(got, pallas, atol=TOL_BF16,
                                   rtol=TOL_BF16)


class TestDecodeAttentionShard:
    """The ring-shard decode attention's plain version
    (``decode_attention_shard_ref``, the yardstick the card holds the
    tensor-core shard kernel to) at chatglm3-6b's head shape (KVp 2, Gp
    16, hd 128), B 2, over a 64-slot ring in four 16-slot shards: the
    shards' outputs merged by their log-sum-exp
    (``models.attention.combine_shards``) against the reference's
    decode attention over the whole ring, before, at and after the wrap,
    on bf16 and float8 caches with an f32 query. Both sides compute in
    the query's f32 and differ only in sum order and the merge's
    reweighting, so TOL_F32; the merged lse is held to a float64
    log-sum-exp of the ring's live scores to the same tolerance."""

    B, KVP, GP, HD, RING, SHARD = 2, 2, 16, 128, 64, 16

    def _inputs(self, cache_dtype):
        rng = _rng(11)
        q = rng.standard_normal((self.B, self.KVP, self.GP, self.HD))
        kv = rng.standard_normal((2, self.B, self.RING, self.KVP, self.HD))
        ck = jnp.asarray(kv[0], jnp.float32).astype(cache_dtype)
        cv = jnp.asarray(kv[1], jnp.float32).astype(cache_dtype)
        return jnp.asarray(q, jnp.float32), ck, cv

    def _merged(self, q, ck, cv, pos):
        from repro_torch.models.attention import combine_shards
        tq, tk, tv = to_torch(q), to_torch(ck), to_torch(cv)
        parts = [ref.decode_attention_shard_ref(
            tq, tk[:, s:s + self.SHARD].contiguous(),
            tv[:, s:s + self.SHARD].contiguous(), pos, s, self.RING)
            for s in range(0, self.RING, self.SHARD)]
        lses = torch.stack([p[1] for p in parts])
        out = combine_shards(torch.stack([p[0] for p in parts]), lses)
        return to_numpy(out), to_numpy(torch.logsumexp(lses, dim=0))

    @pytest.mark.parametrize("cache_dtype", [jnp.bfloat16, jnp.float8_e4m3fn],
                             ids=["bf16", "float8"])
    @pytest.mark.parametrize("pos", [5, 16, 40, 63, 85, 199])
    def test_merged_shards_match_reference(self, cache_dtype, pos):
        q, ck, cv = self._inputs(cache_dtype)
        got, lse = self._merged(q, ck, cv, pos)
        want = np.asarray(jref.decode_attention_ref(q, ck, cv, pos))
        np.testing.assert_allclose(got, want, atol=TOL_F32, rtol=TOL_F32)
        k64 = np.asarray(ck.astype(jnp.float32), np.float64)
        sc = np.einsum("bkgd,bskd->bkgs", np.asarray(q, np.float64), k64) \
            * self.HD ** -0.5
        live = (pos + 1 >= self.RING) | (np.arange(self.RING) <= pos % self.RING)
        sc = np.where(live, sc, -np.inf)
        top = sc.max(-1)
        want_lse = top + np.log(np.exp(sc - top[..., None]).sum(-1))
        np.testing.assert_allclose(lse, want_lse, atol=TOL_F32, rtol=TOL_F32)

    @pytest.mark.parametrize("cache_dtype", [jnp.bfloat16, jnp.float8_e4m3fn],
                             ids=["bf16", "float8"])
    def test_merged_shards_match_pallas(self, cache_dtype):
        """The interpret-mode Pallas kernel on the wrapped ring, two cache
        blocks."""
        q, ck, cv = self._inputs(cache_dtype)
        got, _ = self._merged(q, ck, cv, 85)
        pallas = np.asarray(decode_attention_pallas(q, ck, cv, 85,
                                                    block_k=32,
                                                    interpret=True))
        np.testing.assert_allclose(got, pallas, atol=TOL_F32, rtol=TOL_F32)


class TestFlashAttention:
    """Causal GQA attention: the port's blocked plain version == the
    reference's blocked version and its interpret-mode flash kernel."""

    @staticmethod
    def _case(block):
        rng = _rng(4)
        b, s, kv, g, hd = 1, 32, 2, 2, 64
        q = rng.standard_normal((b, s, kv, g, hd)).astype(np.float32)
        k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
        v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
        got = to_numpy(_blocked_causal_attention(
            to_torch(q), to_torch(k), to_torch(v), block, block))
        return q, k, v, got

    @pytest.mark.parametrize("block", [32, 8], ids=["one_block", "4x4"])
    def test_plain_matches_reference(self, block):
        q, k, v, got = self._case(block)
        want = np.asarray(jax_blocked_attention(q, k, v, block, block))
        np.testing.assert_allclose(got, want, atol=TOL_F32, rtol=TOL_F32)

    def test_plain_matches_pallas(self):
        """The interpret-mode Pallas kernel with 2 x 2 causal blocks (the
        fully masked one skipped)."""
        q, k, v, got = self._case(8)
        pallas = np.asarray(flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=16,
            block_k=16, interpret=True))
        np.testing.assert_allclose(got, pallas, atol=TOL_F32, rtol=TOL_F32)

    def test_dispatch_on_cpu_is_the_plain_version(self):
        rng = _rng(5)
        q = to_torch(rng.standard_normal((1, 16, 1, 2, 64)).astype(np.float32))
        k = to_torch(rng.standard_normal((1, 16, 1, 64)).astype(np.float32))
        v = to_torch(rng.standard_normal((1, 16, 1, 64)).astype(np.float32))
        assert (ops.flash_attention(q, k, v, 8, 8)
                == _blocked_causal_attention(q, k, v, 8, 8)).all()


class TestFlashAttentionBackward:
    """The plain versions the backward kernel and the forward's row
    log-sum-exp are held to on the card: against ``jax.vjp`` of the
    reference's ``_blocked_causal_attention`` (the function XLA
    differentiates for the reference's training), against torch
    autograd of the port's, and against finite differences in float64.
    f32 gradients agree to 1e-4 of their largest magnitude (sums in
    another order); bf16 ones to one bf16 step of it (2^-7: autograd
    of the plain version also rounds dP and the gradients to bf16)."""

    @staticmethod
    def _case(dtype=np.float32, s=24, kv=2, g=3, hd=64, seed=8):
        rng = _rng(seed)
        q = rng.standard_normal((2, s, kv, g, hd)).astype(dtype)
        k = rng.standard_normal((2, s, kv, hd)).astype(dtype)
        v = rng.standard_normal((2, s, kv, hd)).astype(dtype)
        do = rng.standard_normal((2, s, kv, g, hd)).astype(dtype)
        return q, k, v, do

    @staticmethod
    def _plain_bwd(q, k, v, do):
        tq, tk, tv, tdo = (to_torch(a) for a in (q, k, v, do))
        out = _blocked_causal_attention(tq, tk, tv, 8, 8)
        lse = ref.flash_attention_lse_ref(tq, tk)
        return lse, ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo)

    @staticmethod
    def _close(got, want, tol):
        got, want = to_numpy(got), np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= tol * np.abs(want).max()

    def test_lse_matches_float64(self):
        q, k, _, _ = self._case()
        lse, _ = self._plain_bwd(*self._case())
        sc = np.einsum("bqkgd,bskd->bkgqs", q.astype(np.float64),
                       k.astype(np.float64)) * q.shape[-1] ** -0.5
        s = q.shape[1]
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
        m = sc.max(-1, keepdims=True)
        want = (m + np.log(np.exp(sc - m).sum(-1, keepdims=True)))[..., 0]
        np.testing.assert_allclose(to_numpy(lse), want.transpose(0, 3, 1, 2),
                                   atol=1e-5, rtol=1e-6)

    def test_bwd_matches_reference_vjp(self):
        q, k, v, do = self._case()
        _, grads = self._plain_bwd(q, k, v, do)
        _, vjp = jax.vjp(lambda a, b, c: jax_blocked_attention(a, b, c, 8, 8),
                         q, k, v)
        for got, want in zip(grads, vjp(jnp.asarray(do))):
            self._close(got, want, TOL_F32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bwd_matches_port_autograd(self, dtype):
        tdt = getattr(torch, dtype)
        q, k, v, do = (to_torch(a).to(tdt) for a in self._case(s=40))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = _blocked_causal_attention(*leaves, 8, 8)
        want = torch.autograd.grad(out, leaves, do)
        got = ref.flash_attention_bwd_ref(
            q, k, v, out.detach(), ref.flash_attention_lse_ref(q, k), do)
        tol = TOL_F32 if dtype == "float32" else 2 ** -7
        for g, w in zip(got, want):
            assert g.dtype == tdt
            self._close(g, to_numpy(w), tol)

    def test_bwd_gradcheck_float64(self):
        """Causal attention written out in float64, its backward the plain
        one: torch.autograd.gradcheck against finite differences."""
        class Attn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v):
                lse = ref.flash_attention_lse_ref(q, k)
                sc = torch.einsum("bqkgd,bskd->bkgqs", q, k) * \
                    q.shape[-1] ** -0.5
                s = q.shape[1]
                mask = torch.tril(torch.ones(s, s, dtype=torch.bool))
                p = torch.where(mask, torch.exp(
                    sc - lse.permute(0, 2, 3, 1)[..., None]), 0.0)
                out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
                ctx.save_for_backward(q, k, v, out, lse)
                return out

            @staticmethod
            def backward(ctx, d_out):
                return ref.flash_attention_bwd_ref(*ctx.saved_tensors, d_out)

        rng = _rng(9)
        args = [torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
                for shape in ((1, 5, 2, 2, 4), (1, 5, 2, 4), (1, 5, 2, 4))]
        assert torch.autograd.gradcheck(Attn.apply, args, eps=1e-6,
                                        atol=1e-7, rtol=1e-5)

    @staticmethod
    def _written_out(q, k, v, out, lse, do, round_ds):
        """The gradient in the compute dtype step by step, dS rounded to
        the input dtype before dQ / dK only when ``round_ds``."""
        ct = torch.float64 if q.dtype == torch.float64 else torch.float32
        s, hd = q.shape[1], q.shape[-1]
        sc = torch.einsum("bqkgd,bskd->bkgqs", q.to(ct), k.to(ct)) \
            * hd ** -0.5
        mask = torch.tril(torch.ones(s, s, dtype=torch.bool))
        p = torch.where(mask, torch.exp(
            sc - lse.to(ct).permute(0, 2, 3, 1)[..., None]),
            torch.zeros_like(sc))
        dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(v.dtype).to(ct),
                          do.to(ct))
        dp = torch.einsum("bqkgd,bskd->bkgqs", do.to(ct), v.to(ct))
        delta = (do.to(ct) * out.to(ct)).sum(-1).permute(0, 2, 3, 1)
        ds = p * (dp - delta[..., None])
        if round_ds:
            ds = ds.to(q.dtype).to(ct)
        dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(ct)) * hd ** -0.5
        dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.to(ct)) * hd ** -0.5
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

    def _plain_inputs(self, tdt):
        q, k, v, do = (to_torch(a).to(tdt) for a in self._case(s=40))
        out = _blocked_causal_attention(q, k, v, 8, 8)
        return q, k, v, out, ref.flash_attention_lse_ref(q, k), do

    def test_bwd_bf16_rounds_ds_before_dq_dk(self):
        """For bf16 inputs the plain dq and dk are the products of dS
        rounded to bf16 (as the tensor-core kernels take it), bit for bit,
        and differ from those of the unrounded dS; dv does not take dS."""
        args = self._plain_inputs(torch.bfloat16)
        got = ref.flash_attention_bwd_ref(*args)
        rounded = self._written_out(*args, round_ds=True)
        unrounded = self._written_out(*args, round_ds=False)
        assert all(torch.equal(g, w) for g, w in zip(got, rounded))
        assert not torch.equal(got[0], unrounded[0])
        assert not torch.equal(got[1], unrounded[1])
        assert torch.equal(got[2], unrounded[2])

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_bwd_wide_dtypes_keep_ds_unrounded(self, dtype):
        """For float32 and float64 the plain backward is bit for bit the
        gradient with dS unrounded: the bf16 rounding leaves them as they
        were."""
        args = self._plain_inputs(getattr(torch, dtype))
        got = ref.flash_attention_bwd_ref(*args)
        want = self._written_out(*args, round_ds=False)
        assert all(torch.equal(g, w) for g, w in zip(got, want))

    def test_padded_head_and_future_rows_get_no_gradient(self):
        """A head whose output gradient is zero (a padded head after the
        model's mask) gets exactly zero dq, and the last key, seen only by
        the last row, exactly zero dk/dv once that row's gradient is 0."""
        q, k, v, do = self._case()
        do[:, :, :, 2] = 0.0
        do[:, -1] = 0.0
        _, (dq, dk, dv) = self._plain_bwd(q, k, v, do)
        assert (dq[:, :, :, 2] == 0).all()
        assert (dk[:, -1] == 0).all() and (dv[:, -1] == 0).all()
        assert dq.abs().amax() > 0 and dk.abs().amax() > 0


class TestPackingOracles:
    """Integer oracles match bit for bit."""

    def test_quantize_pack_unpack(self):
        rng = _rng(6)
        x = rng.standard_normal((8, 32)).astype(np.float32)
        scale, mu = np.float32(0.25), np.float32(-2.0)
        for bits in (4, 8):
            np.testing.assert_array_equal(
                to_numpy(ref.quantize_ref(to_torch(x), scale, mu, bits)),
                np.asarray(jref.quantize_ref(x, scale, mu, bits)))
        np.testing.assert_array_equal(
            to_numpy(ref.quantize_pack4_ref(to_torch(x), scale, mu)),
            np.asarray(jref.quantize_pack4_ref(x, scale, mu)))
        packed = rng.integers(0, 256, (4, 8), np.uint8)
        np.testing.assert_array_equal(
            to_numpy(ref.unpack_int4_ref(to_torch(packed))),
            np.asarray(jref.unpack_int4_ref(jnp.asarray(packed))))
        codes = rng.integers(0, 256, (4, 8), np.uint8)
        np.testing.assert_allclose(
            to_numpy(ref.dequantize_ref(to_torch(codes), 0.5, 1.0,
                                        dtype=to_torch(x).dtype)),
            np.asarray(jref.dequantize_ref(codes, 0.5, 1.0, jnp.float32)))

