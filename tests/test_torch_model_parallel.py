"""The serving steps' rank program over the model axis
(``launch.model_parallel``, ``launch.sharding.shard_tree``): two spawned
``gloo`` ranks of a (1, 2) mesh, each holding its shards of the weights
and caches as ``param_pspecs`` / ``cache_pspecs`` lay them out, run the
prefill and eight greedy decode steps; their all-gathered logits are
held to the reference's unsharded ``T.prefill`` / ``T.decode_step`` on
the same NumPy weights and prompt (f32 caches, so that no bf16 rounding
boundary amplifies a reordered sum, as ``tests/test_torch_launch.py``
compares them), and their greedy tokens must equal the reference's,
those of ``generate`` (bf16 caches) included. Cases, one of each route:

* ``dense`` — the 4-layer smollm-8m padded to 2 x 8 heads and a 256-slot
  vocab (``tp_pad=16``): KV heads split (``kv_sharded``), masked padded
  heads and vocab columns at each rank's offsets; at ``--quant`` 8 and 4
  too (int4 codes split on their packed columns, per-column grids cut to
  each rank's columns); ``dense_bf16`` the same in bf16 activations, where
  the ranks take the row-parallel products' partial sums in f32 and round
  once after summing them, as the reference's program does;
* ``seq`` — a 2-layer config with one KV head: the ring split on its
  slots, the ring-shard decode attention's plain version and the ranks'
  log-sum-exp merge; ``rep`` the same at an odd ring (held whole by each
  rank); ``window`` the same under an 8-token sliding window, the ring
  written whole by the prompt and wrapped by the steps;
* ``olmoe`` — reduced OLMoE, expert-parallel (2 of 4 experts a rank);
* ``mamba2`` — reduced Mamba2 (8 of 16 heads a rank, the replicated
  conv ring's x channels gathered);
* ``jamba`` — reduced Jamba: SSD, attention and expert-parallel MoE.

Tolerance: 1e-4 (atol and rtol), the parity tests' own for f32 products
summed in another order (``tests/test_torch_launch.py``); the ranks'
partial sums of the row-parallel projections and the shards' merge are
that reordering. ``dense_bf16``: 2e-2 (atol and rtol), bf16's rounding
step at the logits' size (the one-card program is as far from the
reference there: its bf16 ops round in other places); its decode steps
take seeded tokens on both sides, not their own greedy ones, since a
bf16 step of the reference can hold an exact tie for the largest logit
(this prompt's third greedy step does), which the one-card program
breaks the other way too. Its greedy tokens, the steps' and
``generate``'s, are held to the one-card program's instead, and its
logits to those within the same 2e-2. The caches of a prefill at
``cache_dtype=float32`` are held, shard for shard, to the reference's
whole caches cut by ``shard_tree`` at the same tolerance (bf16: 2e-2 of
each leaf's largest value). Bitwise: an axis of size 1 against
no axis (prefill, decode steps, caches), the two ranks' gathered logits
and tokens, and ``launch.serve.generate``'s tokens against the rank
loop's.

One spawn of two ranks carries every case (module fixture, about 3 s of
process start-up); the reference runs meanwhile."""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core.quantizer import \
    quantize_params_for_serving as jax_quantize_params
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.base import get_config as torch_get_config
from repro_torch.launch import distributed
from repro_torch.launch import model_parallel as mp
from repro_torch.launch import sharding as tshard
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import coords, make_mesh, make_production_mesh
from repro_torch.kernels import ref as kref
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves
import _torch_model_parallel_ranks as ranks
from _torch_parity import lm_configs, lm_weights, zoo_configs

TOL = 1e-4
BF16_TOL = 2e-2
B, S, STEPS = 2, 12, 8
MAX_LEN = S + STEPS + 1


def _bf16(configs):
    """(jax cfg, torch cfg) in bf16 activations."""
    return tuple(dataclasses.replace(c, dtype="bfloat16") for c in configs)


def _one_kv(**kw):
    """A 2-layer f32 config with one KV head of four queries, as (jax cfg,
    torch cfg)."""
    kw = dict(name="smollm-mqa", num_layers=2, d_model=128, num_heads=4,
              num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=256,
              tp_pad=1, dtype="float32", **kw)
    return tuple(dataclasses.replace(get("smollm-135m"), **kw)
                 for get in (jax_get_config, torch_get_config))


# case -> ((jax cfg, torch cfg), int-N bits, max_len)
CASES = {"dense": (lm_configs(tp_pad=16), 0, MAX_LEN),
         "dense_q8": (lm_configs(tp_pad=16), 8, MAX_LEN),
         "dense_q4": (lm_configs(tp_pad=16), 4, MAX_LEN),
         "dense_bf16": (_bf16(lm_configs(tp_pad=16)), 0, MAX_LEN),
         "seq": (_one_kv(), 0, MAX_LEN + 1),
         "rep": (_one_kv(), 0, MAX_LEN),
         "window": (_one_kv(sliding_window=8), 0, MAX_LEN),
         "olmoe": (zoo_configs("olmoe-1b-7b"), 0, MAX_LEN),
         "mamba2": (zoo_configs("mamba2-1.3b"), 0, MAX_LEN),
         "jamba": (zoo_configs("jamba-v0.1-52b"), 0, MAX_LEN)}


def _reference(jcfg, tree, quant, prompt, max_len, forced=None):
    """The reference's prefill at ``cache_dtype=float32``: its logits,
    its caches, the logits of STEPS greedy decode steps from them (fed
    ``forced``'s tokens where given) and their tokens; and its
    ``generate``'s greedy tokens (bf16 caches)."""
    params = jax.tree.map(jnp.asarray, tree)
    if quant:
        params = jax_quantize_params(params, quant)
    p = jnp.asarray(prompt)
    logits, caches, _ = JT.prefill(params, jcfg, p, max_len=max_len,
                                   cache_dtype=jnp.float32)
    rec = {"prefill": np.asarray(logits, np.float32), "steps": [],
           "caches": jax.tree.map(np.asarray, caches),
           "generate": np.asarray(jserve.generate(params, jcfg, p,
                                                  max_len=max_len,
                                                  gen=STEPS + 1))}
    step = jax.jit(lambda prm, t, c, pos: JT.decode_step(prm, jcfg, t, c,
                                                         pos))
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    toks = [tok]
    for i in range(STEPS):
        if forced is not None:
            tok = jnp.asarray(forced[:, i:i + 1])
        logits, caches = step(params, tok, caches, jnp.int32(S + i))
        rec["steps"].append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(tok)
    rec["tokens"] = np.asarray(jnp.concatenate(toks, 1))
    return rec


@pytest.fixture(scope="module")
def runs():
    """(the reference's runs, the two ranks' runs, the cases, the one-card
    program's runs of the bf16 cases), by case."""
    rng = np.random.default_rng(0)
    cases, port = {}, {}
    for name, ((jcfg, tcfg), quant, max_len) in CASES.items():
        tree = lm_weights(tcfg, seed=len(cases))
        prompt = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
        forced = rng.integers(0, tcfg.vocab_size, (B, STEPS)).astype(
            np.int32) if name.endswith("_bf16") else None
        cases[name] = (jcfg, tree, quant, prompt, max_len, forced)
        port[name] = (tcfg, tree, quant, prompt, max_len, STEPS, forced)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(distributed.spawn, ranks.run_cases, 2, "cpu",
                              port)
        ref = {k: _reference(*c) for k, c in cases.items()}
        two = spawned.result(timeout=600)
    one = ranks.run_cases(0, 1, None, {k: c for k, c in port.items()
                                       if k.endswith("_bf16")})
    return ref, two, port, one


def _tol(case: str) -> float:
    return BF16_TOL if case.endswith("_bf16") else TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_program_matches_the_reference(runs, case):
    """The gathered prefill logits and each decode step's to 1e-4 (bf16:
    2e-2), the greedy tokens equal (the rank loop's, from f32 caches, and
    ``generate``'s, from bf16 ones; bf16: the one-card program's), both
    ranks the same bits."""
    ref, two, _, one = runs
    got, want = two[0][case], ref[case]
    tol = _tol(case)
    if case in one:                   # bf16: tokens and logits as one card's
        twin = one[case]
        for key in ("prefill", "steps"):
            np.testing.assert_allclose(np.asarray(got[key]),
                                       np.asarray(twin[key]), atol=tol,
                                       rtol=tol, err_msg=key)
        want = {**want, "tokens": twin["tokens"],
                "generate": twin["generate"]}
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=tol,
                               rtol=tol)
    assert len(got["steps"]) == STEPS
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                   err_msg=f"step {i}")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["generate"], want["generate"])
    other = two[1][case]
    for key in ("prefill", "tokens", "generate"):
        np.testing.assert_array_equal(other[key], got[key])
    for g, o in zip(got["steps"], other["steps"]):
        np.testing.assert_array_equal(o, g)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_caches_are_the_references_shards(runs, case):
    """Each rank's caches after an f32-cache prefill are its shard of the
    reference's (``cache_pspecs`` cut by ``shard_tree``): KV heads, ring
    slots (the prompt's roll included), or the whole ring; SSM states by
    head, the conv ring whole. bf16: within 2e-2 of each leaf's largest
    value (bf16 K/V, rounded at that size, stored in f32)."""
    ref, two, port, _ = runs
    tcfg = port[case][0]
    mesh = make_mesh(1, 2)
    whole = ref[case]["caches"]
    specs = tshard.cache_pspecs(tcfg, whole, mesh, B)
    for rank in (0, 1):
        want = tshard.shard_tree(whole, specs, mesh, coords(mesh, rank))
        got = two[rank][case]["caches"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                assert g[k].shape == w[k].shape, k
                scale = max(1.0, float(np.abs(w[k]).max())) \
                    if case.endswith("_bf16") else 1.0
                np.testing.assert_allclose(g[k], w[k],
                                           atol=_tol(case) * scale,
                                           rtol=_tol(case), err_msg=k)


def _decode(cfg, params, prompt, axis, steps=3):
    """Prefill and ``steps`` decode steps at ``axis`` -> logits and caches
    as a flat list of tensors."""
    logits, caches, _ = TT.prefill(params, cfg, prompt, max_len=MAX_LEN,
                                   axis=axis)
    out = [logits]
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    for i in range(steps):
        logits, caches = TT.decode_step(params, cfg, tok, caches, S + i,
                                        axis=mp.with_len(axis, MAX_LEN))
        out.append(logits)
        tok = torch.argmax(logits, -1).to(torch.int32)
    return out + tree_leaves(caches)


@pytest.mark.parametrize("case", ["dense", "dense_q4", "dense_bf16", "seq",
                                  "olmoe", "mamba2", "jamba"])
def test_axis_of_one_is_bitwise_no_axis(case):
    """An axis of size 1 computes what the program without one computes,
    bit for bit: no collective, no slice, the one-card route."""
    (_, tcfg), quant, _ = CASES[case]
    params = ranks.served_params(tcfg, lm_weights(tcfg), quant)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32))
    axis = mp.ModelAxis(0, 1, None)
    for a, b in zip(_decode(tcfg, params, prompt, axis),
                    _decode(tcfg, params, prompt, None), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _split_dim(spec):
    """The one dimension a (1, m) mesh's spec splits, or None."""
    dims = [i for i, e in enumerate(spec) if e is not None]
    assert len(dims) <= 1, spec
    return dims[0] if dims else None


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("quant", [0, 8, 4], ids=["q0", "q8", "q4"])
def test_shard_tree_round_trips(quant, m):
    """The m ranks' shards, concatenated along the dimension their spec
    splits, are the whole tree bit for bit (int4 bytes included); an int4
    shard's bytes unpack to its block of the whole weight's code columns,
    and a column-split leaf's per-column grid, cut to the rank's columns
    (``transformer._local_meta``), dequantizes the shard to the whole
    weight's column block."""
    tcfg = lm_configs(tp_pad=16)[1]
    full = ranks.served_params(tcfg, lm_weights(tcfg), quant)
    mesh = make_mesh(1, m)
    specs = tshard.param_pspecs(tcfg, full, mesh=mesh)
    parts = [tshard.shard_tree(full, specs, mesh, coords(mesh, r))
             for r in range(m)]
    for i, (w, spec) in enumerate(tshard._pairs(full, specs)):
        d = _split_dim(spec)
        got = [tree_leaves(p)[i] for p in parts]
        back = got[0] if d is None else torch.cat(got, dim=d)
        assert back.dtype == w.dtype and torch.equal(back, w), i
    if not quant:
        return
    for r, part in enumerate(parts):
        for key in ("w_gate", "w_up"):                  # split on columns
            node = full["blocks"][0]["mlp"][key]
            local = TT._local_meta(part["blocks"][0]["mlp"][key],
                                   mp.ModelAxis(r, m))
            packed = "codes_packed" in local
            n = local["codes_packed" if packed else "codes"].shape[-1] * \
                (2 if packed else 1)
            cols = slice(r * n, (r + 1) * n)
            for k in ("scale", "mu"):
                assert torch.equal(local[k], node[k][..., cols])
            if packed:
                assert torch.equal(
                    kref.unpack_int4_ref(local["codes_packed"]),
                    kref.unpack_int4_ref(node["codes_packed"])[..., cols])
            assert torch.equal(TT._dequant_block({"x": local}, tcfg)["x"],
                               TT._dequant_block({"x": node}, tcfg)["x"][
                                   ..., cols])


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@pytest.mark.parametrize("quant", [0, 4], ids=["q0", "q4"])
@pytest.mark.parametrize("m", [2, 4])
def test_local_bytes_are_per_card_bytes(quant, m):
    """A rank's shards of the weights and of the prefill's caches hold
    exactly the bytes ``per_card_bytes`` gives for the tree and its
    specs."""
    tcfg = lm_configs(tp_pad=16)[1]
    full = ranks.served_params(tcfg, lm_weights(tcfg), quant)
    mesh = make_mesh(1, m)
    specs = tshard.param_pspecs(tcfg, full, mesh=mesh)
    caches = TT.init_cache(tcfg, B, MAX_LEN, device="cpu")
    c_specs = tshard.cache_pspecs(tcfg, caches, mesh, B)
    for r in range(m):
        at = coords(mesh, r)
        for tree, sp in ((full, specs), (caches, c_specs)):
            assert _bytes(tshard.shard_tree(tree, sp, mesh, at)) == \
                tshard.per_card_bytes(tree, sp, mesh)
        local = TT.init_cache(tcfg, B, MAX_LEN, device="cpu",
                              axis=mp.ModelAxis(r, m, None, MAX_LEN))
        assert [t.shape for t in tree_leaves(local)] == [
            t.shape for t in tree_leaves(
                tshard.shard_tree(caches, c_specs, mesh, at))]


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b",
                                  "mamba2-1.3b", "chatglm3-6b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
def test_rank_fakes_are_per_card_bytes(arch, multi_pod):
    """On both production meshes, rank 0's fake prefill and decode
    arguments (``build_step(mesh=)``, int4 serving weights) hold exactly
    the bytes ``per_card_bytes`` gives for the whole arguments, and their
    shapes are ``local_shape`` of the whole ones."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    for shape in ("prefill_32k", "decode_32k"):
        spec = tsteps.build_step(torch_get_config(arch), INPUT_SHAPES[shape],
                                 serve_quant=4, mesh=mesh)
        assert _bytes(spec.args) == tshard.per_card_bytes(
            spec.global_args, spec.specs, mesh)
        assert [tuple(t.shape) for t in tree_leaves(spec.args)] == [
            tshard.local_shape(t, sp, mesh) for t, sp in tshard._pairs(
                spec.global_args, spec.specs)]


def test_mesh_coords_and_axis():
    """``coords`` numbers ranks row-major, the model axis fastest; a
    mesh whose model axis is 1 gives an axis of size 1, whose
    collectives return their input."""
    mesh = make_mesh(2, 4)
    assert [coords(mesh, r) for r in (0, 3, 4, 7)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 3},
        {"data": 1, "model": 0}, {"data": 1, "model": 3}]
    assert coords(make_production_mesh(multi_pod=True), 511) == {
        "pod": 1, "data": 15, "model": 15}
    with pytest.raises(ValueError):
        coords(mesh, 8)
    assert mp.make_axis(make_mesh(4, 1), 2).size == 1
    x = torch.arange(6.0)
    assert mp.all_reduce(x, None) is x and mp.all_gather(x, None) is x
    assert mp.all_reduce(x, mp.ModelAxis(0, 1)) is x


def test_model_axis_subgroups_by_data_index():
    """On a (2, 2) mesh of four ranks each model axis is the subgroup of
    its data index: ranks 0 and 1 sum and gather among themselves, ranks
    2 and 3 among themselves."""
    got = distributed.spawn(ranks.data_rows, 4, "cpu")
    assert got == [(0, 2, 3.0, [1.0, 2.0]), (1, 2, 3.0, [1.0, 2.0]),
                   (0, 2, 7.0, [3.0, 4.0]), (1, 2, 7.0, [3.0, 4.0])]


def test_distributed_argmax_breaks_ties_low():
    """``model_parallel.argmax`` over two ranks' vocab blocks is
    ``torch.argmax`` of the whole row, a tie (across ranks and within
    one) going to the lowest index."""
    rows = np.zeros((3, 1, 8), np.float32)
    rows[0, 0, [2, 6]] = 5.0          # tie across the ranks
    rows[1, 0, [5, 7]] = 3.0          # tie inside rank 1
    rows[2, 0, 4] = 1.0
    out = distributed.spawn(ranks.argmax_ties, 2, "cpu", rows)
    want = torch.argmax(torch.from_numpy(rows), -1).numpy()
    np.testing.assert_array_equal(want, [[2], [5], [4]])
    for got in out:
        np.testing.assert_array_equal(got, want)


def test_ring_shard_reference_merges_to_the_whole_ring():
    """``decode_attention_shard_ref`` on the shards of a ring, merged by
    their log-sum-exp (``attention.combine_shards``), is
    ``decode_attention_ref`` on the whole ring, before and after it
    wraps; a shard with no live slot gives zeros and -inf."""
    from repro_torch.models.attention import combine_shards
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 3, 32, generator=g)
    k = torch.randn(2, 16, 2, 32, generator=g)
    v = torch.randn(2, 16, 2, 32, generator=g)
    for pos in (0, 5, 15, 23):
        for m in (2, 4):
            n = 16 // m
            parts = [kref.decode_attention_shard_ref(
                q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], pos,
                r * n, 16) for r in range(m)]
            merged = combine_shards(torch.stack([p[0] for p in parts]),
                                    torch.stack([p[1] for p in parts]))
            torch.testing.assert_close(
                merged, kref.decode_attention_ref(q, k, v, pos),
                atol=1e-5, rtol=1e-5)
    out, lse = kref.decode_attention_shard_ref(q, k[:, 8:], v[:, 8:], 3, 8,
                                               16)
    assert torch.all(out == 0) and torch.all(lse == -torch.inf)
