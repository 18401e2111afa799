"""The port's mesh, sharding rules and step spec builders
(``repro_torch.launch.{mesh,sharding,steps}``) against the reference's,
on the CPU: every leaf's partition spec exactly equal to the reference's
``param_pspecs`` / ``opt_pspecs`` / ``cache_pspecs`` / ``batch_pspecs``
for the ten assigned archs at full width (fsdp off and on, unquantized
and int8 / int4 serving structs), the spec builders' fake trees shape
for shape and dtype for dtype against the reference's
``jax.eval_shape`` trees, and ``per_card_bytes`` against the same sum
over the reference's specs. The meshes are plain descriptions that both
packages read (the reference test's ``FakeMesh`` and the port's
production meshes): no device mesh is made and nothing is compiled."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensor

from repro.configs.base import (ASSIGNED_ARCHS, INPUT_SHAPES, for_shape,
                                get_config)
from repro.core.quantizer import quantize_params_for_serving as j_quantize
from repro.launch import sharding as j_shard
from repro.launch import steps as j_steps
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_shard
from repro_torch.launch import steps as t_steps
from test_sharding import FakeMesh
# the parity helpers cap torch's threads at this worker's share
import tests._torch_parity  # noqa: F401

POD = t_mesh.make_production_mesh(multi_pod=True)
MESHES = {"fake16x16": FakeMesh(), "pod2x16x16": POD}
QUANTS = (0, 8, 4)


def _key(entry) -> str:
    return str(entry.key if hasattr(entry, "key") else entry.idx)


def _ref_leaves(tree, is_spec=False) -> dict:
    """{path: leaf} of a reference tree (PartitionSpecs as tuples)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=(lambda x: isinstance(x, P)) if is_spec else None)
    return {"/".join(_key(e) for e in path):
            tuple(leaf) if is_spec else leaf for path, leaf in leaves}


def _port_leaves(tree, is_spec=False, path=()) -> dict:
    """{path: leaf} of a port tree (dicts and lists; a spec tree's
    tuples are leaves)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list) or (isinstance(tree, tuple) and not is_spec):
        items = enumerate(tree)
    else:
        return {"/".join(path): tree}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, is_spec, path + (str(k),)))
    return out


def _same_structs(port_tree, ref_tree):
    port, ref = _port_leaves(port_tree), _ref_leaves(ref_tree)
    assert sorted(port) == sorted(ref)
    for path, r in ref.items():
        t = port[path]
        assert tuple(t.shape) == tuple(r.shape), path
        assert str(t.dtype).removeprefix("torch.") == np.dtype(r.dtype).name, \
            path
        assert t.device.type == "cpu", path


def _same_specs(port_specs, ref_specs):
    port = _port_leaves(port_specs, is_spec=True)
    ref = _ref_leaves(ref_specs, is_spec=True)
    assert port == ref


def _ref_per_card_bytes(ref_tree, ref_specs, mesh) -> int:
    """The bytes one card holds of a reference tree under its specs: each
    dimension divided (rounding up) by the sizes of the axes named."""
    specs = _ref_leaves(ref_specs, is_spec=True)
    total = 0
    for path, sds in _ref_leaves(ref_tree).items():
        dims = list(sds.shape)
        for i, entry in enumerate(specs[path]):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            dims[i] = -(-dims[i] // math.prod(mesh.shape[a] for a in names))
        total += math.prod(dims) * np.dtype(sds.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def params():
    """(arch, bits) -> (reference eval_shape tree, port fake tree), built
    once per module."""
    cache = {}

    def get(arch, bits):
        if (arch, bits) not in cache:
            ref = j_steps.param_specs(get_config(arch))
            port = t_steps.param_specs(t_get_config(arch))
            if bits:
                ref = jax.eval_shape(lambda p: j_quantize(p, bits), ref)
                from repro_torch.core.quantizer import \
                    quantize_params_for_serving
                with t_steps.fake_mode_of(port):
                    port = quantize_params_for_serving(port, bits)
            cache[arch, bits] = ref, port
        return cache[arch, bits]

    return get


def test_meshes():
    assert t_mesh.mesh_num_chips(t_mesh.make_host_mesh()) == 1
    assert t_mesh.mesh_num_chips(t_mesh.make_production_mesh()) == 256
    assert t_mesh.mesh_num_chips(POD) == 512
    assert t_mesh.make_production_mesh().axis_names == ("data", "model")
    assert POD.axis_names == ("pod", "data", "model")
    assert t_mesh.make_host_mesh().shape == {"data": 1, "model": 1}
    for mesh in MESHES.values():
        assert t_shard.data_axes(mesh) == j_shard.data_axes(mesh)


@pytest.mark.parametrize("bits", QUANTS)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_structs_match_reference(params, arch, bits):
    _same_structs(*reversed(params(arch, bits)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("bits", QUANTS)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_pspecs_match_reference(params, arch, bits, fsdp, mesh):
    mesh = MESHES[mesh]
    ref, port = params(arch, bits)
    ref_specs = j_shard.param_pspecs(get_config(arch), ref, fsdp=fsdp,
                                     mesh=mesh)
    port_specs = t_shard.param_pspecs(t_get_config(arch), port, fsdp=fsdp,
                                      mesh=mesh)
    _same_specs(port_specs, ref_specs)
    assert t_shard.per_card_bytes(port, port_specs, mesh) == \
        _ref_per_card_bytes(ref, ref_specs, mesh)
    if not bits:                                 # the optimizer's trees
        ref_opt = j_steps.opt_specs(ref)
        port_opt = t_steps.opt_specs(port)
        _same_structs(port_opt, ref_opt)
        o_ref = j_shard.opt_pspecs(ref_specs)
        o_port = t_shard.opt_pspecs(port_specs)
        _same_specs(o_port, o_ref)
        assert t_shard.per_card_bytes(port_opt, o_port, mesh) == \
            _ref_per_card_bytes(ref_opt, o_ref, mesh)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_specs_and_pspecs_match_reference(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    j_cfg = for_shape(get_config(arch), shape)
    t_cfg = for_shape(t_get_config(arch), shape)
    ref = j_steps.cache_specs(j_cfg, shape.global_batch, shape.seq_len)
    port = t_steps.cache_specs(t_cfg, shape.global_batch, shape.seq_len)
    _same_structs(port, ref)
    for mesh in MESHES.values():
        ref_specs = j_shard.cache_pspecs(j_cfg, ref, mesh, shape.global_batch)
        port_specs = t_shard.cache_pspecs(t_cfg, port, mesh,
                                          shape.global_batch)
        _same_specs(port_specs, ref_specs)
        assert t_shard.per_card_bytes(port, port_specs, mesh) == \
            _ref_per_card_bytes(ref, ref_specs, mesh)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_specs_and_pspecs_match_reference(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    ref = j_steps.batch_specs(get_config(arch), shape)
    port = t_steps.batch_specs(t_get_config(arch), shape)
    _same_structs(port, ref)
    for mesh in MESHES.values():
        kw = dict(has_embeds="embeds" in ref, has_positions="positions" in ref)
        ref_specs = j_shard.batch_pspecs(mesh, shape.global_batch, **kw)
        port_specs = t_shard.batch_pspecs(mesh, shape.global_batch, **kw)
        _same_specs(port_specs, ref_specs)


@pytest.mark.parametrize("serve", [(None, 0), ("bf16", 0), ("bf16", 8),
                                   (None, 4)], ids=lambda s: f"{s[0]}-w{s[1]}")
@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b"])
def test_build_step_args_match_reference(arch, serve):
    """``build_step``'s arguments for every shape kind, as the dry run
    counts them: leaf for leaf the reference's, the decode position (a
    fake 0-d int32 tensor, the reference's traced int32 scalar)
    included."""
    dtype, bits = serve
    for shape_name, shape in INPUT_SHAPES.items():
        ref = j_steps.build_step(get_config(arch), shape,
                                 serve_dtype=dtype and jnp.bfloat16,
                                 serve_quant=bits)
        port = t_steps.build_step(t_get_config(arch), shape,
                                  serve_dtype=dtype and torch.bfloat16,
                                  serve_quant=bits)
        assert port.kind == ref.kind and port.cfg.name == ref.cfg.name
        assert port.cfg.sliding_window == ref.cfg.sliding_window
        _same_structs(list(port.args), list(ref.args))
        mode = t_steps.fake_mode_of(port.args)
        assert all(isinstance(t, FakeTensor) and t.fake_mode is mode
                   for t in _port_leaves(list(port.args)).values())


def test_param_shapes_allocate_nothing_and_carry_no_meta():
    """``param_shapes`` builds on ``meta`` and hands back fake CPU
    tensors of one mode: no ``meta`` tensor leaves it."""

    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(T.param_shapes(t_get_config("dbrx-132b")))
    assert all(isinstance(t, FakeTensor) and t.device.type == "cpu"
               for t in leaves)
    assert sum(t.numel() for t in leaves) > 1e11
    t_steps.fake_mode_of(leaves)
