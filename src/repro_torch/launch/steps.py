"""Step functions the launchers execute (cfg baked in by closure): the
train step (forward, backward and the AdamW update), a full-sequence
prefill that builds the decode caches, and one decode step against
them — and their inputs for every (architecture x input shape), as the
dry run counts them.

Shape kinds map to steps:
  train_4k    -> train_step   (forward + backward + AdamW update)
  prefill_32k -> prefill_step (full-sequence forward + cache build)
  decode_*    -> serve_step   (ONE token against a seq_len cache)

The spec builders return fake CPU tensors (``FakeTensorMode``): shapes
and dtypes leaf for leaf as the reference's ``jax.eval_shape`` trees,
nothing allocated. A fake CPU tensor dispatches as ``cpu``
(``kernels.ops``), as the reference's dry run lowers on forced CPU
devices; ``roofline.op_cost.count`` costs the kernel entry points
themselves. All the fakes of one step share one mode.

Given a mesh whose ``model`` axis is larger than 1, :func:`build_step`
builds one rank's program of the step: it runs on the rank's model axis
(``launch.model_parallel``, its collectives the dry run's stand-ins) and
its fake arguments have the rank's local shapes under ``param_pspecs`` /
``opt_pspecs`` / ``cache_pspecs`` / ``batch_pspecs``
(``launch.sharding.local_shape``). A train step also averages its
gradients over the rank's data axis, where the batch splits over it.
With ``fsdp``, on any mesh whose data axes hold more than one index
(the host mesh's (n, 1) included), it builds rank 0's program of the
FSDP layout: its fakes the shards of ``step_specs(fsdp=True)``, each
leaf gathered over the data axis where the step reads it
(``model_parallel.Fsdp``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import InputShape, ModelConfig, for_shape
from repro_torch.core.quantizer import quantize_params_for_serving
from repro_torch.launch import model_parallel as mp
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step as _make_train_step
from repro_torch.tree import tree_leaves, tree_map


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    remat: bool = True, accum_steps: int = 1, axis=None,
                    group=None, fsdp=None) -> Callable:
    """The train step; over a model ``axis`` (and its data ``group``),
    or an FSDP layout ``fsdp``, one rank's program."""
    return _make_train_step(cfg, opt_cfg or AdamWConfig(), remat=remat,
                            accum_steps=accum_steps, group=group, axis=axis,
                            fsdp=fsdp)


def make_prefill_step(cfg: ModelConfig, max_len: int, axis=None,
                      fsdp=None) -> Callable:
    """The prefill step; over a model ``axis``, or with the leaves
    gathered over an FSDP layout's data axis (``fsdp``), one rank's
    program."""
    def prefill_step(params, batch):
        logits, caches, _ = T.prefill(
            params, cfg, batch.get("tokens"), embeds=batch.get("embeds"),
            positions=batch.get("positions"), max_len=max_len, axis=axis,
            fsdp=fsdp)
        return logits, caches

    return prefill_step


def make_serve_step(cfg: ModelConfig, axis=None, fsdp=None) -> Callable:
    """One decode step; over a model ``axis`` (its ``max_len`` the
    caches' length), or with the leaves gathered over an FSDP layout's
    data axis (``fsdp``), one rank's program."""
    def serve_step(params, token, caches, pos):
        return T.decode_step(params, cfg, token, caches, pos, axis=axis,
                             fsdp=fsdp)

    return serve_step


# ---------------------------------------------------------------------------
# Fake-tensor stand-ins for the steps' inputs.

def fake_mode_of(tree) -> FakeTensorMode:
    """The ``FakeTensorMode`` the tensors of ``tree`` belong to."""
    mode = detect_fake_mode(tree_leaves(tree))
    if mode is None:
        raise ValueError("want fake tensors")
    return mode


def param_specs(cfg: ModelConfig, dtype=None, mode=None):
    """``dtype``: cast the float params (serving runs bf16 / quantized
    weights; training keeps f32 masters)."""
    p = T.param_shapes(cfg, mode)
    if dtype is None:
        return p
    with fake_mode_of(p):
        return tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                        else t, p)


def opt_specs(params_sds):
    with fake_mode_of(params_sds):
        return init_opt_state(params_sds)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, mode=None):
    with mode or FakeTensorMode():
        return T.init_cache(cfg, batch, max_len, dtype, device="cpu")


def batch_specs(cfg: ModelConfig, shape: InputShape, mode=None) -> dict:
    """Training / prefill batch: tokens for text archs, frontend-stub
    embeddings (+ M-RoPE position triples) for audio / VLM backbones."""
    b, s = shape.global_batch, shape.seq_len
    specs: dict = {}
    with mode or FakeTensorMode():
        if cfg.frontend != "none":
            specs["embeds"] = torch.empty((b, s, cfg.d_model),
                                          dtype=torch.bfloat16)
        else:
            specs["tokens"] = torch.empty((b, s), dtype=torch.int32)
        if cfg.rope == "mrope":
            specs["positions"] = torch.empty((3, b, s), dtype=torch.int32)
        if shape.kind == "train":
            specs["labels"] = torch.empty((b, s), dtype=torch.int32)
    return specs


@dataclasses.dataclass
class StepSpec:
    """Everything the dry run needs for one (arch x shape): the step
    callable, its example arguments (fake tensors of one mode) and the
    config it was built for; for one rank's program, also the whole
    arguments it holds shards of (``global_args``) and their spec trees
    (``specs``)."""
    kind: str
    fn: Callable
    args: tuple
    cfg: ModelConfig
    global_args: tuple | None = None
    specs: tuple | None = None


def step_specs(kind: str, cfg: ModelConfig, args: tuple, mesh,
               global_batch: int, *, fsdp: bool = False) -> tuple:
    """The spec trees of a step's arguments on ``mesh`` (as the
    reference's ``dryrun.step_in_shardings``): params, then the batch
    (prefill; train adds the optimizer state before it), or the token,
    caches and position (decode)."""
    p_specs = shard_lib.param_pspecs(cfg, args[0], fsdp=fsdp, mesh=mesh)
    if kind in ("train", "prefill"):
        batch = args[-1]
        b_specs = shard_lib.batch_pspecs(
            mesh, global_batch, has_embeds="embeds" in batch,
            has_positions="positions" in batch)
        b_specs = {k: b_specs[k] for k in batch}
        if kind == "train":
            return (p_specs, shard_lib.opt_pspecs(p_specs), b_specs)
        return (p_specs, b_specs)
    c_specs = shard_lib.cache_pspecs(cfg, args[2], mesh, global_batch)
    return (p_specs, (shard_lib.batch_axis(mesh, global_batch), None),
            c_specs, ())


def _local_fakes(tree, specs, mesh, mode):
    """A fresh fake tensor of each leaf's local shape (same dtype)."""
    if isinstance(tree, dict):
        return {k: _local_fakes(v, specs[k], mesh, mode)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local_fakes(v, s, mesh, mode)
                          for v, s in zip(tree, specs, strict=True))
    with mode:
        return torch.empty(shard_lib.local_shape(tree, specs, mesh),
                           dtype=tree.dtype)


def build_step(cfg: ModelConfig, shape: InputShape,
               opt_cfg: AdamWConfig | None = None,
               accum_steps: int = 1, serve_dtype=None,
               serve_quant: int = 0, mesh=None, coords=None,
               fsdp: bool = False) -> StepSpec:
    """The step of ``shape``'s kind and its fake arguments. A decode
    step's position is a fake 0-d int32 tensor of the step's mode, as the
    reference's traced scalar and the launcher's compile-once step take
    it (``op_cost.count`` costs it as the last slot of a full ``seq_len``
    cache). With a ``mesh`` whose model axis is larger than 1, a prefill
    or decode step is the program of the rank at ``coords``
    (``mesh.coords``; rank 0 when None) on local fake shards (module
    docstring), a train step with its data axis's gradient mean where
    the batch splits over the data axes. With ``fsdp`` and a mesh whose
    data axes hold more than one index, the program of the FSDP layout
    (module docstring), on any model axis."""
    spec = _build_step(for_shape(cfg, shape), shape, opt_cfg, accum_steps,
                       serve_dtype, serve_quant)
    if mesh is None:
        return spec
    from repro_torch.launch.mesh import coords as coords_of
    where = coords if coords is not None else coords_of(mesh, 0)
    index, size = mp.data_index(mesh, where)
    if mesh.shape[MODEL_AXIS] == 1 and not (fsdp and size > 1):
        return spec
    specs = step_specs(spec.kind, spec.cfg, spec.args, mesh,
                       shape.global_batch, fsdp=fsdp)
    mode = fake_mode_of(spec.args[0])
    local = _local_fakes(spec.args, specs, mesh, mode)
    axis = mp.ModelAxis(where[MODEL_AXIS], mesh.shape[MODEL_AXIS], None,
                        shape.seq_len)
    group = _data_axis(mesh, where, shape.global_batch)
    layout = mp.Fsdp(mp.ModelAxis(index, size, None, name=DATA_AXIS),
                     shard_lib.fsdp_dims(spec.cfg, spec.args[0], mesh),
                     sums=group is not None) if fsdp else None
    if spec.kind == "train":
        fn = make_train_step(spec.cfg, opt_cfg, accum_steps=accum_steps,
                             axis=axis, group=group, fsdp=layout)
    elif spec.kind == "prefill":
        fn = make_prefill_step(spec.cfg, shape.seq_len, axis, layout)
    else:
        fn = make_serve_step(spec.cfg, axis, layout)
    return StepSpec(spec.kind, fn, local, spec.cfg, global_args=spec.args,
                    specs=specs)


def _data_axis(mesh, where, global_batch: int):
    """The fake data axis of the rank at ``where`` (``mp.data_index``),
    over which a train step averages its gradients; None where the batch
    does not split over the data axes (each replica then computes the
    same gradients, and the reference's program reduces none)."""
    if shard_lib.batch_axis(mesh, global_batch) is None:
        return None
    index, size = mp.data_index(mesh, where)
    return mp.ModelAxis(index, size, None, name=DATA_AXIS) if size > 1 \
        else None


def _build_step(cfg, shape, opt_cfg, accum_steps, serve_dtype, serve_quant):
    mode = FakeTensorMode()

    def serving_params():
        p = param_specs(cfg, dtype=serve_dtype, mode=mode)
        if serve_quant:
            with mode:
                p = quantize_params_for_serving(p, serve_quant)
        return p

    if shape.kind == "train":
        fn = make_train_step(cfg, opt_cfg, accum_steps=accum_steps)
        p = param_specs(cfg, mode=mode)
        return StepSpec("train", fn, (p, opt_specs(p),
                                      batch_specs(cfg, shape, mode)), cfg)
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, max_len=shape.seq_len)
        return StepSpec("prefill", fn, (serving_params(),
                                        batch_specs(cfg, shape, mode)), cfg)
    fn = make_serve_step(cfg)
    p = serving_params()
    caches = cache_specs(cfg, shape.global_batch, shape.seq_len, mode=mode)
    with mode:
        token = torch.empty((shape.global_batch, 1), dtype=torch.int32)
        pos = torch.empty((), dtype=torch.int32)
    return StepSpec("decode", fn, (p, token, caches, pos), cfg)
