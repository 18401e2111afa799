"""Shared helpers of the ``test_torch_*`` parity tests: arrays and trees
cross from the JAX package to the PyTorch port as NumPy (bfloat16 and
float8 by their bit patterns, which NumPy cannot hand to torch
directly), plus the small configs both packages run, a CPU stand-in
for the decode session's CUDA graphs (``FakeGraph``) and a dispatch mode
that fails any read of a tensor's value on the host (``NoHostReads``).

Importing this module caps torch's intra-op threads at the process's
share of the cores: pytest-xdist's workers (``PYTEST_XDIST_WORKER_COUNT``
in their environment) would otherwise each run one thread per core."""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys
import types
from pathlib import Path

import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro_torch.configs.base import get_config as torch_get_config
from _torch_host_reads import NoHostReads, exempting_one_hot  # noqa: F401

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(min(torch.get_num_threads(), THREADS))

# NumPy dtype name -> (same-width integer view, torch dtype)
_BIT_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def to_torch(a, device="cpu") -> torch.Tensor:
    """A JAX/NumPy array as a torch tensor with the same bits."""
    a = np.array(a)                      # a writable, contiguous copy
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is None:
        return torch.from_numpy(a).to(device)
    ints, tdt = view
    t = torch.from_numpy(a.view(ints))
    return t.view(tdt).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor as NumPy (low-precision floats widened to f32)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        t = t.float()
    return t.numpy()


def tree_to_torch(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    return to_torch(tree, device)


def lm_weights(tcfg, seed: int = 0):
    """One seeded weight tree for both packages: the port's init (the
    reference's stacked layout, cheaper than compiling the reference's
    vmapped init) as NumPy leaves, ready for ``jnp.asarray`` and
    ``transformer.params_from_numpy``."""
    from repro_torch.models import transformer as TT
    from repro_torch.tree import tree_map
    params = TT.init_params(tcfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    return tree_map(lambda t: t.numpy(), params)


def lm_configs(tp_pad: int = 1):
    """The example's 4-layer f32 smollm-8m, as (jax cfg, torch cfg);
    ``tp_pad=16`` pads its 4/2 heads to 2 x 8 and a 250-token vocab to
    256, so padded heads and masked vocab columns run."""
    kw = dict(name="smollm-8m", num_layers=4, d_model=256, num_heads=4,
              num_kv_heads=2, head_dim=64, d_ff=768,
              vocab_size=256 if tp_pad == 1 else 250,
              tp_pad=tp_pad, dtype="float32")
    return (dataclasses.replace(jax_get_config("smollm-135m"), **kw),
            dataclasses.replace(torch_get_config("smollm-135m"), **kw))


def zoo_configs(arch: str):
    """The 2-layer ``.reduced()`` variant of an assigned arch in f32, as
    (jax cfg, torch cfg)."""
    return tuple(dataclasses.replace(get(arch).reduced(), dtype="float32")
                 for get in (jax_get_config, torch_get_config))


def assert_trees_close(got, want, tol: float, path: str = "") -> None:
    """Every leaf of the port's tree within ``tol`` (abs and rel) of the
    reference's, with the same nesting."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_close(g, w, tol, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   atol=tol, rtol=tol, err_msg=path)


def zoo_weights(arch: str):
    """(jax cfg, jax params, torch cfg, torch params) of ``zoo_configs``
    on one seeded weight tree."""
    import jax
    import jax.numpy as jnp
    from repro_torch.models import transformer as TT
    jcfg, tcfg = zoo_configs(arch)
    tree = lm_weights(tcfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            TT.params_from_numpy(tree, tcfg, device="cpu"))


EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts, not
    a package; the directory goes on ``sys.path`` for the helper module
    the classifier examples share)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class FakeGraph:
    """``StageGraph`` on the CPU: ``fn`` run on its static inputs when
    captured and again at every replay, its results copied into the
    capture's outputs (a real capture launches nothing; the stages are
    idempotent, each writing the same cache slots from the same
    inputs). Every capture and replay is logged."""

    log = []

    def __init__(self, fn, inputs, pool=None):
        self.fn, self.inputs, self.pool = fn, tuple(inputs), pool
        self.outputs = fn(*self.inputs)
        self.graph = types.SimpleNamespace(pool=lambda: self)
        self.log.append(("capture", self))

    def replay(self, *inputs):
        for static, x in zip(self.inputs, inputs):
            if x is not static:
                static.copy_(x)
        new = self.fn(*self.inputs)
        outs = self.outputs if isinstance(self.outputs, tuple) \
            else (self.outputs,)
        for o, n in zip(outs, new if isinstance(new, tuple) else (new,)):
            o.copy_(n)
        self.log.append(("replay", self))
        return self.outputs


def stage_graphs(backend) -> dict:
    """The backend's cached stage graphs, stage key -> graph (a pair's
    key with the stage's own name in front)."""
    return {(name,) + key[1:]: g for key, entry in
            backend.__dict__.get("_stage_graphs", {}).items()
            for name, g in entry.graphs.items()}


def no_host_reads(monkeypatch) -> NoHostReads:
    """A ``NoHostReads`` mode with ``F.one_hot`` exempted through
    ``monkeypatch`` (the body of the tests' ``no_host_reads`` fixtures)."""
    mode = NoHostReads()
    monkeypatch.setattr(torch.nn.functional, "one_hot",
                        exempting_one_hot(mode))
    return mode
