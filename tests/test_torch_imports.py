"""Guards of the port's contracts that need no GPU:

* ``src/repro_torch``, ``chip_smoke.py`` and the port's examples
  (``examples/torch_*.py``) import neither ``jax`` nor anything of the
  JAX package ``repro`` (the card's machine has no JAX);
* every module of ``src/repro_torch`` imports where there is no card,
  no nvcc and no Triton (kernels are built, and CUDA-only packages
  imported, inside the calls that launch them);
* dispatch is by device: only a CPU tensor reaches a kernel's plain
  version. A ``meta`` tensor stands in for a device tensor — with the
  kernel loader made to fail, every entry point must raise instead of
  returning the plain result.
"""
import ast
import importlib
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build, ops

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (ROOT / "src" / "repro_torch").rglob("*.py"))


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], (ast.Constant, ast.JoinedStr)):
            arg = node.args[0]
            text = arg.value if isinstance(arg, ast.Constant) else "".join(
                v.value for v in arg.values if isinstance(v, ast.Constant))
            yield str(text).split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name", PORT_MODULES)
def test_every_port_module_imports_here(name):
    module = importlib.import_module(name)
    assert module.__name__ == name


def _meta_calls():
    m = dict(device="meta")
    q = torch.empty(2, 4, 4, 64, **m)
    cache = torch.empty(2, 32, 4, 64, dtype=torch.bfloat16, **m)
    x = torch.empty(2, 3, 64, **m)
    w = {"codes": torch.empty(64, 32, dtype=torch.uint8, **m),
         "scale": torch.empty(1, 1, **m), "mu": torch.empty(1, 1, **m)}
    w4 = {"codes_packed": torch.empty(64, 16, dtype=torch.uint8, **m),
          "scale": torch.empty(1, 1, **m), "mu": torch.empty(1, 1, **m)}
    fq = torch.empty(1, 16, 2, 2, 64, **m)
    fk = torch.empty(1, 16, 2, 64, **m)
    qx = torch.empty(8, 16, **m)
    qc = torch.empty(8, 16, dtype=torch.uint8, **m)
    qm = torch.empty(1, 16, **m)
    return {"decode_attention": lambda: ops.decode_attention(q, cache, cache,
                                                             5),
            "decode_attention_shard": lambda: ops.decode_attention_shard(
                q, cache, cache, 5, 32, 64),
            "flash_attention": lambda: ops.flash_attention(fq, fk, fk, 16,
                                                           16),
            "flash_attention_bwd": lambda: ops.KERNELS["flash_attention_bwd"](
                fq, fk, fk, fq, torch.empty(1, 16, 2, 2, **m), fq),
            "qmatmul": lambda: ops.qdense(x, w),
            "qmatmul4": lambda: ops.qdense(x, w4),
            "quantize": lambda: ops.quantize_tensor(qx, qm, qm, 8),
            "quantize_pack4": lambda: ops.quantize_pack4(qx, qm, qm),
            "dequantize": lambda: ops.dequantize_tensor(qc, qm, qm)}


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_device_tensors_never_take_the_plain_version(name, monkeypatch):
    def no_kernels(*args, **kwargs):
        raise RuntimeError("kernel loader unavailable")

    monkeypatch.setattr(build, "library", no_kernels)
    monkeypatch.setattr(build, "launcher", no_kernels)
    before = ops.KERNELS[name].launches
    with pytest.raises((RuntimeError, ValueError)):
        _meta_calls()[name]()
    assert ops.KERNELS[name].launches == before


def _reexported(init: Path):
    """The names a package ``__init__`` imports from its submodules."""
    return {alias.asname or alias.name
            for node in ast.parse(init.read_text()).body
            if isinstance(node, ast.ImportFrom) for alias in node.names}


def test_core_reexports_the_reference_api():
    """``repro_torch.core`` exposes every name ``repro.core`` does, each
    from the port's own ``core`` modules."""
    import repro_torch.core as core
    names = _reexported(ROOT / "src" / "repro" / "core" / "__init__.py")
    assert len(names) == 36
    missing = sorted(n for n in names if not hasattr(core, n))
    assert not missing, f"repro_torch.core lacks {missing}"
    foreign = sorted(n for n in names
                     if not getattr(core, n).__module__.startswith(
                         "repro_torch.core."))
    assert not foreign, f"not from the port's core modules: {foreign}"


def test_engine_reexports_the_reference_api():
    """``repro_torch.serving.engine`` exposes every name
    ``repro.serving.engine`` does: each class and function from the
    port's own engine modules, each constant equal to the reference's
    (the policy table by its names)."""
    import repro.serving.engine as reference
    import repro_torch.serving.engine as engine
    names = _reexported(ROOT / "src" / "repro" / "serving" / "engine"
                        / "__init__.py")
    assert len(names) == 38
    missing = sorted(n for n in names if not hasattr(engine, n))
    assert not missing, f"repro_torch.serving.engine lacks {missing}"
    code = {n for n in names if callable(getattr(engine, n))}
    foreign = sorted(n for n in code
                     if not getattr(engine, n).__module__.startswith(
                         "repro_torch.serving.engine."))
    assert not foreign, f"not from the port's engine modules: {foreign}"
    for n in sorted(names - code):
        ours, theirs = getattr(engine, n), getattr(reference, n)
        if isinstance(theirs, dict):
            ours, theirs = list(ours), list(theirs)
        assert ours == theirs, n
