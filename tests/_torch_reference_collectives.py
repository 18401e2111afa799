"""The reference's decode and train steps of 2-layer configs lowered and
compiled on a (data 1, model 4) mesh of forced CPU devices, their
collective bytes by kind read by ``repro.roofline.hlo_cost.analyze_text``;
and its train step under the FSDP layout (``param_pspecs(fsdp=True)``)
on a (data 2, model 2) mesh of the same four devices. Run in a process
of its own (the device count is fixed at JAX's first import):

  XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
      python tests/_torch_reference_collectives.py KIND ARCH SEQ BATCH [...]

(KIND ``decode``, ``train`` or ``train_fsdp``) prints one JSON object,
{kind: {arch: {collective kind: bytes}}}."""
import dataclasses
import json
import sys

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs.base import InputShape, get_config
from repro.launch.dryrun import step_in_shardings
from repro.launch.steps import build_step
from repro.roofline.hlo_cost import analyze_text


def collectives(kind: str, arch: str, seq: int, batch: int) -> dict:
    fsdp = kind == "train_fsdp"
    kind = "train" if fsdp else kind
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    shape = InputShape(f"{kind}_small", seq, batch, kind)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape((2, 2) if fsdp
                                                    else (1, 4)),
                ("data", "model"))
    spec = build_step(cfg, shape)
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s),
                             step_in_shardings(spec, mesh, shape, fsdp=fsdp),
                             is_leaf=lambda x: isinstance(x, P))
    with mesh:
        compiled = jax.jit(spec.fn, in_shardings=shardings).lower(
            *spec.args).compile()
    return analyze_text(compiled.as_text()).collectives


if __name__ == "__main__":
    args = sys.argv[1:]
    out = {}
    for i in range(0, len(args), 4):
        kind, arch, seq, batch = args[i:i + 4]
        out.setdefault(kind, {})[arch] = collectives(kind, arch, int(seq),
                                                     int(batch))
    print(json.dumps(out))
