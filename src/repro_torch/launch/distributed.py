"""The host mesh's processes: one rank per local card, each in a process
of its own, all in one ``torch.distributed`` process group — the port's
counterpart of the reference's ``make_host_mesh`` over every local
device (``repro/launch/mesh.py``), on which its training launcher's
``jax.jit`` splits the batch over ``data`` and has XLA all-reduce the
gradients (``repro/launch/train.py``).

:func:`spawn` runs ``fn(rank, world, group, *args)`` in ``world``
worker processes (``torch.multiprocessing``, the ``spawn`` start
method) and returns each rank's result. On CUDA rank ``r`` takes card
``r % torch.cuda.device_count()`` (``torch.cuda.set_device``) and the
group's backend is ``nccl``; on the CPU it is ``gloo``. A ``backend``
named by the caller replaces the default (``gloo`` over CUDA tensors
puts several ranks on one card). The ranks meet at a ``file://``
rendezvous in a temporary directory, so no rank needs a network
address, and hand their results back through files in the same
directory (``torch.save``). On CUDA the kernels are built once in the
caller (``kernels.build.build_all``) before the ranks start, so
``world`` ranks do not each run ``nvcc``. A CPU rank takes its share of
the intra-op threads.

If a rank raises, the others are ended and :func:`spawn` raises
(``torch.multiprocessing.ProcessRaisedException``, with the traceback of
the first failed rank the join sees: the one that raised, or a peer
whose collective lost it): there is no fallback to fewer ranks. Every
group has a timeout (``RANK_TIMEOUT``): a collective that a peer never
joins (one that raised inside a CUDA graph's capture, say) fails its
rank after it rather than holding it, so :func:`spawn` raises then at
the latest. A rank drops its graphs (the steps that hold
them) before ``fn`` returns: a graph outlives no group it captured.

:func:`process_group` makes the calling process the one rank of a
world of one (the training launcher's single card, asked for a group).
"""
from __future__ import annotations

import contextlib
import datetime
import hashlib
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.tree import tree_leaves

# a group's collective timeout: far above any step's wait for a
# peer (a rank that builds its shards while the others wait), far below
# a caller's own time limit
RANK_TIMEOUT = datetime.timedelta(seconds=300)


@contextlib.contextmanager
def process_group(device, rank: int = 0, world: int = 1, backend=None,
                  rendezvous=None):
    """This process as rank ``rank`` of ``world`` (on CUDA on card
    ``rank % device_count``), the group's ``file://`` rendezvous at
    ``rendezvous`` (a fresh temporary file when None) and its collectives'
    timeout ``RANK_TIMEOUT``; yields the group and destroys it on the way
    out. A group already made in this process raises."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        if backend == "nccl":     # the communicator made now, not later
            kw["device_id"] = torch.device("cuda",
                                           torch.cuda.current_device())
    with contextlib.ExitStack() as stack:
        if rendezvous is None:
            rendezvous = Path(stack.enter_context(tempfile.TemporaryDirectory(
                prefix="repro_torch_mesh_"))) / "rendezvous"
        dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                                rank=rank, world_size=world,
                                timeout=RANK_TIMEOUT, **kw)
        try:
            yield dist.group.WORLD
            # every rank done before any tears its transport down (a gloo
            # rank destroyed while a peer still sends to it can abort)
            dist.barrier()
        finally:
            dist.destroy_process_group()


def spawn(fn, world: int, device, *args, backend=None) -> list:
    """``fn(rank, world, group, *args)`` on ``world`` ranks of ``device``
    (module docstring) -> each rank's return value, by rank. ``fn`` and
    ``args`` are pickled to the ranks: ``fn`` must be importable."""
    device = torch.device(device)
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        mp.start_processes(_rank, args=(fn, world, str(device), backend, tmp,
                                        args),
                           nprocs=world, start_method="spawn")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def _rank(rank, fn, world, device, backend, tmp, args):
    """One spawned rank: join the group, run ``fn``, save its result."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    with process_group(device, rank, world, backend,
                       rendezvous=Path(tmp) / "rendezvous") as group:
        out = fn(rank, world, group, *args)
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def broadcast_tree(tree, group, src: int = 0) -> None:
    """Every leaf of ``tree`` overwritten in place by rank ``src``'s, as
    DDP starts its replicas from one rank's parameters."""
    for leaf in tree_leaves(tree):
        dist.broadcast(leaf, src, group=group)


def digest(tree) -> str:
    """A sha256 of the bytes of ``tree``'s leaves, in order (the host
    mesh's replicas hold the same parameters bit for bit)."""
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()
