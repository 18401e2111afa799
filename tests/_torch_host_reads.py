"""A dispatch mode that fails any read of a tensor's value on the host,
the CPU's proxy for "a CUDA graph can capture this": it imports torch
alone, so the spawned ranks' functions use it too."""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class NoHostReads(TorchDispatchMode):
    """Fails an op that reads a tensor's value on the host (``int()``,
    ``.item()``, ``bool()``, a data-dependent shape), except inside
    ``F.one_hot``: on the CPU it checks its classes' range on the host,
    on CUDA it leaves that to its scatter's device assert and reads
    nothing (``exempt`` counts the ``one_hot`` calls under way)."""

    def __init__(self):
        super().__init__()
        self.exempt = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.exempt and func in (
                torch.ops.aten._local_scalar_dense.default,
                torch.ops.aten.nonzero.default):
            raise AssertionError(f"{func} read a tensor on the host")
        return func(*args, **(kwargs or {}))


def exempting_one_hot(mode: NoHostReads):
    """``F.one_hot`` wrapped so that ``mode`` lets its host read pass."""
    one_hot = torch.nn.functional.one_hot

    def exempt_one_hot(*args, **kwargs):
        mode.exempt += 1
        try:
            return one_hot(*args, **kwargs)
        finally:
            mode.exempt -= 1

    return exempt_one_hot


@contextlib.contextmanager
def no_host_reads():
    """A ``NoHostReads`` mode entered, ``F.one_hot`` exempted for its
    span (outside pytest's ``monkeypatch``: a spawned rank's)."""
    mode, one_hot = NoHostReads(), torch.nn.functional.one_hot
    torch.nn.functional.one_hot = exempting_one_hot(mode)
    try:
        with mode:
            yield mode
    finally:
        torch.nn.functional.one_hot = one_hot
