"""Serving-error hierarchy.

The online path used to guard its preconditions with bare ``assert``
statements (gone under ``python -O``) and raw ``KeyError`` on unknown
model names. Every serving-layer failure now raises a ``ServingError``
subclass so callers can catch one root type and error messages name the
missing lifecycle step.
"""
from __future__ import annotations


class ServingError(Exception):
    """Root of all QPART serving-layer errors."""


class UnknownModelError(ServingError, KeyError):
    """Request names a model that was never ``register()``-ed."""

    def __init__(self, name: str, registered):
        self.name = name
        super().__init__(
            f"unknown model {name!r}; registered: {sorted(registered) or '[]'}")

    def __str__(self):            # KeyError quotes its arg; keep the message
        return self.args[0]


class NotCalibratedError(ServingError):
    """Model lacks noise calibration or any built offline store — run
    ``calibrate()`` then ``build_store()`` before serving."""


class StoreMissingError(ServingError):
    """A store exists, but not for the requested ``ReferenceContext``."""


class PlanInfeasibleError(ServingError):
    """No stored partition candidate satisfies the request's device
    constraints (e.g. every quantized segment exceeds the device memory)."""


class FaultConfigError(ServingError, ValueError):
    """Invalid fault-injection or retry configuration (unknown fault
    kind, non-positive dwell times, attempt budget < 1, ...) — raised at
    construction so a chaos run never discovers a bad schedule
    mid-simulation."""
