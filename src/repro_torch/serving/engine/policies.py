"""Pluggable admission policies for the fleet engine.

A policy decides, at each decision epoch, (a) in which ORDER the pending
requests are admitted — each admission sees the queue state its
predecessors left, so order is the whole game — and (b) how a server is
picked for each admission (``server_rule``):

  objective     — joint argmin over (server, partition candidate) of the
                  queue-adjusted Eq. 17 row: the QPART-native rule.
  least_loaded  — restrict to the server with the smallest work backlog
                  first, then argmin over candidates: pure load
                  balancing, ignores server-speed differences.

The historical ``WorkloadBalancer`` policies are the first two entries:
``fcfs`` and ``balanced`` (shortest-server-demand-first) admit exactly
as the one-shot scheduler did, which is what regression-locks the
degenerate one-server / simultaneous-arrivals case plan-for-plan.

Policies are stateless; all fleet state lives in the engine. Custom
policies subclass ``AdmissionPolicy`` and go straight into
``FleetEngine(policy=MyPolicy())``.
"""
from __future__ import annotations

import numpy as np


class AdmissionPolicy:
    """Base: admit in arrival order, objective-driven server choice."""

    name = "fcfs"
    server_rule = "objective"          # objective | least_loaded

    def order(self, pending, tab, t_server_rows):
        """Admission order as indices into ``pending``.

        ``pending`` — list of engine ``_Pending`` entries (``.request``,
        ``.arrival``, ``.index``); ``tab`` — the epoch's ``WindowTable``
        (row i prices pending[i]); ``t_server_rows`` — per-pending
        (P+1,) zero-load server seconds on the reference server.
        """
        return sorted(range(len(pending)),
                      key=lambda i: (pending[i].arrival, pending[i].index))


class FCFSPolicy(AdmissionPolicy):
    """First-come-first-served (the historical ``fcfs``)."""


class BalancedPolicy(AdmissionPolicy):
    """Shortest-server-demand first (SJF-flavoured; the historical
    ``balanced``): provably reduces the mean queueing term for the same
    total work. Demand is estimated at zero load from the window table —
    the same ``np.argsort`` the one-shot scheduler ran."""

    name = "balanced"

    def order(self, pending, tab, t_server_rows):
        zero_choice = tab.argmin_choices()
        demands = np.array([t_server_rows[i][zero_choice[i]]
                            for i in range(len(pending))])
        return list(np.argsort(demands))


class EDFPolicy(AdmissionPolicy):
    """Earliest-deadline-first: admit by absolute deadline (arrival +
    SLO). Jackson's rule — for a single queue this minimizes the maximum
    lateness, so any trace FCFS can meet end-to-end, EDF meets too.
    Deadline-less requests go last, among themselves in arrival order."""

    name = "edf"

    def order(self, pending, tab, t_server_rows):
        def key(i):
            r = pending[i].request
            if r.deadline is None:
                return (1, 0.0, pending[i].arrival, pending[i].index)
            return (0, pending[i].arrival + r.deadline,
                    pending[i].arrival, pending[i].index)
        return sorted(range(len(pending)), key=key)


class LeastLoadedPolicy(AdmissionPolicy):
    """Arrival order, but each admission goes to the server with the
    smallest work backlog regardless of the objective — the classic
    join-the-shortest-queue dispatcher, here as the contrast case to the
    objective-driven rule."""

    name = "least_loaded"
    server_rule = "least_loaded"


POLICIES = {cls.name: cls for cls in
            (FCFSPolicy, BalancedPolicy, EDFPolicy, LeastLoadedPolicy)}


def get_policy(policy) -> AdmissionPolicy:
    """'fcfs' | 'balanced' | 'edf' | 'least_loaded', or an
    ``AdmissionPolicy`` instance (returned as-is)."""
    if isinstance(policy, AdmissionPolicy):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"unknown admission policy {policy!r}; "
                         f"known: {sorted(POLICIES)}")
    return POLICIES[policy]()
