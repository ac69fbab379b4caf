"""Region executors: the generic host sweep loop (port of
``repro.core.executor``, host-loop route).

A :class:`RegionExecutor` advances a solve by one sweep; :func:`run_host`
runs any executor to convergence with one device-to-host sync before the
first sweep and one after each sweep (the paper's accounting point).  The
device-resident loop (``run_device``) is not ported yet (ROADMAP queue 1,
item 4).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable

import torch


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a route or option the port does not have yet."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class RegionExecutor(abc.ABC):
    """One strategy for advancing a region-discharge solve by one sweep."""

    # True: the host loop checks convergence before each sweep, and a
    # converged entry state runs zero sweeps (the reference's semantics)
    entry_check: bool = True

    @abc.abstractmethod
    def num_active(self, state) -> torch.Tensor:
        """Convergence observable (scalar active-vertex count, on device)."""

    @abc.abstractmethod
    def sweep_host(self, state, idx: int):
        """One sweep -> ``(state, obs)``; ``obs`` is a 1-D device tensor
        whose element 0 is the post-sweep active count."""


def run_host(ex: RegionExecutor, state, limit: int,
             on_sweep: Callable | None = None):
    """Host-loop driver: one sweep program + one host sync per sweep.

    ``on_sweep(state, sweeps_done)`` is called at every sweep boundary.
    Returns ``(state, trace, active_pre, host_syncs, sweeps)``: ``trace``
    holds each sweep's fetched observation tuple, ``active_pre`` the
    pre-sweep active counts (the ``active_curve``).
    """
    trace: list[tuple] = []
    active_pre: list[int] = []
    syncs = 0
    n_act = None
    if ex.entry_check:
        n_act = int(ex.num_active(state))
        syncs += 1
    idx = 0
    while idx < limit:
        if ex.entry_check:
            active_pre.append(n_act)
            if n_act == 0:
                break
        state, obs = ex.sweep_host(state, idx)
        host_obs = tuple(int(x) for x in obs.tolist())
        syncs += 1
        idx += 1
        trace.append(host_obs)
        n_act = host_obs[0]
        if on_sweep is not None:
            on_sweep(state, idx)
        if not ex.entry_check and n_act == 0:
            break
    return state, trace, active_pre, syncs, idx


@dataclass(frozen=True)
class LocalExecutor(RegionExecutor):
    """Single-instance solve on one device (``core.sweep``), parallel
    sweeps (Alg. 2)."""

    meta: Any
    cfg: Any

    entry_check = True

    def num_active(self, state) -> torch.Tensor:
        from repro_torch.core import sweep
        return sweep.num_active(self.meta, state, self.cfg)

    def sweep_host(self, state, idx: int):
        from repro_torch.core import sweep
        state, iters, launches = sweep.parallel_sweep(
            self.meta, state, self.cfg, idx)
        disc = torch.tensor(self.meta.num_regions, dtype=torch.int32,
                            device=state.device)
        obs = torch.stack([self.num_active(state), state.flow_to_t, iters,
                           launches, disc])
        return state, obs
