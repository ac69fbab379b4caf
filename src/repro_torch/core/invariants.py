"""Preflow/labeling invariant checkers and structured solve diagnostics
(port of ``repro.core.invariants``, ARD labels).

Checkers return a list of :class:`Violation` records (empty = the invariant
holds).  A solve that stops at ``max_sweeps`` carries a
:class:`NonConvergence` report; a converged solve whose cut==flow
certificate fails raises :class:`CertificateError`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.graph import intra_mask
from repro_torch.core.labels import gather_ghost_labels


@dataclass
class Violation:
    """One broken invariant: which property, how many entries, evidence."""

    kind: str
    count: int
    detail: str


def preflow_total(state) -> int:
    """The conserved quantity: live excess + flow already delivered to t."""
    live = torch.where(state.vmask, state.excess, 0).sum(dtype=torch.int64)
    return int(live) + int(state.flow_to_t)


def _bad(kind: str, mask, detail: str) -> list[Violation]:
    mask = np.asarray(mask.cpu() if torch.is_tensor(mask) else mask)
    n = int(np.count_nonzero(mask))
    if n == 0:
        return []
    first = np.argwhere(mask)[:3].tolist()
    return [Violation(kind=kind, count=n, detail=f"{detail}; first at {first}")]


def check_valid_preflow(meta, state) -> list[Violation]:
    """Residuals and excess of a preflow are non-negative everywhere."""
    out: list[Violation] = []
    out += _bad("negative_residual", state.cf < 0, "cf < 0")
    out += _bad("negative_sink_residual", state.sink_cf < 0, "sink_cf < 0")
    out += _bad("negative_excess", (state.excess < 0) & state.vmask,
                "excess < 0")
    return out


def check_valid_labeling(meta, state, *, ard: bool = True) -> list[Violation]:
    """Paper eqs. (9)/(10): d() lower-bounds residual distance-to-sink.

    ARD labels count boundary crossings (intra arcs cost 0, cross arcs 1,
    the sink is at distance 0); PRD labels count hops (every arc costs 1,
    the sink is one hop away).  Vertices at the ceiling are exempt.
    """
    ghost_d = gather_ghost_labels(state)
    intra = intra_mask(state)
    d_inf = meta.d_inf_ard if ard else meta.d_inf_prd
    du = state.d[:, :, None].expand(state.cf.shape)
    resid = (state.cf > 0) & state.emask
    at_cap = du >= d_inf
    w = 0 if ard else 1
    bad_intra = resid & intra & (du > ghost_d + w) & ~at_cap
    bad_cross = resid & state.emask & ~intra & (du > ghost_d + 1) & ~at_cap
    bad_sink = ((state.sink_cf > 0) & (state.d > w) & (state.d < d_inf)
                & state.vmask)
    out: list[Violation] = []
    out += _bad("intra_arc_validity", bad_intra,
                f"residual intra arc with d(u) > d(v) + {w}")
    out += _bad("cross_arc_validity", bad_cross,
                "residual cross arc with d(u) > ghost + 1")
    out += _bad("sink_validity", bad_sink,
                f"sink-residual vertex with d > {w}")
    return out


def check_flow_conservation(meta, state, total0: int) -> list[Violation]:
    """No flow mass appears or vanishes: excess + flow_to_t == total0."""
    total = preflow_total(state)
    if total == total0:
        return []
    return [Violation(kind="flow_conservation", count=0,
                      detail=f"excess + flow_to_t = {total} != {total0}")]


def sweep_bound(meta, *, ard: bool = True) -> int:
    """The paper's worst-case sweep count: 2|B|^2 + 1 for ARD (Lemma 2)."""
    base = max(1, meta.num_boundary) if ard else max(1, meta.num_vertices)
    return 2 * base * base + 1


def check_sweep_bound(meta, stats, *, ard: bool = True) -> list[Violation]:
    """A converged solve's sweep count respects the paper's bound."""
    if not stats.converged:
        return []
    limit = sweep_bound(meta, ard=ard)
    if stats.sweeps <= limit:
        return []
    return [Violation(
        kind="sweep_bound", count=stats.sweeps,
        detail=f"{stats.sweeps} sweeps exceeds the "
               f"{'2|B|^2+1' if ard else '2n^2+1'} bound {limit} "
               f"(|B|={meta.num_boundary}, n={meta.num_vertices})")]


def invariant_report(meta, state, *, ard: bool = True,
                     total0: int | None = None) -> list[Violation]:
    """Every state-level invariant in one pass (empty list = all hold)."""
    out = check_valid_preflow(meta, state)
    out += check_valid_labeling(meta, state, ard=ard)
    if total0 is not None:
        out += check_flow_conservation(meta, state, total0)
    return out


@dataclass
class NonConvergence:
    """Structured report of a solve that cannot certify optimality:
    ``reason`` is ``"max_sweeps"`` or ``"certificate"``."""

    reason: str
    sweeps: int
    max_sweeps: int | None
    active_vertices: int
    flow_value: int
    cut_cost: int | None = None
    violations: list[Violation] = field(default_factory=list)

    def summary(self) -> str:
        head = (f"non-convergence ({self.reason}): sweeps={self.sweeps}"
                f"/{self.max_sweeps}, active={self.active_vertices}, "
                f"flow={self.flow_value}")
        if self.cut_cost is not None:
            head += f", cut_cost={self.cut_cost}"
        if self.violations:
            head += "; broken invariants: " + ", ".join(
                f"{v.kind} (x{v.count})" for v in self.violations)
        return head


class CertificateError(AssertionError):
    """The cut==flow certificate failed on a solve that claims convergence;
    carries the :class:`NonConvergence` report on ``.diagnosis``."""

    def __init__(self, message: str, diagnosis: NonConvergence):
        self.diagnosis = diagnosis
        super().__init__(f"{message}\n  {diagnosis.summary()}")


def diagnose(meta, state, *, ard: bool = True, reason: str, sweeps: int,
             max_sweeps: int | None, flow_value: int,
             cut_cost: int | None = None,
             total0: int | None = None) -> NonConvergence:
    """Assemble a :class:`NonConvergence` report for a finished state."""
    d_inf = meta.d_inf_ard if ard else meta.d_inf_prd
    active = int(state.active(d_inf).sum())
    return NonConvergence(
        reason=reason, sweeps=sweeps, max_sweeps=max_sweeps,
        active_vertices=active, flow_value=flow_value, cut_cost=cut_cost,
        violations=invariant_report(meta, state, ard=ard, total0=total0))
