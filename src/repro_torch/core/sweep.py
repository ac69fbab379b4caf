"""Parallel region-discharge sweeps (paper Alg. 2) — port of
``repro.core.sweep`` (host-loop route).

A *sweep* discharges every region once on frozen boundary labels, then
fuses boundary flow with the conflict rule of Alg. 2:

    flow u->v over a cross arc is accepted iff d'(v) <= d'(u) + 1

(the reverse arc stays valid); rejected flow is refunded to the sender's
excess and residual.  The global gap heuristic runs after the fusion.
``solve`` drives sweeps until no vertex is active, with one host sync per
sweep, and keeps the paper's per-sweep accounting.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.core import executor as _executor
from repro_torch.core.ard import ard_discharge_batched
from repro_torch.core.engine import ENGINE_BACKENDS
from repro_torch.core.executor import not_ported
from repro_torch.core.graph import (FlowState, GraphMeta, ghost_index,
                                    intra_mask)
from repro_torch.core.labels import gather_ghost_labels, global_gap

_I32 = torch.int32


@dataclass(frozen=True)
class SweepConfig:
    """Solver configuration (the reference's fields and meanings).

    method              — "ard" (paper's contribution); "prd" is not
                          ported yet.
    parallel            — Alg. 2 (all regions concurrently + fusion).
    partial_discharge   — Sec. 6.2: sweep s only augments to labels < s.
    use_global_gap      — Sec. 5.1 global gap heuristic each sweep.
    use_boundary_relabel— Sec. 6.1 heuristic (not ported yet).
    max_sweeps          — hard cap (defaults to the theoretical bound).
    engine_max_iters    — safety cap for the inner engine (None = unbounded).
    engine_backend      — "cuda" (the Hopper kernels) or "torch" (plain
                          ops); bit-identical results.
    engine_chunk_iters  — fused chunked engine, k iterations per kernel
                          launch; None keeps the unfused two-phase engine.
    device_resident, host_sync_every, stats_ring_size — the
                          device-resident driver (not ported yet).
    """

    method: str = "ard"
    parallel: bool = True
    partial_discharge: bool = False
    use_global_gap: bool = True
    use_boundary_relabel: bool = False
    max_sweeps: int | None = None
    engine_max_iters: int | None = None
    engine_backend: str = "cuda"
    engine_chunk_iters: int | None = None
    device_resident: bool = False
    host_sync_every: int | None = None
    stats_ring_size: int = 1024

    def __post_init__(self):
        if self.method == "prd":
            raise not_ported("method='prd' (PRD)", "queue 1, item 5")
        if self.method != "ard":
            raise ValueError(f"unknown method {self.method!r}")
        if not self.parallel:
            raise not_ported("parallel=False (sequential sweeps, Alg. 1)",
                             "queue 1, item 5")
        if self.use_boundary_relabel:
            raise not_ported("use_boundary_relabel", "queue 1, item 5")
        if self.device_resident or self.host_sync_every is not None:
            raise not_ported("the device-resident driver "
                             "(device_resident, host_sync_every)",
                             "queue 1, item 4")
        if self.engine_backend not in ENGINE_BACKENDS:
            raise ValueError(f"unknown engine backend "
                             f"{self.engine_backend!r}; expected one of "
                             f"{ENGINE_BACKENDS}")
        if self.engine_chunk_iters is not None and self.engine_chunk_iters < 1:
            raise ValueError("engine_chunk_iters must be >= 1 or None")


@dataclass
class SweepStats:
    """Per-solve accounting in the paper's I/O currency (the reference's
    fields).  ``host_syncs`` counts the solve loop's device-to-host
    transfers (1 + 1 per sweep), not the engine's inner loop tests."""

    sweeps: int = 0
    engine_iters: int | None = 0
    engine_launches: int | None = 0
    host_syncs: int = 0
    boundary_bytes: int = 0
    page_bytes: int | None = 0
    num_boundary: int | None = None
    staged_in_bytes: int = 0
    staged_out_bytes: int = 0
    regions_discharged: int | None = 0
    flow_curve: list = dataclasses.field(default_factory=list)
    active_curve: list = dataclasses.field(default_factory=list)
    scope: str = "instance"
    converged: bool = True
    degraded: list = dataclasses.field(default_factory=list)


def _apply_cross_flow(state: FlowState, out_push: torch.Tensor,
                      accept: torch.Tensor) -> FlowState:
    """Apply fused boundary flow through the flat cross-arc table.

    Accepted flow raises the receiver's reverse residual and excess;
    rejected flow is refunded to the sender (residual and excess).  Padded
    entries index in range with a zero delta.
    """
    src_arc, dst_arc = state.cross_src_arc.long(), state.cross_dst_arc.long()
    delta = out_push.reshape(-1)[src_arc]
    acc = torch.where(accept, delta, 0)
    rej = delta - acc
    cf = state.cf.clone()
    cf.view(-1).index_add_(0, dst_arc, acc).index_add_(0, src_arc, rej)
    excess = state.excess.clone()
    excess.view(-1).index_add_(0, state.cross_dst_vtx.long(), acc) \
        .index_add_(0, state.cross_src_vtx.long(), rej)
    return state.replace(cf=cf, excess=excess)


def parallel_sweep(meta: GraphMeta, state: FlowState, cfg: SweepConfig,
                   sweep_idx: int):
    """One sweep of Alg. 2: concurrent discharges + label/flow fusion.

    Returns ``(state, engine_iters, engine_launches)`` (int32 device
    scalars)."""
    ghost_d = gather_ghost_labels(state)
    stage_cap = (max(sweep_idx - 1, -1) if cfg.partial_discharge
                 else meta.d_inf_ard)
    res = ard_discharge_batched(
        state.cf, state.sink_cf, state.excess, ghost_d,
        nbr_local=state.nbr_local, rev_slot=state.rev_slot,
        intra=intra_mask(state),
        emask=state.emask, vmask=state.vmask, d_inf=meta.d_inf_ard,
        stage_cap=stage_cap, max_iters=cfg.engine_max_iters,
        backend=cfg.engine_backend, chunk_iters=cfg.engine_chunk_iters)
    new = state.replace(
        cf=res.cf, sink_cf=res.sink_cf, excess=res.excess,
        d=torch.maximum(state.d, res.d),
        flow_to_t=state.flow_to_t + res.sink_pushed.sum(dtype=_I32))
    # ---- fusion (Alg. 2 lines 4-6) ----
    dflat = new.d.reshape(-1)
    accept = (dflat[new.cross_dst_vtx.long()]
              <= dflat[new.cross_src_vtx.long()] + 1)
    new = _apply_cross_flow(new, res.out_push, accept)
    if cfg.use_global_gap:
        new = global_gap(meta, new, ard=True)
    return new, res.engine_iters.sum(dtype=_I32), res.engine_launches


def num_active(meta: GraphMeta, state: FlowState,
               cfg: SweepConfig) -> torch.Tensor:
    return state.active(meta.d_inf_ard).sum(dtype=_I32)


def sweep_bound(meta: GraphMeta, cfg: SweepConfig) -> int:
    """Theoretical sweep bound: 2|B|^2 + 1 for ARD."""
    return 2 * meta.num_boundary * meta.num_boundary + 1


def _page_and_msg_bytes(meta: GraphMeta) -> tuple[int, int]:
    """Bytes of one region page (cf, nbr, rev, emask per arc; sink_cf,
    excess, d, vmask per vertex; all int32) and of one sweep's boundary
    messages (flow + label per cross arc)."""
    V, E = meta.region_size, meta.max_degree
    return 16 * V * E + 16 * V, 8 * meta.num_cross_arcs


def solve(meta: GraphMeta, state: FlowState, cfg: SweepConfig | None = None,
          *, warm: bool = False, on_sweep=None):
    """Run sweeps until no active vertex remains (maximum preflow reached).

    ``warm`` continues from the given state as is; otherwise labels are
    re-initialised to the paper's ``Init``.  ``on_sweep(state,
    sweeps_done)`` is called at every sweep boundary.  Returns ``(state,
    SweepStats)``.
    """
    cfg = cfg or SweepConfig()
    if not warm:
        state = state.replace(d=torch.zeros_like(state.d))
    ex = _executor.LocalExecutor(meta, cfg)
    max_sweeps = cfg.max_sweeps if cfg.max_sweeps is not None \
        else sweep_bound(meta, cfg)
    page_bytes, msg_bytes = _page_and_msg_bytes(meta)
    state, trace, active_pre, syncs, sweeps = _executor.run_host(
        ex, state, max_sweeps, on_sweep=on_sweep)
    stats = SweepStats(host_syncs=syncs, sweeps=sweeps,
                       active_curve=list(active_pre),
                       num_boundary=meta.num_boundary)
    for n_act, flow, it, ln, dc in trace:
        stats.engine_iters += it
        stats.engine_launches += ln
        stats.regions_discharged += dc
        stats.page_bytes += dc * page_bytes
        stats.boundary_bytes += msg_bytes
        stats.flow_curve.append(flow)
    if trace:
        stats.converged = trace[-1][0] == 0
    elif active_pre:
        stats.converged = active_pre[-1] == 0
    return state, stats


def extract_cut(meta: GraphMeta, state: FlowState) -> torch.Tensor:
    """Minimum cut (bool[K,V]: True = sink side T = {v : v -> t in G_f}),
    by a global residual-reachability fixpoint."""
    gidx = ghost_index(state)
    resid = (state.cf > 0) & state.emask
    reach = (state.sink_cf > 0) & state.vmask
    while True:
        nbr_reach = reach.reshape(-1)[gidx].view(state.cf.shape)
        new = (state.sink_cf > 0) | (resid & nbr_reach).any(dim=2)
        new = (new | reach) & state.vmask
        changed = bool((new != reach).any())
        reach = new
        if not changed:
            return reach


def cut_value(meta: GraphMeta, state0: FlowState,
              sink_side: torch.Tensor) -> torch.Tensor:
    """Cost of the cut (C, C̄) with C̄ = sink_side, in the initial network:
    sum_{v in C̄} e(v) + sum_{v in C} sink_cap(v) + sum of cap(u,v) over
    arcs u in C, v in C̄ (int32 sums)."""
    src_side = ~sink_side & state0.vmask
    e_term = torch.where(sink_side & state0.vmask, state0.excess, 0).sum(
        dtype=_I32)
    t_term = torch.where(src_side, state0.sink_cf, 0).sum(dtype=_I32)
    nbr_sink = sink_side.reshape(-1)[ghost_index(state0)].view(
        state0.cf.shape)
    arc_cut = src_side[:, :, None] & nbr_sink & state0.emask
    c_term = torch.where(arc_cut, state0.cf, 0).sum(dtype=_I32)
    return e_term + t_term + c_term
