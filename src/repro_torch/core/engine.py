"""Synchronous push-relabel engine over all regions (port of
``repro.core.engine``).

Every region of a parallel sweep is discharged at once on ``[K, V, E]``
tensors.  One engine iteration is the reference's: a push phase on the
pre-push state (labels frozen; exclusive-prefix-sum split of each active
vertex's excess over its admissible arcs, sink first), the scatter of the
deltas (intra reverse arcs and receiver excess; cross flow accumulates in
``out_push``), then a relabel phase on the post-push residual graph.

Backends:

  "torch" — plain PyTorch ops (the counterpart of the reference's "xla");
  "cuda"  — the hand-written Hopper kernels (the counterpart of "pallas"):
            kernel B (``kernels.push_relabel.push_relabel_phase``) for the
            two phases of the unfused engine, kernel A
            (``fused_engine_run_batched``) for ``chunk_iters=k``.

All four paths (fused/unfused x torch/cuda) give bit-identical states.
``EngineState.launches`` keeps the reference's accounting, summed over
regions: unfused 2 per iteration; fused "torch" 1 per advanced
region-iteration; fused "cuda" 1 per chunk-trip (one kernel launch covers
every region).

The reference runs each region as its own ``lax.while_loop`` under
``vmap``: a region whose condition fails is frozen while the others go on.
Here one eager loop runs while any region is running, and a per-region run
mask freezes the rest; each loop test is a device-to-host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import push_relabel as _pr

_I32 = torch.int32

ENGINE_BACKENDS = ("torch", "cuda")


class EngineState(NamedTuple):
    cf: torch.Tensor          # i32[K,V,E]
    sink_cf: torch.Tensor     # i32[K,V]
    excess: torch.Tensor      # i32[K,V]
    lab: torch.Tensor         # i32[K,V]
    out_push: torch.Tensor    # i32[K,V,E] flow pushed over cross arcs
    sink_pushed: torch.Tensor  # i32[K]   flow absorbed by the sink
    iters: torch.Tensor       # i32[K]
    relabel_sum: torch.Tensor  # i32[K]   total label increase
    launches: torch.Tensor    # i32[]     compute-program dispatches


def _check_backend(backend: str) -> None:
    if backend not in ENGINE_BACKENDS:
        raise ValueError(f"unknown engine backend {backend!r}; "
                         f"expected one of {ENGINE_BACKENDS}")


def make_phase(backend: str, *, nbr_local, intra, emask, vmask,
               cross_pushable, cross_lab, d_inf, sink_open: bool = True):
    """Build the compute-phase closure for ``backend``.

    ``phase(lab, cf, sink_cf, excess, mode="both", run=None) -> (delta,
    new_lab)`` applies the engine's gating (cross/emask arc gate, vmask
    excess gate, sink_open; ``run`` [K] additionally zeroes the excess of
    frozen regions, so they neither push nor relabel) and computes the
    phase with the plain ops ("torch") or kernel B ("cuda").  ``mode``
    drops the output the caller does not need.
    """
    _check_backend(backend)
    K = nbr_local.shape[0]
    d_inf = torch.as_tensor(d_inf, dtype=_I32,
                            device=nbr_local.device).broadcast_to((K,))
    pushable = (cross_pushable | intra) & emask
    if backend == "cuda":
        fn = _pr.push_relabel_phase
        intra, pushable = intra.to(_I32), pushable.to(_I32)
    else:
        fn = _pr.push_relabel_phase_plain

    def phase(lab, cf, sink_cf, excess, mode="both", run=None):
        live = vmask if run is None else vmask & run[:, None]
        excess = torch.where(live, excess, 0)
        sink = sink_cf if sink_open else torch.zeros_like(sink_cf)
        return fn(lab, cf, sink, excess, nbr_local, intra, pushable,
                  cross_lab, d_inf, mode=mode)
    return phase


def push_relabel(cf, sink_cf, excess, lab, *, nbr_local, rev_slot, intra,
                 emask, vmask, cross_pushable, cross_lab, d_inf,
                 sink_open: bool = True, max_iters: int | None = None,
                 backend: str = "torch") -> EngineState:
    """The unfused two-phase engine, run until no region has an active
    vertex (or its ``max_iters`` budget is spent).

    All K regions at once; a region advances iff it has an active vertex
    and budget left, as the reference's vmapped per-region loop does.
    ``launches`` = 2 per iteration, summed over regions.
    """
    K, V, E = cf.shape
    dev = cf.device
    d_inf = torch.as_tensor(d_inf, dtype=_I32, device=dev).broadcast_to((K,))
    phase = make_phase(backend, nbr_local=nbr_local, intra=intra, emask=emask,
                       vmask=vmask, cross_pushable=cross_pushable,
                       cross_lab=cross_lab, d_inf=d_inf, sink_open=sink_open)
    ridx = _pr.flat_gather_index(nbr_local)
    sidx = ridx * E + rev_slot.reshape(-1).long()
    out_push = torch.zeros_like(cf)
    zk = torch.zeros(K, dtype=_I32, device=dev)
    sink_pushed, iters, relabel_sum = zk, zk, zk
    while True:
        run = ((excess > 0) & (lab < d_inf[:, None]) & vmask).any(dim=1)
        if max_iters is not None:
            run = run & (iters < max_iters)
        if not bool(run.any()):
            break
        # ---- push phase (compute on the pre-push state) ----
        delta, _ = phase(lab, cf, sink_cf, excess, mode="push", run=run)
        d_sink, d_arc = delta[..., 0], delta[..., 1:]
        # ---- scatter application ----
        excess = excess - d_sink - d_arc.sum(dim=-1, dtype=_I32)
        sink_cf = sink_cf - d_sink
        cf = cf - d_arc
        d_intra = torch.where(intra, d_arc, 0).reshape(-1)
        cf.view(-1).index_add_(0, sidx, d_intra)
        excess.view(-1).index_add_(0, ridx, d_intra)
        out_push = out_push + (d_arc - d_intra.view(K, V, E))
        sink_pushed = sink_pushed + d_sink.sum(dim=-1, dtype=_I32)
        # ---- relabel phase (on the post-push residual graph) ----
        _, new_lab = phase(lab, cf, sink_cf, excess, mode="relabel", run=run)
        relabel_sum = relabel_sum + torch.where(vmask, new_lab - lab, 0).sum(
            dim=-1, dtype=_I32)
        lab = new_lab
        iters = iters + run.to(_I32)
    return EngineState(cf, sink_cf, excess, lab, out_push, sink_pushed, iters,
                       relabel_sum, 2 * iters.sum(dtype=_I32))


def _push_relabel_fused_batched(cf, sink_cf, excess, lab, *, nbr_local,
                                rev_slot, intra, emask, vmask, cross_pushable,
                                cross_lab, d_inf, sink_open, max_iters,
                                backend, chunk_iters) -> EngineState:
    """Fused chunked driver over all regions: one outer trip advances every
    still-running region by up to ``chunk_iters`` iterations (one kernel A
    launch on "cuda", the plain loop on "torch")."""
    K, V, E = cf.shape
    dev = cf.device
    chunk = int(chunk_iters)
    assert chunk >= 1
    d_inf = torch.as_tensor(d_inf, dtype=_I32, device=dev).broadcast_to((K,))
    pushable = (cross_pushable | intra) & emask
    if backend == "cuda":
        launch = _pr.fused_engine_run_batched
        masks = (intra.to(_I32), pushable.to(_I32), vmask.to(_I32))
    else:
        launch = _pr.fused_engine_run_batched_plain
        masks = (intra, pushable, vmask)
    intra_m, pushable_m, vmask_m = masks

    out_push = torch.zeros_like(cf)
    zk = torch.zeros(K, dtype=_I32, device=dev)
    sink_pushed, iters, relabel_sum = zk, zk, zk
    launches = torch.zeros((), dtype=_I32, device=dev)
    while True:
        run = ((excess > 0) & (lab < d_inf[:, None]) & vmask).any(dim=1)
        if max_iters is not None:
            run = run & (iters < max_iters)
        if not bool(run.any()):
            break
        limit = torch.full((K,), chunk, dtype=_I32, device=dev)
        if max_iters is not None:
            limit = torch.minimum(limit, max_iters - iters)
        cf, sink_cf, excess, lab, dpush, dsink, drls, dit = launch(
            lab, cf, sink_cf, excess, nbr_local, rev_slot, intra_m,
            pushable_m, cross_lab, vmask_m, d_inf, limit,
            sink_open=sink_open)
        out_push = out_push + dpush
        sink_pushed = sink_pushed + dsink
        relabel_sum = relabel_sum + drls
        iters = iters + dit
        launches = launches + (1 if backend == "cuda"
                               else dit.sum(dtype=_I32))
    return EngineState(cf, sink_cf, excess, lab, out_push, sink_pushed, iters,
                       relabel_sum, launches)


def push_relabel_batched(cf, sink_cf, excess, lab, *, nbr_local, rev_slot,
                         intra, emask, vmask, cross_pushable, cross_lab,
                         d_inf, sink_open: bool = True,
                         max_iters: int | None = None,
                         backend: str = "torch",
                         chunk_iters: int | None = None) -> EngineState:
    """Run push/relabel on all K regions of a sweep through one entry point.

    ``chunk_iters=None`` runs the unfused engine (:func:`push_relabel`),
    ``chunk_iters=k`` the fused chunked driver.  Per-region results are
    bit-identical across the four paths; ``launches`` is the global
    dispatch count of this engine run.  ``d_inf`` is an int or an int32
    ``[K]`` vector.
    """
    _check_backend(backend)
    kw = dict(nbr_local=nbr_local, rev_slot=rev_slot, intra=intra,
              emask=emask, vmask=vmask, cross_pushable=cross_pushable,
              cross_lab=cross_lab, d_inf=d_inf, sink_open=sink_open,
              max_iters=max_iters, backend=backend)
    if chunk_iters is None:
        return push_relabel(cf, sink_cf, excess, lab, **kw)
    return _push_relabel_fused_batched(cf, sink_cf, excess, lab,
                                       chunk_iters=chunk_iters, **kw)


def bfs_to_targets(cf, sink_cf, *, nbr_local, intra, emask, vmask,
                   target_cross, linf, sink_open: bool = True
                   ) -> torch.Tensor:
    """Exact hop distance of every vertex to its region's target set through
    residual arcs (all K regions at once).

    Vectorised Bellman-Ford with unit weights, to a fixpoint: a converged
    region is unchanged by further rounds, so looping until no region
    changes equals the reference's per-region loops.  ``linf`` is an int
    or an int32 ``[K]`` ceiling.
    """
    K, V, E = cf.shape
    linf = torch.as_tensor(linf, dtype=_I32,
                           device=cf.device).broadcast_to((K,))[:, None]
    base = torch.where((target_cross & emask & (cf > 0)).any(dim=-1),
                       torch.ones_like(sink_cf), linf)
    if sink_open:
        base = torch.where(sink_cf > 0, torch.clamp_max(base, 1), base)
    base = torch.where(vmask, base, linf)
    gidx = _pr.flat_gather_index(nbr_local)
    resid = intra & emask & (cf > 0)
    lab = base
    while True:
        nlab = torch.where(resid, lab.reshape(-1)[gidx].view(K, V, E),
                           linf[..., None])
        relaxed = torch.minimum(lab, torch.minimum(
            base, nlab.amin(dim=-1) + 1))
        relaxed = torch.where(vmask, relaxed, linf)
        changed = bool((relaxed != lab).any())
        lab = relaxed
        if not changed:
            break
    return torch.minimum(lab, linf)

