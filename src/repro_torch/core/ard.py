"""Augmented-path Region Discharge (ARD, paper Sec. 4) — port of
``repro.core.ard`` (the batched form).

Discharge of a region R:

  stage 0   — augment excess to the sink t inside the region network G^R;
  stage k>0 — augment excess to T_k = {t} ∪ {w in B^R : d(w) < k}, i.e. to
              boundary (ghost) vertices in order of increasing label;
  finally   — region-relabel (Alg. 3, ARD variant) recomputes the region's
              labels from the frozen boundary labels.

Each stage is a push-relabel run seeded with exact BFS distances to the
stage's target set.  Stages iterate over the distinct ghost labels
actually present; all regions advance in lockstep, and a region whose
schedule is exhausted is frozen by its ``more`` mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.engine import bfs_to_targets, push_relabel_batched
from repro_torch.core.graph import INF_LABEL
from repro_torch.core.labels import _region_relabel_one

_I32 = torch.int32


class DischargeResult(NamedTuple):
    cf: torch.Tensor          # i32[K,V,E]
    sink_cf: torch.Tensor     # i32[K,V]
    excess: torch.Tensor      # i32[K,V]
    d: torch.Tensor           # i32[K,V]   new labels d'
    out_push: torch.Tensor    # i32[K,V,E] flow pushed over cross arcs
    sink_pushed: torch.Tensor  # i32[K]
    engine_iters: torch.Tensor  # i32[K]
    stages: torch.Tensor      # i32[K]
    engine_launches: torch.Tensor  # i32[] global dispatch count


def _distinct_sorted_ghost_labels(ghost_d, cross, emask, d_inf):
    """Per region: the distinct ghost labels (< d_inf) in ascending order,
    padded with INF, behind a leading -1 (stage 0 is the sink-only stage).
    ``[K, 1 + V*E]`` int32."""
    K = ghost_d.shape[0]
    dinf = torch.as_tensor(d_inf, dtype=_I32,
                           device=ghost_d.device).broadcast_to((K,))
    flat = torch.where(cross & emask & (ghost_d < dinf[:, None, None]),
                       ghost_d, INF_LABEL).reshape(K, -1)
    s = torch.sort(flat, dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    distinct = torch.sort(torch.where(first, s, INF_LABEL), dim=1).values
    lead = torch.full((K, 1), -1, dtype=_I32, device=ghost_d.device)
    return torch.cat([lead, distinct], dim=1)


def ard_discharge_batched(cf, sink_cf, excess, ghost_d, *, nbr_local,
                          rev_slot, intra, emask, vmask, d_inf, stage_cap,
                          max_iters: int | None = None,
                          backend: str = "torch",
                          chunk_iters: int | None = None,
                          linf=None) -> DischargeResult:
    """ARD on all K regions of a parallel sweep, collectively.

    Per-region results (state, labels, out_push, engine iterations, stage
    counts) equal the reference's.  Each stage runs the engine on every
    region, as the reference's batched stage body does, and
    ``engine_launches`` counts all of them.  ``linf`` is the engine/BFS
    ceiling (default ``V + 2``).
    """
    K, V, E = cf.shape
    dev = cf.device
    cross = emask & ~intra
    per_k = lambda x: torch.as_tensor(x, dtype=_I32,
                                      device=dev).broadcast_to((K,))
    d_inf = per_k(d_inf)
    linf = per_k(V + 2 if linf is None else linf)
    stage_cap = per_k(stage_cap)
    stage_vals = _distinct_sorted_ghost_labels(ghost_d, cross, emask, d_inf)
    n_vals = stage_vals.shape[1]
    cross_lab = torch.zeros_like(ghost_d)

    def stage_more(i):
        lvl = torch.gather(stage_vals, 1,
                           torch.clamp_max(i, n_vals - 1).long()[:, None])[:, 0]
        more = (i < n_vals) & (lvl < INF_LABEL) & (lvl <= stage_cap)
        return lvl, more

    zk = torch.zeros(K, dtype=_I32, device=dev)
    i, sink_pushed, iters = zk, zk, zk
    out_push = torch.zeros_like(cf)
    launches = torch.zeros((), dtype=_I32, device=dev)
    while True:
        lvl, more = stage_more(i)
        if not bool(more.any()):
            break
        target_cross = (cross & (ghost_d <= lvl[:, None, None])
                        & (ghost_d < d_inf[:, None, None]))
        lab0 = bfs_to_targets(cf, sink_cf, nbr_local=nbr_local, intra=intra,
                              emask=emask, vmask=vmask,
                              target_cross=target_cross, linf=linf)
        es = push_relabel_batched(
            cf, sink_cf, excess, lab0, nbr_local=nbr_local,
            rev_slot=rev_slot, intra=intra, emask=emask, vmask=vmask,
            cross_pushable=target_cross, cross_lab=cross_lab, d_inf=linf,
            sink_open=True, max_iters=max_iters, backend=backend,
            chunk_iters=chunk_iters)
        w3, w2 = more[:, None, None], more[:, None]
        i = i + more.to(_I32)
        cf = torch.where(w3, es.cf, cf)
        sink_cf = torch.where(w2, es.sink_cf, sink_cf)
        excess = torch.where(w2, es.excess, excess)
        out_push = out_push + torch.where(w3, es.out_push, 0)
        sink_pushed = sink_pushed + torch.where(more, es.sink_pushed, 0)
        iters = iters + torch.where(more, es.iters, 0)
        launches = launches + es.launches

    d_new = _region_relabel_one(cf, sink_cf, ghost_d, nbr_local=nbr_local,
                                intra=intra, emask=emask, vmask=vmask,
                                d_inf=d_inf, hop_cost=0)
    return DischargeResult(cf, sink_cf, excess, d_new, out_push, sink_pushed,
                           iters, i, launches)
