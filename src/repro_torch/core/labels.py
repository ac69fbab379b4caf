"""Distance labelings: region-relabel (Alg. 3) and the global gap heuristic
(Alg. 4) — port of ``repro.core.labels`` (ARD path).

ARD labels lower-bound the *region* distance: the number of inter-region
boundary crossings on a residual path to the sink (ceiling ``d_inf_ard =
|B|``, paper Sec. 4.1).  Region-relabel is a vectorised Bellman-Ford
fixpoint over each region's residual arcs; the gap heuristic works on a
histogram of boundary labels.
"""

from __future__ import annotations

import torch

from repro_torch.core.graph import INF_LABEL, FlowState, GraphMeta, ghost_index
from repro_torch.kernels.push_relabel import flat_gather_index

_I32 = torch.int32

# static histogram cap for the gap heuristic (labels above the cap are not
# gap-checked; the heuristic stays sound)
GAP_HIST_CAP = 4096


def gather_ghost_labels(state: FlowState) -> torch.Tensor:
    """i32[K,V,E] — label of every arc's destination vertex (global
    gather)."""
    return state.d.reshape(-1)[ghost_index(state)].view(state.cf.shape)


def _region_relabel_one(cf, sink_cf, ghost_d, *, nbr_local, intra, emask,
                        vmask, d_inf, hop_cost: int) -> torch.Tensor:
    """Alg. 3 on every region network at once (the reference vmaps its
    one-region form).  ``d_inf`` is an int or int32 ``[K]``.

    Seeds from the frozen ghost labels over residual cross arcs (``ghost +
    1``) and the sink; propagates at ``hop_cost`` through residual intra
    arcs to the fixpoint, which is idempotent once reached, so one loop
    until no region changes equals the per-region loops.
    """
    K, V, E = cf.shape
    dinf = torch.as_tensor(d_inf, dtype=_I32,
                           device=cf.device).broadcast_to((K,))[:, None]
    cross = emask & ~intra
    seed_ok = cross & (cf > 0) & (ghost_d < dinf[..., None])
    base = torch.where(seed_ok, ghost_d + 1, INF_LABEL).amin(dim=-1)
    sink_lab = 0 if hop_cost == 0 else 1
    base = torch.where(sink_cf > 0, torch.clamp_max(base, sink_lab), base)
    base = torch.where(vmask, base, INF_LABEL)
    gidx = flat_gather_index(nbr_local)
    resid = intra & emask & (cf > 0)
    lab = base
    while True:
        nlab = torch.where(resid, lab.reshape(-1)[gidx].view(K, V, E),
                           INF_LABEL)
        relaxed = torch.minimum(base, nlab.amin(dim=-1) + hop_cost)
        relaxed = torch.minimum(lab, torch.where(vmask, relaxed, INF_LABEL))
        changed = bool((relaxed != lab).any())
        lab = relaxed
        if not changed:
            break
    return torch.minimum(lab, dinf)


def gap_new_labels(d, vmask, is_boundary, d_inf: int, *, cap: int,
                   ard: bool) -> torch.Tensor:
    """Labels after the global gap heuristic (Sec. 5.1).

    If no member vertex carries label g (0 < g <= max member label), every
    vertex labelled above g (and below ``d_inf``) cannot reach the sink and
    goes to ``d_inf``.  Members: valid vertices below ``d_inf``, and for
    ARD only boundary vertices.  All on the device, no sync.
    """
    member = vmask & (d < d_inf)
    if ard:
        member = member & is_boundary
    vals = torch.where(member, d, 0).reshape(-1)
    w = member.reshape(-1).to(_I32)
    hist = torch.zeros(cap, dtype=_I32, device=d.device).index_add_(
        0, vals.clamp(0, cap - 1).long(), w)
    idx = torch.arange(cap, dtype=_I32, device=d.device)
    max_lab = torch.where(member, d, 0).amax()
    is_gap = ((hist == 0) & (idx >= 1)
              & (idx <= torch.clamp_max(max_lab, cap - 1)))
    g = torch.where(is_gap, idx, INF_LABEL).amin()
    return torch.where(vmask & (d > g) & (d < d_inf),
                       torch.full_like(d, d_inf), d)


def global_gap(meta: GraphMeta, state: FlowState, *, ard: bool) -> FlowState:
    """Global gap heuristic (Sec. 5.1): boundary-label histogram for ARD,
    all vertices for PRD."""
    d_inf = meta.d_inf_ard if ard else meta.d_inf_prd
    cap = min(d_inf + 1, GAP_HIST_CAP)
    new_d = gap_new_labels(state.d, state.vmask, state.is_boundary, d_inf,
                           cap=cap, ard=ard)
    return state.replace(d=new_d)
