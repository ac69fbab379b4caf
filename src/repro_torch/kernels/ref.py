"""Pure reference oracles of the port.

* ``maxflow_oracle`` — plain numpy BFS augmenting-path (Edmonds-Karp)
  maxflow on the excess/sink-cap representation (a copy of the reference
  oracle): ground truth for every solver test.
* ``push_relabel_iteration_ref`` — one region's push/relabel compute phase
  in torch, written independently of the kernel wrappers' plain versions.
* ``fused_iteration_ref`` — one complete fused engine iteration (push
  compute, intra-region scatter, post-push relabel) in torch.
* ``attention_ref`` — numerically stable softmax attention with f32
  accumulation and a bottom-right aligned causal mask.

The two push/relabel oracles take one region (``[V, E]`` / ``[V]``) with
bool masks, like their counterparts in ``repro/kernels/ref.py``.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

INF_LABEL = 2**30
_I32 = torch.int32


def maxflow_oracle(problem) -> tuple[int, np.ndarray]:
    """Edmonds-Karp on the terminal-capacity representation.

    Returns (maxflow value, source_side bool[n]) where source_side is the
    minimal source set {v : s -> v in G_f}.
    """
    n = problem.num_vertices
    s, t = n, n + 1
    cap = {}

    def add(u, v, c):
        if c:
            cap[(u, v)] = cap.get((u, v), 0) + int(c)

    for (u, v), cf_, cb_ in zip(problem.edges, problem.cap_fwd,
                                problem.cap_bwd):
        add(int(u), int(v), cf_)
        add(int(v), int(u), cb_)
    for v in range(n):
        add(s, v, problem.excess[v])
        add(v, t, problem.sink_cap[v])

    adj = [[] for _ in range(n + 2)]
    for (u, v) in list(cap.keys()):
        adj[u].append(v)
        adj[v].append(u)
        cap.setdefault((v, u), 0)
    adj = [sorted(set(a)) for a in adj]

    flow = 0
    while True:
        parent = {s: s}
        q = deque([s])
        while q and t not in parent:
            u = q.popleft()
            for v in adj[u]:
                if v not in parent and cap.get((u, v), 0) > 0:
                    parent[v] = u
                    q.append(v)
        if t not in parent:
            break
        path = []
        v = t
        while v != s:
            path.append((parent[v], v))
            v = parent[v]
        aug = min(cap[(u, v)] for u, v in path)
        for u, v in path:
            cap[(u, v)] -= aug
            cap[(v, u)] += aug
        flow += aug
    seen = {s}
    q = deque([s])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if v not in seen and cap.get((u, v), 0) > 0:
                seen.add(v)
                q.append(v)
    side = np.zeros(n, dtype=bool)
    for v in range(n):
        side[v] = v in seen
    return flow, side


def push_relabel_iteration_ref(cf, sink_cf, excess, lab, nbr, intra, emask,
                               vmask, cross_lab, cross_pushable, d_inf):
    """One synchronous push/relabel compute phase of one region.

    Returns ``(delta [V, 1+E] with the sink in column 0, new_lab [V])``:
    the excess split over admissible arcs by an exclusive prefix sum, and
    the relabel target of every active vertex without an admissible arc.
    """
    V, E = cf.shape
    act = (excess > 0) & (lab < d_inf) & vmask
    nlab = torch.where(intra, lab[nbr.long()], cross_lab)
    nlab = torch.where((cross_pushable | intra) & emask, nlab, INF_LABEL)
    adm = (cf > 0) & (lab[:, None] == nlab + 1) & act[:, None]
    sink_adm = (sink_cf > 0) & (lab == 1) & act
    caps = torch.cat([torch.where(sink_adm, sink_cf, 0)[:, None],
                      torch.where(adm, cf, 0)], dim=1)
    avail = torch.where(act, excess, 0)
    delta = torch.zeros_like(caps)
    pushed_before = torch.zeros_like(avail)
    for j in range(E + 1):               # sequential split, column by column
        take = torch.minimum(torch.clamp_min(avail - pushed_before, 0),
                             caps[:, j])
        delta[:, j] = take
        pushed_before = pushed_before + caps[:, j]
    no_adm = act & ~adm.any(dim=1) & ~sink_adm
    cand = torch.where(cf > 0, nlab + 1, INF_LABEL).amin(dim=1)
    cand = torch.where(sink_cf > 0, torch.clamp_max(cand, 1), cand)
    relabel = torch.maximum(torch.clamp_max(cand, d_inf), lab)
    return delta, torch.where(no_adm, relabel, lab)


def fused_iteration_ref(cf, sink_cf, excess, lab, nbr, rev_slot, intra,
                        emask, vmask, cross_lab, cross_pushable, d_inf,
                        sink_open: bool = True):
    """One complete fused engine iteration of one region.

    Push compute (labels frozen) -> scatter of the deltas (reverse arcs and
    receiver excess for intra arcs; cross flow goes to ``out_push``) ->
    relabel on the post-push residual graph.  Returns ``(cf, sink_cf,
    excess, new_lab, out_push, sink_pushed, relabel_sum)``.
    """
    V, E = cf.shape
    sink = sink_cf if sink_open else torch.zeros_like(sink_cf)
    delta, _ = push_relabel_iteration_ref(
        cf, sink, excess, lab, nbr, intra, emask, vmask, cross_lab,
        cross_pushable, d_inf)
    d_sink, d_arc = delta[:, 0], delta[:, 1:]
    d_intra = torch.where(intra, d_arc, 0)
    cf = (cf - d_arc).clone()
    excess = (excess - d_sink - d_arc.sum(dim=1, dtype=_I32)).clone()
    nb = nbr.long()
    rv = rev_slot.long()
    for e in range(E):                   # explicit scatter, slot by slot
        cf.view(-1).index_put_((nb[:, e] * E + rv[:, e],), d_intra[:, e],
                               accumulate=True)
        excess.index_put_((nb[:, e],), d_intra[:, e], accumulate=True)
    sink_cf = sink_cf - d_sink
    sink2 = sink_cf if sink_open else torch.zeros_like(sink_cf)
    _, new_lab = push_relabel_iteration_ref(
        cf, sink2, excess, lab, nbr, intra, emask, vmask, cross_lab,
        cross_pushable, d_inf)
    relabel_sum = torch.where(vmask, new_lab - lab, 0).sum(dtype=_I32)
    return (cf, sink_cf, excess, new_lab, d_arc - d_intra,
            d_sink.sum(dtype=_I32), relabel_sum)


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: float | None = None):
    """Numerically-stable reference attention (f32 accumulation).

    q ``[..., Tq, D]``, k/v ``[..., Tk, D]`` with the same leading dims;
    the causal mask is aligned bottom-right (query i sees key j iff
    ``j <= i + Tk - Tq``).  A row that sees no key gets the ``-1e30`` fill's
    uniform average, as in the reference.
    """
    qf, kf, vf = (x.float() for x in (q, k, v))
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    logits = torch.einsum("...qd,...kd->...qk", qf, kf) * scale
    if causal:
        Tq, Tk = logits.shape[-2:]
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        logits = torch.where(mask, logits, -1e30)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("...qk,...kd->...qd", probs, vf).to(q.dtype)
