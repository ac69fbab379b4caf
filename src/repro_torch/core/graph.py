"""Region-partitioned flow-network representation (port of ``repro.core.graph``).

Vertices are stored region-blocked, padded to a common region size ``V``;
adjacency is a padded ELL layout ``[K, V, E]``; the source is eliminated by
the paper's ``Init`` (per-vertex ``excess``) and the sink is an implicit
0-labelled vertex behind a per-vertex terminal capacity ``sink_cf``.  Every
directed residual arc (u, v) lives in u's row, so a cross-region arc lives
in the sender's region and its reverse in the receiver's.

``build`` runs on the host in numpy, exactly as the reference does, and
moves its result onto ``device`` at the end.  All capacities are int32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import dtypes as _dt

INF_LABEL = _dt.INF_LABEL_WIDE
INF_CAP = 2 ** 30


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; a CUDA device that is not
    there raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclass(frozen=True)
class GraphMeta:
    """Static (host-side) metadata for a region-partitioned network."""

    num_regions: int          # K
    region_size: int          # V  (padded per-region vertex count)
    max_degree: int           # E  (padded per-vertex arc slots)
    num_vertices: int         # n  (true, unpadded)
    num_boundary: int         # |B|  (vertices incident to inter-region arcs)
    num_cross_arcs: int       # X  (directed inter-region arcs, padded table)
    num_ghost_groups: int     # distinct (region, adjacent-ghost) pairs
    d_inf_ard: int            # |B|      (ARD label ceiling, paper Sec. 4.1)
    d_inf_prd: int            # n        (PRD label ceiling, paper Sec. 2)
    label_dtype: str = "int32"
    flow_dtype: str = "int32"
    mask_dtype: str = "int32"


# field -> numpy dtype of the state; the order is the reference's
STATE_FIELDS = {
    "nbr_region": np.int32, "nbr_local": np.int32, "rev_slot": np.int32,
    "emask": np.bool_, "vmask": np.bool_, "is_boundary": np.bool_,
    "cross_src": np.int32, "cross_dst": np.int32, "cross_group": np.int32,
    "cross_valid": np.bool_,
    "cross_src_arc": np.int32, "cross_dst_arc": np.int32,
    "cross_src_vtx": np.int32, "cross_dst_vtx": np.int32,
    "cf": np.int32, "sink_cf": np.int32, "excess": np.int32, "d": np.int32,
    "flow_to_t": np.int32,
}


@dataclass
class FlowState:
    """Device-resident state of the solver (a dataclass of tensors).

    Shapes: K = num_regions, V = region_size, E = max_degree,
    X = num_cross_arcs.  Integer fields are int32, masks are bool.
    """

    # --- static topology (never mutated) ---
    nbr_region: torch.Tensor    # i32[K,V,E] neighbour's region id
    nbr_local: torch.Tensor     # i32[K,V,E] neighbour's local vertex id
    rev_slot: torch.Tensor      # i32[K,V,E] slot of the reverse arc
    emask: torch.Tensor         # bool[K,V,E] valid arc slot
    vmask: torch.Tensor         # bool[K,V] valid vertex
    is_boundary: torch.Tensor   # bool[K,V] vertex in the boundary set B
    cross_src: torch.Tensor     # i32[X,3] (region, local, slot) of the arc
    cross_dst: torch.Tensor     # i32[X,3] row holding the reverse arc
    cross_group: torch.Tensor   # i32[X]   (src_region, dst_vertex) pair id
    cross_valid: torch.Tensor   # bool[X]  padded-entry mask
    cross_src_arc: torch.Tensor  # i32[X] flat [K*V*E] index of the arc
    cross_dst_arc: torch.Tensor  # i32[X] flat index of the reverse arc
    cross_src_vtx: torch.Tensor  # i32[X] flat [K*V] index of the sender
    cross_dst_vtx: torch.Tensor  # i32[X] flat index of the receiver
    # --- mutable flow state ---
    cf: torch.Tensor            # i32[K,V,E] residual capacity of each arc
    sink_cf: torch.Tensor       # i32[K,V]  residual capacity of the t-link
    excess: torch.Tensor        # i32[K,V]  current excess e_f(v)
    d: torch.Tensor             # i32[K,V]  distance labels
    flow_to_t: torch.Tensor     # i32[]     |f| absorbed by the sink

    def active(self, d_inf) -> torch.Tensor:
        """Active vertices w.r.t. (f, d): positive excess and d < d_inf."""
        return (self.excess > 0) & (self.d < d_inf) & self.vmask

    def replace(self, **kw) -> "FlowState":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.cf.device


@dataclass(frozen=True)
class Problem:
    """Host-side problem description before region blocking."""

    num_vertices: int
    edges: np.ndarray        # i64[m, 2]  undirected pairs (u, v), u != v
    cap_fwd: np.ndarray      # i32[m]     capacity u->v
    cap_bwd: np.ndarray      # i32[m]     capacity v->u
    excess: np.ndarray       # i32[n]     source-side terminal mass
    sink_cap: np.ndarray     # i32[n]     t-link capacity


def _check_problem(p: Problem) -> None:
    n, m = p.num_vertices, len(p.edges)
    assert p.edges.shape == (m, 2)
    assert p.cap_fwd.shape == (m,) and p.cap_bwd.shape == (m,)
    assert p.excess.shape == (n,) and p.sink_cap.shape == (n,)
    assert (p.cap_fwd >= 0).all() and (p.cap_bwd >= 0).all()
    assert (p.excess >= 0).all() and (p.sink_cap >= 0).all()
    if m:
        assert p.edges.min() >= 0 and p.edges.max() < n
        assert (p.edges[:, 0] != p.edges[:, 1]).all(), "self loops not allowed"


class ProblemValidationError(ValueError):
    """A ``Problem`` carries capacities the int32 solver cannot run safely."""


def validate_problem(p: Problem, *, context: str = "problem",
                     dtype_policy: str = "int32") -> None:
    """Reject negative and overflow-risk capacities before they reach the
    int32 flow arithmetic (the reference's checks, int64 host sums):
    shapes, endpoint range, no self loops, non-negative capacities,
    ``cap_fwd + cap_bwd < INF_CAP`` per edge, ``excess + sink_cap <
    INF_CAP`` per vertex, ``sum(excess) < INF_CAP`` and a total capacity
    mass below ``2**31``.
    """
    _dt.check_policy(dtype_policy)
    n, m = p.num_vertices, len(p.edges)

    def fail(msg: str):
        raise ProblemValidationError(f"invalid {context}: {msg}")

    if p.edges.shape != (m, 2):
        fail(f"edges shape {p.edges.shape} != ({m}, 2)")
    if p.cap_fwd.shape != (m,) or p.cap_bwd.shape != (m,):
        fail(f"edge-capacity shapes {p.cap_fwd.shape}/{p.cap_bwd.shape} "
             f"!= ({m},)")
    if p.excess.shape != (n,) or p.sink_cap.shape != (n,):
        fail(f"terminal shapes {p.excess.shape}/{p.sink_cap.shape} != ({n},)")
    if m:
        if p.edges.min() < 0 or p.edges.max() >= n:
            fail("edge endpoint outside [0, num_vertices)")
        if (p.edges[:, 0] == p.edges[:, 1]).any():
            fail("self loop")
    for name, a in (("cap_fwd", p.cap_fwd), ("cap_bwd", p.cap_bwd),
                    ("excess", p.excess), ("sink_cap", p.sink_cap)):
        a = np.asarray(a)
        if a.size and int(a.min()) < 0:
            fail(f"negative {name} (min {int(a.min())}) at index "
                 f"{int(np.argmin(a))}")
    pair = p.cap_fwd.astype(np.int64) + p.cap_bwd.astype(np.int64)
    if m and int(pair.max()) >= INF_CAP:
        i = int(np.argmax(pair))
        fail(f"edge {i}: cap_fwd + cap_bwd = {int(pair[i])} >= INF_CAP "
             f"(2^30) — the shared residual budget of one edge overflows")
    term = p.excess.astype(np.int64) + p.sink_cap.astype(np.int64)
    if n and int(term.max()) >= INF_CAP:
        i = int(np.argmax(term))
        fail(f"vertex {i}: excess + sink_cap = {int(term[i])} >= INF_CAP "
             f"(2^30)")
    total_excess = int(p.excess.astype(np.int64).sum())
    if total_excess >= INF_CAP:
        fail(f"sum(excess) = {total_excess} >= INF_CAP (2^30) — "
             f"accumulated excess / flow_to_t can overflow int32")
    total = (total_excess + int(p.sink_cap.astype(np.int64).sum())
             + int(pair.sum()))
    if total >= 2**31:
        fail(f"total capacity mass {total} >= 2^31 — the int32 cut-cost "
             f"certificate reduction can overflow")


@dataclass(frozen=True)
class Layout:
    """Host-side mapping between flat vertex ids and (region, local) slots."""

    part: np.ndarray        # i64[n] region of each vertex
    local_id: np.ndarray    # i64[n] slot within the region
    edge_arc_u: np.ndarray | None = None   # i64[m] flat arc slot of u->v
    edge_arc_v: np.ndarray | None = None   # i64[m] flat arc slot of v->u
    edge_vtx_u: np.ndarray | None = None   # i64[m] flat vertex slot of u
    edge_vtx_v: np.ndarray | None = None   # i64[m] flat vertex slot of v

    def to_flat(self, arr_kv: np.ndarray) -> np.ndarray:
        """Gather a [K,V] per-slot array back to flat vertex order."""
        return np.asarray(arr_kv)[self.part, self.local_id]


def _stable_cumcount(keys: np.ndarray) -> np.ndarray:
    """Occurrence index of each element among equal values, in array order."""
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
    counts = np.diff(np.r_[starts, n])
    out = np.empty(n, dtype=np.int64)
    out[order] = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
    return out


def _first_occurrence_ids(keys: np.ndarray) -> np.ndarray:
    """Dense ids of the rows of ``keys`` [N, c], numbered in order of first
    occurrence (the ``dict.setdefault(key, len(d))`` loop, vectorised)."""
    _, first, inverse = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[inverse.reshape(-1)]


def build_numpy(problem: Problem, part: np.ndarray
                ) -> tuple[GraphMeta, dict[str, np.ndarray], Layout]:
    """Block a flat problem into the region-partitioned layout, on the host.

    The reference's ``build`` (``repro/core/graph.py``) field for field;
    returns the state as a dict of numpy arrays (``STATE_FIELDS``).
    """
    _check_problem(problem)
    n = problem.num_vertices
    part = np.asarray(part, dtype=np.int64)
    assert part.shape == (n,)
    K = int(part.max()) + 1 if n else 1

    local_id = _stable_cumcount(part)
    region_count = np.bincount(part, minlength=K)
    V = max(1, int(region_count.max()) if n else 0)

    u_arr = problem.edges[:, 0]
    v_arr = problem.edges[:, 1]
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, u_arr, 1)
    np.add.at(deg, v_arr, 1)
    E = max(1, int(deg.max()) if n else 1)

    nbr_region = np.zeros((K, V, E), dtype=np.int32)
    nbr_local = np.zeros((K, V, E), dtype=np.int32)
    rev_slot = np.zeros((K, V, E), dtype=np.int32)
    emask = np.zeros((K, V, E), dtype=bool)
    cf = np.zeros((K, V, E), dtype=np.int32)

    # slots: cumcount over the interleaved (u, v) endpoint sequence
    m = len(problem.edges)
    occ = np.empty(2 * m, dtype=np.int64)
    occ[0::2] = u_arr
    occ[1::2] = v_arr
    cc = _stable_cumcount(occ)
    slot_u, slot_v = cc[0::2], cc[1::2]
    ru, lu = part[u_arr], local_id[u_arr]
    rv, lv = part[v_arr], local_id[v_arr]
    nbr_region[ru, lu, slot_u] = rv.astype(np.int32)
    nbr_local[ru, lu, slot_u] = lv.astype(np.int32)
    rev_slot[ru, lu, slot_u] = slot_v.astype(np.int32)
    emask[ru, lu, slot_u] = True
    cf[ru, lu, slot_u] = problem.cap_fwd
    nbr_region[rv, lv, slot_v] = ru.astype(np.int32)
    nbr_local[rv, lv, slot_v] = lu.astype(np.int32)
    rev_slot[rv, lv, slot_v] = slot_u.astype(np.int32)
    emask[rv, lv, slot_v] = True
    cf[rv, lv, slot_v] = problem.cap_bwd

    vmask = np.zeros((K, V), dtype=bool)
    vmask[part, local_id] = True
    sink_cf = np.zeros((K, V), dtype=np.int32)
    sink_cf[part, local_id] = problem.sink_cap
    excess = np.zeros((K, V), dtype=np.int32)
    excess[part, local_id] = problem.excess

    # boundary set B: endpoints of inter-region edges
    cross_edge = ru != rv
    is_boundary = np.zeros((K, V), dtype=bool)
    if cross_edge.any():
        cu = u_arr[cross_edge]
        cv = v_arr[cross_edge]
        is_boundary[part[cu], local_id[cu]] = True
        is_boundary[part[cv], local_id[cv]] = True
    num_boundary = int(is_boundary.sum())

    # flat directed cross-arc table; arcs come in mutual-reverse pairs at
    # indices (2i, 2i+1)
    idx = np.nonzero(cross_edge)[0]
    a = np.stack([ru[idx], lu[idx], slot_u[idx]], axis=1)
    b = np.stack([rv[idx], lv[idx], slot_v[idx]], axis=1)
    src = np.stack([a, b], axis=1).reshape(-1, 3)
    dst = np.stack([b, a], axis=1).reshape(-1, 3)
    nx = len(src)
    X = max(1, nx)
    cross_src = np.zeros((X, 3), dtype=np.int32)
    cross_dst = np.zeros((X, 3), dtype=np.int32)
    cross_group = np.zeros(X, dtype=np.int32)
    cross_valid = np.zeros(X, dtype=bool)
    num_groups = 1
    if nx:
        cross_src[:nx] = src
        cross_dst[:nx] = dst
        cross_valid[:nx] = True
        keys = np.stack([src[:, 0], dst[:, 0], dst[:, 1]], axis=1)
        ids = _first_occurrence_ids(keys)
        cross_group[:nx] = ids
        num_groups = max(1, int(ids.max()) + 1)

    meta = GraphMeta(
        num_regions=K, region_size=V, max_degree=E, num_vertices=n,
        num_boundary=num_boundary, num_cross_arcs=X,
        num_ghost_groups=num_groups, d_inf_ard=max(1, num_boundary),
        d_inf_prd=max(1, n))
    arc = lambda t: ((t[:, 0].astype(np.int64) * V + t[:, 1]) * E
                     + t[:, 2]).astype(np.int32)
    vtx = lambda t: (t[:, 0].astype(np.int64) * V + t[:, 1]).astype(np.int32)
    arrays = dict(
        nbr_region=nbr_region, nbr_local=nbr_local, rev_slot=rev_slot,
        emask=emask, vmask=vmask, is_boundary=is_boundary,
        cross_src=cross_src, cross_dst=cross_dst, cross_group=cross_group,
        cross_valid=cross_valid,
        cross_src_arc=arc(cross_src), cross_dst_arc=arc(cross_dst),
        cross_src_vtx=vtx(cross_src), cross_dst_vtx=vtx(cross_dst),
        cf=cf, sink_cf=sink_cf, excess=excess,
        d=np.zeros((K, V), dtype=np.int32),
        flow_to_t=np.zeros((), dtype=np.int32))
    layout = Layout(
        part=part, local_id=local_id,
        edge_arc_u=(ru * V + lu) * E + slot_u,
        edge_arc_v=(rv * V + lv) * E + slot_v,
        edge_vtx_u=ru * V + lu,
        edge_vtx_v=rv * V + lv)
    return meta, arrays, layout


def build(problem: Problem, part: np.ndarray, *, device="cuda",
          dtype_policy: str = "int32"
          ) -> tuple[GraphMeta, FlowState, Layout]:
    """Block a flat problem into the region-partitioned device layout.

    Host numpy (``build_numpy``), then one copy of every field onto
    ``device``.
    """
    _dt.check_policy(dtype_policy)
    dev = resolve_device(device)
    meta, arrays, layout = build_numpy(problem, part)
    return meta, state_from_numpy(arrays, dev), layout


def state_from_numpy(arrays: dict, device) -> FlowState:
    """A ``FlowState`` from numpy arrays, one per field (``STATE_FIELDS``).

    The carry-across function between the two packages: a reference
    ``FlowState`` given field by field as numpy arrays becomes the port's,
    bit for bit.
    """
    dev = resolve_device(device)
    out = {}
    for name, dt in STATE_FIELDS.items():
        a = np.asarray(arrays[name])
        if a.dtype != dt:
            raise TypeError(f"field {name}: dtype {a.dtype}, want "
                            f"{np.dtype(dt)}")
        out[name] = torch.as_tensor(np.array(a, order="C"), device=dev)
    return FlowState(**out)


def state_to_numpy(state: FlowState) -> dict[str, np.ndarray]:
    """Inverse of :func:`state_from_numpy`: every field as a numpy array."""
    return {name: getattr(state, name).cpu().numpy()
            for name in STATE_FIELDS}


def init_labels(meta: GraphMeta, state: FlowState) -> FlowState:
    """Paper's ``Init``: d := 0 everywhere (source already eliminated)."""
    return state.replace(d=torch.zeros_like(state.d))


def intra_mask(state: FlowState) -> torch.Tensor:
    """bool[K,V,E] — arc stays within its own region."""
    K = state.nbr_region.shape[0]
    own = torch.arange(K, dtype=state.nbr_region.dtype,
                       device=state.nbr_region.device)[:, None, None]
    return (state.nbr_region == own) & state.emask


def flow_value(state: FlowState) -> torch.Tensor:
    return state.flow_to_t


def ghost_index(state: FlowState) -> torch.Tensor:
    """i64[K*V*E] flat ``[K*V]`` index of every arc's destination
    vertex."""
    V = state.d.shape[1]
    return (state.nbr_region.long() * V + state.nbr_local.long()).reshape(-1)
