"""The whole slice against the JAX reference, bit for bit:
``Solver(...).prepare(problem, part).solve()`` on the CPU (each kernel
wrapper takes its plain version there) against the reference session on
the instances of ``tests/test_maxflow_solvers.py``: flow, cut, residuals,
labels, sweeps, engine iterations and launches, host syncs, byte counters
and the per-sweep curves; plus the maxflow oracle, the sweep bound, a
solve continued from a mid-solve reference state, and the refusals."""

import functools

import numpy as np
import pytest

from repro.core import sweep as jsweep
from repro.core.solver import Solver as JSolver
from repro.core.solver import SolverOptions as JOptions
from repro_torch.core import graph as tgraph
from repro_torch.core import invariants as tinv
from repro_torch.core import partition as tpart
from repro_torch.core import sweep as tsweep
from repro_torch.core.api import solve_mincut
from repro_torch.core.solver import Solver, SolverOptions
from repro_torch.data import grids
from repro_torch.kernels.ref import maxflow_oracle


def _bfs(n, m, seed):
    p = grids.random_sparse(n, m, seed=seed)
    return p, tpart.bfs_partition(n, p.edges, 3, seed=1)


INSTANCES = {
    "sparse0": lambda: (grids.random_sparse(14, 28, seed=0),
                        tpart.block_partition(14, 3)),
    "grid16": lambda: (grids.synthetic_grid(16, 16, connectivity=8,
                                            strength=120, seed=1),
                       tpart.grid_partition((16, 16), (2, 2))),
    "seg20": lambda: (grids.segmentation_grid(20, 20, seed=0),
                      tpart.block_partition(400, 4)),
    "bfs24": lambda: _bfs(24, 60, 7),
    "single10": lambda: (grids.random_sparse(10, 20, seed=3),
                         tpart.block_partition(10, 1)),
    "noedges5": lambda: (grids.random_sparse(5, 0, seed=0),
                         tpart.block_partition(5, 2)),
}
ROUTES = [("torch", None), ("cuda", None), ("torch", 8), ("cuda", 8)]
# the reference route whose launch accounting each port route keeps
ACCOUNTING = {("torch", None): ("xla", None), ("cuda", None): ("xla", None),
              ("torch", 8): ("xla", 8), ("cuda", 8): ("pallas", 8)}
STATS = ("sweeps", "engine_iters", "engine_launches", "host_syncs",
         "boundary_bytes", "page_bytes", "num_boundary",
         "regions_discharged", "flow_curve", "active_curve", "converged")
MUTABLE = ("cf", "sink_cf", "excess", "d", "flow_to_t")


@functools.lru_cache(maxsize=None)
def _reference(name, backend, chunk):
    p, part = INSTANCES[name]()
    return JSolver(JOptions(engine_backend=backend,
                            engine_chunk_iters=chunk)).prepare(p, part).solve()


def _same_state(got_state, want_state, what):
    got = tgraph.state_to_numpy(got_state)
    for f in MUTABLE:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want_state,
                                                                  f)),
                                      err_msg=f"{what}: {f}")


@pytest.mark.parametrize("backend,chunk", ROUTES,
                         ids=[f"{b}-{c}" for b, c in ROUTES])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_solve_matches_reference(name, backend, chunk):
    p, part = INSTANCES[name]()
    res = Solver(SolverOptions(engine_backend=backend,
                               engine_chunk_iters=chunk,
                               device="cpu")).prepare(p, part).solve()
    ref = _reference(name, "xla", None)
    assert res.flow_value == ref.flow_value
    np.testing.assert_array_equal(res.source_side, ref.source_side)
    _same_state(res.state, ref.state, name)
    for f in STATS:
        if f != "engine_launches":
            assert getattr(res.stats, f) == getattr(ref.stats, f), f
    acc = _reference(name, *ACCOUNTING[(backend, chunk)])
    assert res.stats.engine_launches == acc.stats.engine_launches
    assert res.stats.host_syncs == 1 + res.stats.sweeps
    want, _ = maxflow_oracle(p)
    assert res.flow_value == want
    assert tinv.check_sweep_bound(res.meta, res.stats) == []
    assert res.stats.sweeps <= 2 * res.meta.num_boundary ** 2 + 1


def test_solve_from_mid_solve_reference_state():
    """Both packages continue from the same mid-solve state (carried
    across with ``state_from_numpy``) and finish identically."""
    p, part = INSTANCES["grid16"]()
    jopts = JOptions(engine_backend="xla")
    handle = JSolver(jopts).prepare(p, part)
    seen = {}

    def grab(state, sweeps):
        if sweeps == 2:
            seen["state"] = state
    handle.solve(on_sweep=grab)
    jmid = seen["state"]
    arrays = {f: np.asarray(getattr(jmid, f)) for f in tgraph.STATE_FIELDS}
    tmeta, _, _ = tgraph.build(p, part, device="cpu")
    for backend, chunk in (("cuda", 8), ("torch", None)):
        st, stats = tsweep.solve(
            tmeta, tgraph.state_from_numpy(arrays, "cpu"),
            tsweep.SweepConfig(engine_backend=backend,
                               engine_chunk_iters=chunk), warm=True)
        jst, jstats = jsweep.solve(
            handle.meta, jmid,
            jsweep.SweepConfig(engine_backend="xla"), warm=True)
        _same_state(st, jst, f"{backend}-{chunk}")
        assert stats.sweeps == jstats.sweeps >= 1
        assert stats.engine_iters == jstats.engine_iters
        assert stats.flow_curve == jstats.flow_curve
        assert stats.active_curve == jstats.active_curve


@pytest.mark.parametrize("gap", [True, False])
def test_partial_discharge_and_gap_options_match_reference(gap):
    """Sec. 6.2 partial discharges (stage cap = sweep - 1) and the solve
    without the global gap heuristic, against the reference."""
    p, part = INSTANCES["grid16"]()
    kw = dict(partial_discharge=gap, use_global_gap=not gap)
    res = Solver(SolverOptions(engine_backend="cuda", engine_chunk_iters=8,
                               device="cpu", **kw)).prepare(p, part).solve()
    ref = JSolver(JOptions(engine_backend="xla", **kw)).prepare(
        p, part).solve()
    _same_state(res.state, ref.state, str(kw))
    for f in STATS:
        if f != "engine_launches":
            assert getattr(res.stats, f) == getattr(ref.stats, f), f
    assert res.flow_value == ref.flow_value


def test_stopped_solve_reports_like_reference():
    """A solve cut at ``max_sweeps`` carries the same diagnosis as the
    reference's; a broken state names its broken invariant."""
    p, part = INSTANCES["grid16"]()
    res = Solver(SolverOptions(engine_backend="torch", max_sweeps=1,
                               device="cpu")).prepare(p, part).solve()
    ref = JSolver(JOptions(engine_backend="xla", max_sweeps=1)).prepare(
        p, part).solve()
    assert not res.converged and not ref.converged
    _same_state(res.state, ref.state, "max_sweeps=1")
    assert res.diagnosis.active_vertices == ref.diagnosis.active_vertices > 0
    assert res.diagnosis.violations == [] == ref.diagnosis.violations
    bad = res.state.replace(cf=res.state.cf.clone())
    bad.cf[0, 0, 0] = -1
    assert "negative_residual" in [
        v.kind for v in tinv.invariant_report(res.meta, bad)]


def test_solve_mincut_shim_and_second_solve():
    p, part = INSTANCES["sparse0"]()
    res = solve_mincut(p, part=part, device="cpu",
                       config=tsweep.SweepConfig(engine_backend="torch"))
    assert res.flow_value == _reference("sparse0", "xla", None).flow_value
    handle = Solver(device="cpu").prepare(p, part)
    first = handle.solve()
    again = handle.solve()        # warm: nothing left to discharge
    assert again.flow_value == first.flow_value
    assert again.stats.sweeps == 0 and again.stats.host_syncs == 1


def test_cuda_device_without_card_raises():
    """The default device is the card; where torch sees none, preparing a
    problem raises instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    p, part = INSTANCES["sparse0"]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver(device="cuda").prepare(p, part)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver().prepare(p, part)


@pytest.mark.parametrize("kw,item", [
    (dict(method="prd"), "item 5"), (dict(parallel=False), "item 5"),
    (dict(use_boundary_relabel=True), "item 5"),
    (dict(device_resident=True), "item 4"), (dict(autotune=True), "item 9"),
    (dict(streaming=True), "item 11")])
def test_unported_options_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        SolverOptions(device="cpu", **kw)


def test_unported_routes_name_their_roadmap_item():
    with pytest.raises(ValueError, match="item 9"):
        SolverOptions(dtype_policy="auto")
    p, part = INSTANCES["noedges5"]()
    h = Solver(device="cpu").prepare(p, part)
    with pytest.raises(NotImplementedError, match="item 13"):
        h.solve(mesh=object())
    with pytest.raises(NotImplementedError, match="item 6"):
        h.update(cap_fwd=p.cap_fwd)
    with pytest.raises(NotImplementedError, match="item 7"):
        Solver(device="cpu").solve_many([p])
