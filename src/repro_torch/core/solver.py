"""Solver sessions: prepared problem handles and the solve front end (port
of ``repro.core.solver``, host-loop route).

``Solver(options).prepare(problem, part)`` blocks the problem once on the
host and moves its state onto ``options.device``; ``handle.solve()`` runs
the parallel ARD sweeps and returns a :class:`MincutResult` whose cut is
certified (cut cost == flow) when ``options.check`` is set.

There is no fallback that hides the device or the kernels: the default
``device="cuda"`` raises where there is no card, and a kernel failure
propagates (the reference's degradation ladder is not ported).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core import dtypes as _dt
from repro_torch.core import graph as _graph
from repro_torch.core.executor import not_ported
from repro_torch.core import invariants as _inv
from repro_torch.core import partition as _partition
from repro_torch.core import sweep as _sweep
from repro_torch.core.graph import FlowState, GraphMeta, Layout, Problem


@dataclass
class MincutResult:
    flow_value: int                 # maximum preflow value == mincut cost
    source_side: np.ndarray         # bool[n] vertex in the source set C
    stats: _sweep.SweepStats
    meta: GraphMeta
    state: FlowState
    layout: Layout
    converged: bool = True          # False: max_sweeps ran out; the cut
    #                                 certificate was not checked
    diagnosis: _inv.NonConvergence | None = None


@dataclass(frozen=True)
class SolverOptions:
    """Every solver knob, with the reference's fields and defaults except
    ``engine_backend`` (default ``"cuda"``: a default solve on the card
    goes through the Hopper kernels) and the extra ``device``.

    The sweep/engine knobs mirror ``sweep.SweepConfig``.  Options of routes
    not ported yet raise ``NotImplementedError`` naming their ROADMAP item;
    a ``dtype_policy`` other than ``"int32"`` raises ``ValueError``.
    """

    # --- sweep/engine knobs (mirror sweep.SweepConfig) ---
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
    # --- session knobs ---
    num_regions: int = 4
    check: bool = True
    warm_labels: bool | str = "auto"
    dtype_policy: str = "int32"
    autotune: bool = False
    # --- sharded-route knobs ---
    exchange: str = "full"
    # --- streaming-route knobs ---
    streaming: bool = False
    max_resident_regions: int = 2
    spill_dir: str | None = None
    prefetch: bool = True
    # --- port ---
    device: str = "cuda"

    def __post_init__(self):
        if self.warm_labels not in (True, False, "auto", "keep", "reset"):
            raise ValueError(f"unknown warm_labels {self.warm_labels!r}")
        if self.exchange not in ("full", "boundary"):
            raise ValueError(f"unknown exchange {self.exchange!r}")
        _dt.check_policy(self.dtype_policy)
        if self.autotune:
            raise not_ported("autotune", "queue 1, item 9")
        if self.streaming:
            raise not_ported("streaming", "queue 1, item 11")
        self.sweep_config()     # delegate knob validation to SweepConfig

    def sweep_config(self) -> _sweep.SweepConfig:
        """The ``SweepConfig`` view consumed by the sweep driver."""
        names = {f.name for f in dataclasses.fields(_sweep.SweepConfig)}
        return _sweep.SweepConfig(**{n: getattr(self, n) for n in names})

    @classmethod
    def from_sweep_config(cls, cfg: _sweep.SweepConfig | None = None,
                          **session_kw) -> "SolverOptions":
        kw = dataclasses.asdict(cfg) if cfg is not None else {}
        kw.update(session_kw)
        return cls(**kw)


def _finish(meta: GraphMeta, state0: FlowState, state: FlowState,
            layout: Layout, stats: _sweep.SweepStats, check: bool,
            offset: int = 0, *, converged: bool = True, ard: bool = True,
            max_sweeps: int | None = None) -> MincutResult:
    """Extract the cut and package a result.

    ``check`` verifies that the cut's cost in the initial network equals
    the flow value (a converged solve whose certificate fails raises
    ``CertificateError``); a solve stopped at ``max_sweeps`` skips the
    certificate and carries a ``NonConvergence`` diagnosis instead.
    """
    sink_side = _sweep.extract_cut(meta, state)
    flow = int(state.flow_to_t) - offset
    diagnosis = None
    if not converged:
        diagnosis = _inv.diagnose(
            meta, state, ard=ard, reason="max_sweeps", sweeps=stats.sweeps,
            max_sweeps=max_sweeps, flow_value=flow)
    elif check:
        cost = int(_sweep.cut_value(meta, state0, sink_side))
        if cost != flow:
            raise _inv.CertificateError(
                f"internal error: cut cost {cost} != max preflow {flow}",
                _inv.diagnose(meta, state, ard=ard, reason="certificate",
                              sweeps=stats.sweeps, max_sweeps=max_sweeps,
                              flow_value=flow, cut_cost=cost))
    source_flat = ~layout.to_flat(sink_side.cpu().numpy())
    return MincutResult(flow_value=flow, source_side=source_flat,
                        stats=stats, meta=meta, state=state, layout=layout,
                        converged=converged, diagnosis=diagnosis)


class ProblemHandle:
    """A prepared problem inside a ``Solver`` session: the one-time build
    (``meta``/``layout``), the device state, and the initial network
    (``state0``) the cut certificate prices cuts against."""

    def __init__(self, solver: "Solver", problem: Problem, part: np.ndarray,
                 meta: GraphMeta, state: FlowState, layout: Layout):
        self.solver = solver
        self.problem = problem
        self.part = part
        self.meta = meta
        self.layout = layout
        self.state = state
        self.state0 = state
        self.warm = False            # a solved preflow is resident

    def update(self, **kw) -> "ProblemHandle":
        raise not_ported("warm-start updates (handle.update)",
                         "queue 1, item 6")

    def solve(self, *, mesh=None, axes=("regions",), checkpoint=None,
              resume_from=None, on_sweep=None) -> MincutResult:
        """Solve the prepared problem on the host-loop driver.

        A cold solve starts from the paper's ``Init``; a second solve of a
        solved handle continues from its preflow and labels.
        ``on_sweep(state, sweeps_done)`` fires at every sweep boundary.
        """
        if mesh is not None:
            raise not_ported("the sharded route (mesh=)", "queue 1, item 13")
        if checkpoint is not None or resume_from is not None:
            raise not_ported("checkpoint/resume", "queue 1, item 10")
        opts = self.solver.options
        cfg = opts.sweep_config()
        st_in = self.state if self.warm \
            else _graph.init_labels(self.meta, self.state)
        st, stats = _sweep.solve(self.meta, st_in, cfg, warm=True,
                                 on_sweep=on_sweep)
        self.state = st
        self.warm = True
        return _finish(self.meta, self.state0, st, self.layout, stats,
                       opts.check, converged=stats.converged, ard=True,
                       max_sweeps=cfg.max_sweeps)


class Solver:
    """A solver session: one ``SolverOptions``; ``prepare`` a problem once,
    then ``solve`` its handle."""

    def __init__(self, options: SolverOptions | None = None, **overrides):
        if options is None:
            options = SolverOptions(**overrides)
        elif overrides:
            options = dataclasses.replace(options, **overrides)
        self.options = options

    def prepare(self, problem: Problem,
                part: np.ndarray | None = None) -> ProblemHandle:
        """Region-block a problem once onto ``options.device``.

        ``part`` — region id per vertex; defaults to node-number slicing
        into ``options.num_regions`` regions.  A CUDA device that is not
        there raises.
        """
        device = _graph.resolve_device(self.options.device)
        if self.options.check:
            _graph.validate_problem(problem, context="problem",
                                    dtype_policy=self.options.dtype_policy)
        if part is None:
            part = _partition.block_partition(problem.num_vertices,
                                              self.options.num_regions)
        part = np.asarray(part)
        meta, state, layout = _graph.build(problem, part, device=device)
        return ProblemHandle(self, problem, part, meta, state, layout)

    def solve(self, problem: Problem, part: np.ndarray | None = None, *,
              mesh=None) -> MincutResult:
        """One-shot convenience: ``prepare(problem, part).solve()``."""
        return self.prepare(problem, part).solve(mesh=mesh)

    def solve_many(self, items, parts=None, **kw):
        raise not_ported("batched solves (solve_many)", "queue 1, item 7")
