"""One-shot entry point — a thin shim over the ``Solver`` session (port of
``repro.core.api.solve_mincut``)."""

from __future__ import annotations

import numpy as np

from repro_torch.core import sweep as _sweep
from repro_torch.core.graph import Problem
from repro_torch.core.solver import MincutResult, Solver, SolverOptions


def solve_mincut(problem: Problem, part: np.ndarray | None = None,
                 num_regions: int = 4,
                 config: _sweep.SweepConfig | None = None,
                 check: bool = True, device: str = "cuda") -> MincutResult:
    """Solve MINCUT/MAXFLOW with region discharge sweeps (one-shot):
    ``Solver(...).prepare(problem, part).solve()``."""
    solver = Solver(SolverOptions.from_sweep_config(
        config, num_regions=num_regions, check=check, device=device))
    return solver.prepare(problem, part).solve()
