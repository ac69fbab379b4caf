"""PyTorch/CUDA port of the region-discharge maxflow solver.

A second package beside the JAX reference ``repro``: the same layout
(``core``, ``data``, ``kernels``), the same results bit for bit, and the
TPU kernels replaced by hand-written Hopper kernels (``csrc/``).  The port
imports torch, numpy and the standard library only.

Main path::

    from repro_torch.core.solver import Solver, SolverOptions
    res = Solver(SolverOptions(engine_chunk_iters=8)).prepare(p, part).solve()

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper takes its plain PyTorch version.
"""
