"""Synthetic maxflow instance generators (paper Sec. 7.1).

Copies of the reference generators (``repro/data/grids.py``), built on the
port's ``Problem``: the same seed gives the same instance bit for bit.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Problem

# paper Sec. 7.1 displacement list (pairs added symmetrically)
_DISPLACEMENTS = [
    (0, 1), (1, 0), (1, 2), (2, 1), (1, 3), (3, 1), (2, 3), (3, 2),
    (0, 2), (2, 0), (2, 2), (3, 3), (3, 4), (4, 2),
]


def connectivity_offsets(connectivity: int) -> list[tuple[int, int]]:
    assert connectivity % 2 == 0 and connectivity <= 2 * len(_DISPLACEMENTS)
    return _DISPLACEMENTS[: connectivity // 2]


def synthetic_grid(height: int, width: int, *, connectivity: int = 8,
                   strength: int = 150, excess_mag: int = 500,
                   seed: int = 0) -> Problem:
    """Paper Sec. 7.1 synthetic 2D problem."""
    rng = np.random.RandomState(seed)
    n = height * width
    vid = np.arange(n).reshape(height, width)
    edges = []
    for dy, dx in connectivity_offsets(connectivity):
        dst = vid[dy:, dx:]
        edges.append(np.stack(
            [vid[: height - dy, : width - dx].reshape(-1),
             dst.reshape(-1)], axis=1))
    edges = np.concatenate(edges, axis=0).astype(np.int64)
    m = len(edges)
    cap = np.full(m, strength, dtype=np.int32)
    term = rng.randint(-excess_mag, excess_mag + 1, size=n)
    excess = np.where(term > 0, term, 0).astype(np.int32)
    sink_cap = np.where(term < 0, -term, 0).astype(np.int32)
    return Problem(num_vertices=n, edges=edges, cap_fwd=cap.copy(),
                   cap_bwd=cap.copy(), excess=excess, sink_cap=sink_cap)


def segmentation_grid(height: int, width: int, *, seed: int = 0,
                      smoothness: int = 20, depth: int = 1) -> Problem:
    """Vision-style segmentation instance: noisy foreground disk unaries +
    contrast-modulated pairwise terms (stands in for the BJ01/BF06 family of
    Table 1)."""
    rng = np.random.RandomState(seed)
    n = height * width * depth
    yy, xx = np.mgrid[:height, :width]
    cy, cx, r = height / 2, width / 2, min(height, width) / 3
    fg = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    noise = rng.randint(0, 15, size=(height, width))
    exc2d = np.where(fg, 30 + noise, 0)
    snk2d = np.where(~fg, 30 + noise, 0)
    vid = np.arange(n).reshape(depth, height, width)
    edges = []
    for dz, dy, dx in [(0, 0, 1), (0, 1, 0), (1, 0, 0)][: (3 if depth > 1 else 2)]:
        a = vid[: depth - dz or None, : height - dy or None, : width - dx or None]
        b = vid[dz:, dy:, dx:]
        edges.append(np.stack([a.reshape(-1), b.reshape(-1)], axis=1))
    edges = np.concatenate(edges, axis=0).astype(np.int64)
    cap = rng.randint(1, smoothness + 1, size=len(edges)).astype(np.int32)
    excess = np.tile(exc2d.reshape(-1), depth).astype(np.int32)
    sink_cap = np.tile(snk2d.reshape(-1), depth).astype(np.int32)
    return Problem(num_vertices=n, edges=edges, cap_fwd=cap.copy(),
                   cap_bwd=cap.copy(), excess=excess, sink_cap=sink_cap)


def segmentation_seeds_grid(height: int, width: int, *, seed: int = 0,
                            smoothness: int = 20,
                            seed_strength: int = 200) -> Problem:
    """Interactive-segmentation instance: SPARSE scribble terminals.

    A foreground scribble (small disk at the center) carries source mass, a
    background scribble (the image border frame) carries sink capacity, and
    all flow travels across the 4-connected grid between them, crossing
    many region boundaries.
    """
    rng = np.random.RandomState(seed)
    n = height * width
    yy, xx = np.mgrid[:height, :width]
    cy, cx, r = height / 2, width / 2, min(height, width) / 3
    fg_seed = ((yy - cy) ** 2 + (xx - cx) ** 2 < (r / 3) ** 2)
    bg_seed = (yy < 2) | (yy >= height - 2) | (xx < 2) | (xx >= width - 2)
    exc2d = np.where(fg_seed & ~bg_seed,
                     seed_strength + rng.randint(0, 15, size=(height, width)),
                     0)
    snk2d = np.where(bg_seed,
                     seed_strength + rng.randint(0, 15, size=(height, width)),
                     0)
    vid = np.arange(n).reshape(height, width)
    edges = []
    for dy, dx in [(0, 1), (1, 0)]:
        a = vid[: height - dy or None, : width - dx or None]
        b = vid[dy:, dx:]
        edges.append(np.stack([a.reshape(-1), b.reshape(-1)], axis=1))
    edges = np.concatenate(edges, axis=0).astype(np.int64)
    cap = rng.randint(1, smoothness + 1, size=len(edges)).astype(np.int32)
    return Problem(num_vertices=n, edges=edges, cap_fwd=cap.copy(),
                   cap_bwd=cap.copy(),
                   excess=exc2d.reshape(-1).astype(np.int32),
                   sink_cap=snk2d.reshape(-1).astype(np.int32))


def random_sparse(n: int, m: int, *, cap_mag: int = 100, term_mag: int = 50,
                  seed: int = 0) -> Problem:
    """Random sparse instance (property-test fodder)."""
    rng = np.random.RandomState(seed)
    if n < 2:
        raise ValueError("need n >= 2")
    pairs = set()
    edges = []
    while len(edges) < m:
        u, v = rng.randint(0, n, size=2)
        if u == v or (u, v) in pairs or (v, u) in pairs:
            continue
        pairs.add((u, v))
        edges.append((u, v))
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    cap_f = rng.randint(0, cap_mag + 1, size=len(edges)).astype(np.int32)
    cap_b = rng.randint(0, cap_mag + 1, size=len(edges)).astype(np.int32)
    excess = rng.randint(0, term_mag + 1, size=n).astype(np.int32)
    sink_cap = rng.randint(0, term_mag + 1, size=n).astype(np.int32)
    return Problem(num_vertices=n, edges=edges, cap_fwd=cap_f, cap_bwd=cap_b,
                   excess=excess, sink_cap=sink_cap)
