"""Host-side graph partitioners (the paper's ``splitter`` tool, Sec. 5.3).

The paper slices regular grids into s equal parts per dimension and falls
back to node-number slicing for irregular graphs; both are provided, plus a
BFS-grown balanced partitioner for generic sparse graphs.
"""

from __future__ import annotations

import numpy as np


def grid_partition(shape: tuple[int, ...], splits: tuple[int, ...]) -> np.ndarray:
    """Partition an N-D grid of vertices into a grid of regions.

    ``shape``  — grid extents, vertex id = row-major raveling.
    ``splits`` — number of slices per dimension; K = prod(splits).
    """
    assert len(shape) == len(splits)
    idx = np.indices(shape)  # [ndim, *shape]
    region = np.zeros(shape, dtype=np.int64)
    for d, (extent, s) in enumerate(zip(shape, splits)):
        bounds = (idx[d] * s) // extent          # 0..s-1 per dimension
        region = region * s + bounds
    return region.reshape(-1)


def block_partition(num_vertices: int, num_regions: int) -> np.ndarray:
    """Paper's node-number slicing (used for KZ2/LB06 instances)."""
    if num_vertices == 0:
        return np.zeros(0, dtype=np.int64)
    per = -(-num_vertices // num_regions)
    return np.minimum(np.arange(num_vertices) // per, num_regions - 1)


def bfs_partition(num_vertices: int, edges: np.ndarray, num_regions: int,
                  seed: int = 0) -> np.ndarray:
    """Balanced BFS-grown regions for irregular graphs.

    Grows regions breadth-first from spread-out seeds with a per-region size
    cap — a cheap, dependency-free stand-in for METIS that keeps boundaries
    small on mesh-like graphs.
    """
    rng = np.random.RandomState(seed)
    cap = -(-num_vertices // num_regions)
    # adjacency (undirected)
    adj_head = [[] for _ in range(num_vertices)]
    for u, v in edges:
        adj_head[u].append(v)
        adj_head[v].append(u)
    part = np.full(num_vertices, -1, dtype=np.int64)
    sizes = np.zeros(num_regions, dtype=np.int64)
    from collections import deque
    queues = []
    seeds = rng.permutation(num_vertices)[:num_regions]
    for r, s in enumerate(seeds):
        queues.append(deque([int(s)]))
    remaining = num_vertices
    while remaining:
        progressed = False
        for r in range(num_regions):
            if sizes[r] >= cap:
                continue
            q = queues[r]
            while q:
                v = q.popleft()
                if part[v] == -1:
                    part[v] = r
                    sizes[r] += 1
                    remaining -= 1
                    progressed = True
                    for w in adj_head[v]:
                        if part[w] == -1:
                            q.append(w)
                    break
        if not progressed:
            # disconnected leftovers: round-robin to the emptiest regions
            for v in range(num_vertices):
                if part[v] == -1:
                    r = int(np.argmin(sizes))
                    part[v] = r
                    sizes[r] += 1
                    remaining -= 1
            break
    return part
