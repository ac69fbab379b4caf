"""The port's host layer against the JAX reference, bit for bit: instance
generators, partitioners, ``build`` and the numpy carry-across of states."""

import dataclasses

import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import partition as jpart
from repro.data import grids as jgrids
from repro_torch.core import graph as tgraph
from repro_torch.core import partition as tpart
from repro_torch.data import grids as tgrids

GENERATORS = [
    ("synthetic_grid", (12, 12), dict(connectivity=8, strength=120, seed=1)),
    ("synthetic_grid", (9, 7), dict(connectivity=4, seed=3)),
    ("segmentation_grid", (16, 16), dict(seed=0)),
    ("segmentation_grid", (6, 5), dict(seed=2, depth=3)),
    ("segmentation_seeds_grid", (16, 16), dict(seed=0)),
    ("random_sparse", (14, 28), dict(seed=0)),
]


def _same_problem(a, b):
    assert a.num_vertices == b.num_vertices
    for f in ("edges", "cap_fwd", "cap_bwd", "excess", "sink_cap"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name,args,kw", GENERATORS,
                         ids=[f"{g[0]}{g[1]}" for g in GENERATORS])
def test_generators_match_reference(name, args, kw):
    _same_problem(getattr(tgrids, name)(*args, **kw),
                  getattr(jgrids, name)(*args, **kw))


def test_partitions_match_reference():
    np.testing.assert_array_equal(tpart.grid_partition((12, 10), (3, 2)),
                                  jpart.grid_partition((12, 10), (3, 2)))
    np.testing.assert_array_equal(tpart.block_partition(23, 4),
                                  jpart.block_partition(23, 4))
    p = tgrids.random_sparse(24, 60, seed=7)
    np.testing.assert_array_equal(
        tpart.bfs_partition(p.num_vertices, p.edges, 3, seed=1),
        jpart.bfs_partition(p.num_vertices, p.edges, 3, seed=1))


INSTANCES = [
    ("synthetic_grid", (12, 12), dict(connectivity=8, strength=120, seed=1),
     lambda n: tpart.grid_partition((12, 12), (2, 2))),
    ("segmentation_seeds_grid", (16, 16), dict(seed=0),
     lambda n: tpart.grid_partition((16, 16), (2, 2))),
    ("random_sparse", (14, 28), dict(seed=0),
     lambda n: tpart.block_partition(n, 3)),
    ("random_sparse", (5, 0), dict(seed=0),
     lambda n: tpart.block_partition(n, 2)),
]


def _jax_state_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in tgraph.STATE_FIELDS}


@pytest.mark.parametrize("name,args,kw,mkpart", INSTANCES,
                         ids=[f"{i[0]}{i[1]}" for i in INSTANCES])
def test_build_matches_reference(name, args, kw, mkpart):
    p = getattr(tgrids, name)(*args, **kw)
    part = mkpart(p.num_vertices)
    tmeta, tstate, tlay = tgraph.build(p, part, device="cpu")
    jmeta, jstate, jlay = jgraph.build(getattr(jgrids, name)(*args, **kw),
                                       part)
    for f in dataclasses.fields(tmeta):
        assert getattr(tmeta, f.name) == getattr(jmeta, f.name), f.name
    want = _jax_state_numpy(jstate)
    got = tgraph.state_to_numpy(tstate)
    for f in tgraph.STATE_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        assert got[f].shape == want[f].shape, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in dataclasses.fields(tlay):
        np.testing.assert_array_equal(getattr(tlay, f.name),
                                      getattr(jlay, f.name), err_msg=f.name)
    np.testing.assert_array_equal(tgraph.intra_mask(tstate).numpy(),
                                  np.asarray(jgraph.intra_mask(jstate)))


def test_state_numpy_round_trip():
    p = jgrids.synthetic_grid(10, 10, connectivity=8, seed=4)
    part = jpart.grid_partition((10, 10), (2, 2))
    _, jstate, _ = jgraph.build(p, part)
    arrays = _jax_state_numpy(jstate)
    arrays["d"] = np.arange(arrays["d"].size, dtype=np.int32).reshape(
        arrays["d"].shape)
    arrays["flow_to_t"] = np.asarray(123, np.int32)
    st = tgraph.state_from_numpy(arrays, "cpu")
    assert st.flow_to_t.shape == () and int(st.flow_to_t) == 123
    back = tgraph.state_to_numpy(st)
    for f, a in arrays.items():
        assert back[f].dtype == a.dtype and back[f].shape == a.shape, f
        np.testing.assert_array_equal(back[f], a, err_msg=f)
    arrays["cf"] = arrays["cf"].astype(np.int64)
    with pytest.raises(TypeError):
        tgraph.state_from_numpy(arrays, "cpu")


def test_validate_problem_matches_reference():
    p = tgrids.random_sparse(8, 12, seed=1)
    tgraph.validate_problem(p)
    bad = dataclasses.replace(p, cap_fwd=p.cap_fwd.copy())
    bad.cap_fwd[0] = -1
    with pytest.raises(tgraph.ProblemValidationError, match="negative"):
        tgraph.validate_problem(bad)
    big = dataclasses.replace(p, excess=np.full(8, 2**29, np.int32))
    with pytest.raises(tgraph.ProblemValidationError):
        tgraph.validate_problem(big)
    with pytest.raises(ValueError, match="item 9"):
        tgraph.validate_problem(p, dtype_policy="auto")
