"""The port's kernel module against the JAX reference, bit for bit.

On the CPU each wrapper takes its plain PyTorch version; those are held
here against the reference's Pallas kernels in interpret mode and against
the reference's oracles.  The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import push_relabel as jpr
from repro.kernels import ref as jref
from repro_torch.kernels import push_relabel as tpr
from repro_torch.kernels import ref as tref


def _regions(K, V, E, seed):
    """Random int32 regions (not necessarily consistent networks): both
    packages only need to see the same bits."""
    rng = np.random.RandomState(seed)
    mk = lambda *s, hi: rng.randint(0, hi, s).astype(np.int32)
    return dict(
        lab=mk(K, V, hi=8), cf=mk(K, V, E, hi=50), sink_cf=mk(K, V, hi=20),
        excess=mk(K, V, hi=40), nbr=mk(K, V, E, hi=V),
        rev_slot=mk(K, V, E, hi=E),
        intra=(rng.rand(K, V, E) < 0.8).astype(np.int32),
        pushable=(rng.rand(K, V, E) < 0.9).astype(np.int32),
        cross_lab=mk(K, V, E, hi=6),
        vmask=(rng.rand(K, V) < 0.95).astype(np.int32))


T = lambda a: torch.from_numpy(np.array(a))
PHASE_ARGS = ("lab", "cf", "sink_cf", "excess", "nbr", "intra", "pushable",
              "cross_lab")
FUSED_ARGS = ("lab", "cf", "sink_cf", "excess", "nbr", "rev_slot", "intra",
              "pushable", "cross_lab", "vmask")
FUSED_OUTS = ("cf", "sink_cf", "excess", "lab", "out_push", "sink_pushed",
              "relabel_sum", "iters")


@pytest.mark.parametrize("mode", ["both", "push", "relabel"])
@pytest.mark.parametrize("V,E", [(16, 4), (33, 5), (64, 8)])
def test_phase_plain_matches_pallas_interpret(V, E, mode):
    K = 2
    r = _regions(K, V, E, seed=V + E)
    d_inf = np.asarray([V + 2, 5], np.int32)
    delta, new_lab = tpr.push_relabel_phase_plain(
        *(T(r[a]) for a in PHASE_ARGS), T(d_inf), mode=mode)
    assert (delta is None) == (mode == "relabel")
    assert (new_lab is None) == (mode == "push")
    for k in range(K):
        want_d, want_l = jpr.push_relabel_phase(
            *(jnp.asarray(r[a][k]) for a in PHASE_ARGS), int(d_inf[k]),
            block_v=8, interpret=True, mode=mode)
        if delta is not None:
            assert delta.dtype == torch.int32
            np.testing.assert_array_equal(delta[k].numpy(),
                                          np.asarray(want_d))
        if new_lab is not None:
            assert new_lab.dtype == torch.int32
            np.testing.assert_array_equal(new_lab[k].numpy(),
                                          np.asarray(want_l))


def test_phase_wrapper_on_cpu_is_plain_and_counts_nothing():
    r = _regions(3, 16, 4, seed=1)
    tpr.reset_launch_counts()
    args = [T(r[a]) for a in PHASE_ARGS]
    got = tpr.push_relabel_phase(*args, 18, mode="both")
    want = tpr.push_relabel_phase_plain(*args, 18, mode="both")
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert tpr.launch_counts() == {"fused_engine_run_batched": 0,
                                   "push_relabel_phase": 0}


def _check_fused(got, want, what):
    for name, x, y in zip(FUSED_OUTS, got, want):
        assert x.dtype == torch.int32, (what, name)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("sink_open", [True, False])
def test_fused_plain_matches_pallas_interpret(sink_open):
    """All 8 outputs, mixed per-region budgets (one region at 0)."""
    K, V, E = 3, 16, 4
    r = _regions(K, V, E, seed=0)
    limit = np.asarray([5, 0, 9], np.int32)
    d_inf = np.asarray([18, 18, 7], np.int32)
    got = tpr.fused_engine_run_batched_plain(
        *(T(r[a]) for a in FUSED_ARGS), T(d_inf), T(limit),
        sink_open=sink_open)
    want = jpr.fused_engine_run_batched(
        *(jnp.asarray(r[a]) for a in FUSED_ARGS), jnp.asarray(d_inf),
        jnp.asarray(limit), sink_open=sink_open, interpret=True)
    _check_fused(got, want, "fused")
    assert int(got[-1][1]) == 0


def _consistent_regions():
    """Two valid region networks (true reverse slots, zero labels) built by
    the reference: the engine provably converges on them, so the in-kernel
    early exit is reached before the budget."""
    from repro.core.graph import build, intra_mask
    from repro.data.grids import random_sparse

    p = random_sparse(24, 48, seed=4)
    part = np.repeat(np.arange(2), 12)
    _, st, _ = build(p, part)
    intra = np.asarray(intra_mask(st))
    return dict(
        lab=np.zeros((2, 12), np.int32), cf=np.asarray(st.cf),
        sink_cf=np.asarray(st.sink_cf), excess=np.asarray(st.excess),
        nbr=np.asarray(st.nbr_local), rev_slot=np.asarray(st.rev_slot),
        intra=intra.astype(np.int32), pushable=intra.astype(np.int32),
        cross_lab=np.zeros_like(np.asarray(st.nbr_local)),
        vmask=np.asarray(st.vmask).astype(np.int32))


def test_fused_plain_early_exit_matches_pallas_interpret():
    r = _consistent_regions()
    limit = np.asarray([1000, 1000], np.int32)
    got = tpr.fused_engine_run_batched_plain(
        *(T(r[a]) for a in FUSED_ARGS), 14, T(limit))
    want = jpr.fused_engine_run_batched(
        *(jnp.asarray(r[a]) for a in FUSED_ARGS), 14, jnp.asarray(limit),
        interpret=True)
    _check_fused(got, want, "early exit")
    iters = got[-1]
    assert (iters > 0).all() and (iters < 1000).all()
    # converged: no active vertex left in either region
    assert not ((got[2] > 0) & (got[3] < 14) & (T(r["vmask"]) != 0)).any()


def test_fused_wrapper_on_cpu_is_plain_and_counts_nothing():
    r = _regions(2, 16, 4, seed=9)
    tpr.reset_launch_counts()
    args = [T(r[a]) for a in FUSED_ARGS]
    got = tpr.fused_engine_run_batched(*args, 18, 4)
    want = tpr.fused_engine_run_batched_plain(*args, 18, 4)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert sum(tpr.launch_counts().values()) == 0


@pytest.mark.parametrize("V,E", [(16, 4), (33, 5)])
def test_iteration_refs_match_reference_oracles(V, E):
    """The port's torch oracles equal the reference's jnp oracles."""
    r = _regions(1, V, E, seed=11 * V + E)
    one = {k: v[0] for k, v in r.items()}
    rng = np.random.RandomState(V)
    emask = rng.rand(V, E) < 0.9
    cross_pushable = rng.rand(V, E) < 0.5
    b = lambda a: np.asarray(a) != 0
    targs = (T(one["cf"]), T(one["sink_cf"]), T(one["excess"]),
             T(one["lab"]), T(one["nbr"]))
    jargs = tuple(jnp.asarray(a) for a in (one["cf"], one["sink_cf"],
                                           one["excess"], one["lab"],
                                           one["nbr"]))
    masks = (b(one["intra"]), emask, b(one["vmask"]))
    d, l = tref.push_relabel_iteration_ref(
        *targs, *(T(m) for m in masks), T(one["cross_lab"]),
        T(cross_pushable), V + 2)
    jd, jl = jref.push_relabel_iteration_ref(
        *jargs, None, *(jnp.asarray(m) for m in masks),
        jnp.asarray(one["cross_lab"]), jnp.asarray(cross_pushable), V + 2)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    for sink_open in (True, False):
        got = tref.fused_iteration_ref(
            *targs, T(one["rev_slot"]), *(T(m) for m in masks),
            T(one["cross_lab"]), T(cross_pushable), V + 2,
            sink_open=sink_open)
        want = jref.fused_iteration_ref(
            *jargs, jnp.asarray(one["rev_slot"]),
            *(jnp.asarray(m) for m in masks), jnp.asarray(one["cross_lab"]),
            jnp.asarray(cross_pushable), V + 2, sink_open=sink_open)
        for i, (x, y) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                          err_msg=f"output {i}")


def test_fused_iteration_matches_torch_oracle():
    """One step of the plain fused loop (``limit`` 1) equals the
    independent torch oracle, region by region."""
    K, V, E = 3, 33, 5
    r = _regions(K, V, E, seed=5)
    got = tpr.fused_engine_run_batched_plain(
        *(T(r[a]) for a in FUSED_ARGS), V + 2, 1)
    assert got[-1].tolist() == [1] * K
    b = lambda a: T(a) != 0
    for k in range(K):
        want = tref.fused_iteration_ref(
            T(r["cf"][k]), T(r["sink_cf"][k]), T(r["excess"][k]),
            T(r["lab"][k]), T(r["nbr"][k]), T(r["rev_slot"][k]),
            b(r["intra"][k]), b(r["pushable"][k]), b(r["vmask"][k]),
            T(r["cross_lab"][k]), b(r["pushable"][k]), V + 2)
        for i in range(7):           # outputs 0-4 per region, 5-6 scalars
            np.testing.assert_array_equal(got[i][k].numpy(),
                                          want[i].numpy(),
                                          err_msg=f"region {k} {FUSED_OUTS[i]}")
