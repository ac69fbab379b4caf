"""The port's engine against the JAX reference engine, bit for bit: state,
``out_push``, iteration counts and launch accounting of
``push_relabel_batched`` on every path, plus ``bfs_to_targets`` and the
compute phase."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import engine as jeng
from repro_torch.core import engine as teng

K, V, E = 3, 16, 4


def _regions(seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s, hi: rng.randint(0, hi, s).astype(np.int32)
    return dict(
        cf=mk(K, V, E, hi=50), sink_cf=mk(K, V, hi=20),
        excess=mk(K, V, hi=40), lab=mk(K, V, hi=8),
        nbr_local=mk(K, V, E, hi=V), rev_slot=mk(K, V, E, hi=E),
        intra=rng.rand(K, V, E) < 0.8, emask=rng.rand(K, V, E) < 0.9,
        vmask=rng.rand(K, V) < 0.95,
        cross_pushable=rng.rand(K, V, E) < 0.5,
        cross_lab=mk(K, V, E, hi=6))


def _consistent(seed):
    """Three valid region networks built by the reference (true reverse
    slots, zero labels): the engine converges on them without a cap."""
    from repro.core.graph import build, intra_mask
    from repro.data.grids import random_sparse

    p = random_sparse(36, 80, seed=seed)
    _, st, _ = build(p, np.repeat(np.arange(3), 12))
    intra = np.array(intra_mask(st))
    return dict(
        cf=np.array(st.cf), sink_cf=np.array(st.sink_cf),
        excess=np.array(st.excess), lab=np.zeros((3, 12), np.int32),
        nbr_local=np.array(st.nbr_local), rev_slot=np.array(st.rev_slot),
        intra=intra, emask=np.array(st.emask), vmask=np.array(st.vmask),
        cross_pushable=np.zeros_like(intra),
        cross_lab=np.zeros_like(np.array(st.nbr_local)))


STATE = ("cf", "sink_cf", "excess", "lab")
TOPO = ("nbr_local", "rev_slot", "intra", "emask", "vmask",
        "cross_pushable", "cross_lab")
# (port backend, chunk) -> the reference backend with the same accounting
ROUTES = [("torch", None, "xla"), ("cuda", None, "pallas"),
          ("torch", 1, "xla"), ("torch", 8, "xla"),
          ("cuda", 1, "pallas"), ("cuda", 8, "pallas")]


def _run_both(r, backend, chunk, jbackend, d_inf, max_iters):
    got = teng.push_relabel_batched(
        *(torch.from_numpy(r[a]) for a in STATE),
        **{a: torch.from_numpy(r[a]) for a in TOPO}, d_inf=d_inf,
        max_iters=max_iters, backend=backend, chunk_iters=chunk)
    want = jeng.push_relabel_batched(
        *(jnp.asarray(r[a]) for a in STATE),
        **{a: jnp.asarray(r[a]) for a in TOPO}, d_inf=d_inf,
        max_iters=max_iters, backend=jbackend, chunk_iters=chunk,
        interpret=True)
    for name, x, y in zip(want._fields, got, want):
        assert x.dtype == torch.int32, name
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=f"field {name}")
    return got


@pytest.mark.parametrize("backend,chunk,jbackend", ROUTES,
                         ids=[f"{b}-{c}" for b, c, _ in ROUTES])
def test_push_relabel_batched_matches_reference(backend, chunk, jbackend):
    """Random regions under an iteration cap (their labelings can be
    invalid forever): every field, launches included."""
    got = _run_both(_regions(5), backend, chunk, jbackend, V + 2, 16)
    assert int(got.iters.max()) == 16


@pytest.mark.parametrize("backend,chunk,jbackend", ROUTES,
                         ids=[f"{b}-{c}" for b, c, _ in ROUTES])
def test_push_relabel_batched_converges_like_reference(backend, chunk,
                                                       jbackend):
    """Valid regions run to convergence, with the early exit mid-chunk."""
    got = _run_both(_consistent(2), backend, chunk, jbackend, 14, None)
    iters = got.iters.tolist()
    assert min(iters) > 0 and len(set(iters)) > 1
    if chunk is None:
        assert int(got.launches) == 2 * sum(iters)
    elif backend == "cuda":
        assert int(got.launches) == max(-(-i // chunk) for i in iters)
    else:
        assert int(got.launches) == sum(iters)


def test_per_region_budget_and_ceiling():
    """Per-region ``d_inf`` vectors reach the engine as in the reference."""
    r = _regions(8)
    d_inf = np.asarray([18, 4, 9], np.int32)
    _run_both(r, "torch", 8, "xla", d_inf, 12)
    _run_both(r, "torch", None, "xla", d_inf, 12)


@pytest.mark.parametrize("sink_open", [True, False])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_make_phase_matches_reference(backend, sink_open):
    r = _regions(3)
    kw = {a: r[a] for a in ("nbr_local", "intra", "emask", "vmask",
                            "cross_pushable", "cross_lab")}
    phase = teng.make_phase(
        backend, **{a: torch.from_numpy(v) for a, v in kw.items()},
        d_inf=V + 2, sink_open=sink_open)
    delta, _ = phase(*(torch.from_numpy(r[a]) for a in
                       ("lab", "cf", "sink_cf", "excess")), mode="push")
    _, new_lab = phase(*(torch.from_numpy(r[a]) for a in
                         ("lab", "cf", "sink_cf", "excess")), mode="relabel")
    for k in range(K):
        jphase = jeng.make_phase(
            "xla", **{a: jnp.asarray(v[k]) for a, v in kw.items()},
            d_inf=V + 2, sink_open=sink_open)
        jd, jl = jphase(*(jnp.asarray(r[a][k]) for a in
                          ("lab", "cf", "sink_cf", "excess")))
        np.testing.assert_array_equal(delta[k].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(new_lab[k].numpy(), np.asarray(jl))


@pytest.mark.parametrize("sink_open", [True, False])
def test_bfs_to_targets_matches_reference(sink_open):
    r = _consistent(6)
    rng = np.random.RandomState(1)
    target = rng.rand(*r["cf"].shape) < 0.2
    linf = np.asarray([14, 14, 9], np.int32)
    got = teng.bfs_to_targets(
        torch.from_numpy(r["cf"]), torch.from_numpy(r["sink_cf"]),
        nbr_local=torch.from_numpy(r["nbr_local"]),
        intra=torch.from_numpy(r["intra"]), emask=torch.from_numpy(r["emask"]),
        vmask=torch.from_numpy(r["vmask"]),
        target_cross=torch.from_numpy(target), linf=torch.from_numpy(linf),
        sink_open=sink_open)
    want = jax.vmap(lambda cf, s, nl, it, em, vm, tc, li: jeng.bfs_to_targets(
        cf, s, nbr_local=nl, intra=it, emask=em, vmask=vm, target_cross=tc,
        linf=li, sink_open=sink_open))(
        *(jnp.asarray(a) for a in (r["cf"], r["sink_cf"], r["nbr_local"],
                                   r["intra"], r["emask"], r["vmask"],
                                   target, linf)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < linf[:, None]).any()


def test_unknown_backend_raises():
    r = _regions(0)
    with pytest.raises(ValueError, match="backend"):
        teng.push_relabel_batched(
            *(torch.from_numpy(r[a]) for a in STATE),
            **{a: torch.from_numpy(r[a]) for a in TOPO}, d_inf=V + 2,
            max_iters=4, backend="pallas")
