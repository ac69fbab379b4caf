"""Push/relabel kernels of the port: wrappers, plain versions, launch counts.

Two hand-written Hopper kernels (``csrc/``) replace the reference's Pallas
kernels on the main path:

* ``fused_engine_run_batched`` (``csrc/fused_engine.cu``, kernel A) runs
  up to ``iter_limit`` complete push/relabel iterations of every region in
  one launch, one thread block per region, with a per-region early exit.
  Replaces ``repro/kernels/push_relabel.py::fused_engine_run_batched``.
* ``push_relabel_phase`` (``csrc/push_relabel_phase.cu``, kernel B) is one
  compute phase of the unfused engine, one thread per row of ``[K*V]``:
  the excess split ``delta [K, V, 1+E]`` (sink in column 0) and/or the
  relabel target ``new_lab [K, V]``.  Replaces
  ``repro/kernels/push_relabel.py::push_relabel_phase``.

Each wrapper takes its plain PyTorch version (``*_plain``, beside it) when
its tensors lie on the CPU, and only then; on a CUDA tensor it launches the
kernel or raises.  ``LAUNCHES`` counts the kernel launches each wrapper
made (plain calls do not count).

All values are int32; masks are 0/1 int32 for the kernels (the plain
versions also take bool).  ``d_inf``/``iter_limit`` are an int or an
int32 ``[K]`` vector (one per region).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

INF_LABEL = 2**30
MODES = ("both", "push", "relabel")
_I32 = torch.int32

LAUNCHES = {"fused_engine_run_batched": 0, "push_relabel_phase": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _per_region(x, K: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_I32, device=device).broadcast_to(
        (K,)).contiguous()


def flat_gather_index(nbr: torch.Tensor) -> torch.Tensor:
    """i64[K*V*E] flat ``[K*V]`` index of every arc's (region-local)
    destination."""
    K, V, _ = nbr.shape
    off = torch.arange(K, device=nbr.device, dtype=torch.int64) * V
    return (off[:, None, None] + nbr.long()).reshape(-1)


# --------------------------------------------------------------------------
# shared plain building blocks (the reference's jnp expressions, batched)
# --------------------------------------------------------------------------

def _neighbour_labels(lab, gidx, intra, pushable, cross_lab):
    nlab = torch.where(intra, lab.reshape(-1)[gidx].view(cross_lab.shape),
                       cross_lab)
    return torch.where(pushable, nlab, INF_LABEL)


def _push_delta(lab, cf, sink, avail, nlab, act):
    """Admissibility and the exclusive-prefix-sum split of ``avail``:
    ``(delta [K,V,1+E], adm [K,V,E], sink_adm [K,V])``."""
    adm = (cf > 0) & (lab[..., None] == nlab + 1) & act[..., None]
    sink_adm = (sink > 0) & (lab == 1) & act
    caps = torch.cat([torch.where(sink_adm, sink, 0)[..., None],
                      torch.where(adm, cf, 0)], dim=-1)
    cum_excl = torch.cumsum(caps, dim=-1, dtype=_I32) - caps
    delta = torch.minimum(torch.clamp_min(avail[..., None] - cum_excl, 0),
                          caps)
    return delta, adm, sink_adm


def _relabel_target(lab, cf, sink, nlab, act, d_inf):
    """Post-push relabel: 1 + min residual neighbour label, capped at
    ``d_inf`` and never below ``lab``, for active vertices without an
    admissible arc."""
    adm = (cf > 0) & (lab[..., None] == nlab + 1) & act[..., None]
    sink_adm = (sink > 0) & (lab == 1) & act
    no_adm = act & ~adm.any(dim=-1) & ~sink_adm
    cand = torch.where(cf > 0, nlab + 1, INF_LABEL).amin(dim=-1)
    cand = torch.where(sink > 0, torch.clamp_max(cand, 1), cand)
    return torch.where(no_adm, torch.maximum(torch.minimum(cand, d_inf), lab),
                       lab)


# --------------------------------------------------------------------------
# kernel B: one compute phase of the unfused engine
# --------------------------------------------------------------------------

def push_relabel_phase_plain(lab, cf, sink_cf, excess, nbr, intra, pushable,
                             cross_lab, d_inf, *, mode: str = "both"):
    """Plain PyTorch version of kernel B (the reference's ``_phase_xla``).

    Inputs are pre-gated as in the reference: ``pushable`` already folds
    the cross/emask gate, inactive vertices have zero excess, a closed sink
    is a zero ``sink_cf``.  Returns ``(delta, new_lab)``; ``mode`` "push"
    drops ``new_lab`` and "relabel" drops ``delta`` (``None``).
    """
    _check_mode(mode)
    K = cf.shape[0]
    dinf = _per_region(d_inf, K, cf.device)[:, None]
    nlab = _neighbour_labels(lab, flat_gather_index(nbr), intra != 0,
                             pushable != 0, cross_lab)
    act = (excess > 0) & (lab < dinf)
    delta = new_lab = None
    if mode != "relabel":
        delta, _, _ = _push_delta(lab, cf, sink_cf,
                                  torch.where(act, excess, 0), nlab, act)
    if mode != "push":
        new_lab = _relabel_target(lab, cf, sink_cf, nlab, act, dinf)
    return delta, new_lab


_PHASE_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _phase_lib():
    lib = _build.load("push_relabel_phase")
    if lib.pr_phase_i32.argtypes is None:
        lib.pr_phase_i32.argtypes = _PHASE_ARGS
        lib.pr_phase_i32.restype = ctypes.c_int
    return lib


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown phase mode {mode!r}; expected one of "
                         f"{MODES}")


def _check_args(what, device, shapes: dict, tensors: dict):
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, want {device}")
        if t.dtype != _I32:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes "
                            f"int32 only")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"want {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def push_relabel_phase(lab, cf, sink_cf, excess, nbr, intra, pushable,
                       cross_lab, d_inf, *, mode: str = "both"):
    """Kernel B: one push/relabel compute phase over all ``[K*V]`` rows.

    ``lab/sink_cf/excess [K,V]``, ``cf/nbr/intra/pushable/cross_lab
    [K,V,E]``, masks 0/1 int32.  Same contract as
    :func:`push_relabel_phase_plain`, which it takes for CPU tensors.
    """
    if cf.device.type == "cpu":
        return push_relabel_phase_plain(lab, cf, sink_cf, excess, nbr, intra,
                                        pushable, cross_lab, d_inf, mode=mode)
    _check_mode(mode)
    K, V, E = cf.shape
    dev = cf.device
    dinf = _per_region(d_inf, K, dev)
    kv, kve = (K, V), (K, V, E)
    _check_args("push_relabel_phase", dev,
                dict(lab=kv, sink_cf=kv, excess=kv, cf=kve, nbr=kve,
                     intra=kve, pushable=kve, cross_lab=kve),
                dict(lab=lab, sink_cf=sink_cf, excess=excess, cf=cf, nbr=nbr,
                     intra=intra, pushable=pushable, cross_lab=cross_lab))
    delta = (torch.empty((K, V, 1 + E), dtype=_I32, device=dev)
             if mode != "relabel" else None)
    new_lab = torch.empty_like(lab) if mode != "push" else None
    lib = _phase_lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.pr_phase_i32(
            lab.data_ptr(), cf.data_ptr(), sink_cf.data_ptr(),
            excess.data_ptr(), nbr.data_ptr(), intra.data_ptr(),
            pushable.data_ptr(), cross_lab.data_ptr(), dinf.data_ptr(),
            ptr(delta), ptr(new_lab), K, V, E, MODES.index(mode),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "push_relabel_phase")
    LAUNCHES["push_relabel_phase"] += 1
    return delta, new_lab


# --------------------------------------------------------------------------
# kernel A: k complete fused iterations of every region per launch
# --------------------------------------------------------------------------

def make_fused_iteration(*, nbr, rev_slot, intra, pushable, cross_lab, vmask,
                         d_inf, sink_open: bool):
    """The fused iteration of all K regions as one plain torch function.

    ``iteration(cf, sink_cf, excess, lab) -> (cf, sink_cf, excess, new_lab,
    d_cross, d_sink [K], relabel_inc [K])``: push compute (labels frozen),
    intra-region scatter (reverse arcs at ``nbr*E + rev_slot``, receiver
    excess at ``nbr``) and the relabel on the post-push graph.  The
    reference's ``make_fused_iteration`` batched over regions; masks are
    bool, ``d_inf`` an int32 ``[K]``.
    """
    K, V, E = nbr.shape
    gidx = flat_gather_index(nbr)
    sidx = gidx * E + rev_slot.reshape(-1).long()
    dinf = d_inf[:, None]

    def iteration(cf, sink_cf, excess, lab):
        # ---- push compute (labels frozen) ----
        act = (excess > 0) & (lab < dinf) & vmask
        nlab = _neighbour_labels(lab, gidx, intra, pushable, cross_lab)
        sink = sink_cf if sink_open else torch.zeros_like(sink_cf)
        delta, _, _ = _push_delta(lab, cf, sink, torch.where(act, excess, 0),
                                  nlab, act)
        d_sink, d_arc = delta[..., 0], delta[..., 1:]
        # ---- scatter application (intra reverse arcs + receiver excess) ----
        excess = excess - d_sink - d_arc.sum(dim=-1, dtype=_I32)
        sink_cf = sink_cf - d_sink
        d_intra = torch.where(intra, d_arc, 0)
        cf = cf - d_arc
        cf.view(-1).index_add_(0, sidx, d_intra.reshape(-1))
        excess.view(-1).index_add_(0, gidx, d_intra.reshape(-1))
        # ---- relabel (on the post-push residual graph) ----
        act2 = (excess > 0) & (lab < dinf) & vmask
        sink2 = sink_cf if sink_open else torch.zeros_like(sink_cf)
        new_lab = _relabel_target(lab, cf, sink2, nlab, act2, dinf)
        relabel_inc = torch.where(vmask, new_lab - lab, 0).sum(dim=-1,
                                                                dtype=_I32)
        return (cf, sink_cf, excess, new_lab, d_arc - d_intra,
                d_sink.sum(dim=-1, dtype=_I32), relabel_inc)

    return iteration


def fused_engine_run_batched_plain(lab, cf, sink_cf, excess, nbr, rev_slot,
                                   intra, pushable, cross_lab, vmask, d_inf,
                                   iter_limit, *, sink_open: bool = True):
    """Plain PyTorch version of kernel A: the reference's
    ``_fused_region_loop`` vectorised over K with a per-region run mask.

    A region advances iff it has budget left (``it < iter_limit``) and an
    active vertex, exactly as each region's in-kernel loop does.  Returns
    ``(cf, sink_cf, excess, lab, out_push, sink_pushed [K], relabel_sum
    [K], iters [K])``.
    """
    K = cf.shape[0]
    dev = cf.device
    dinf = _per_region(d_inf, K, dev)
    limit = _per_region(iter_limit, K, dev)
    vm = vmask != 0
    iteration = make_fused_iteration(
        nbr=nbr, rev_slot=rev_slot, intra=intra != 0, pushable=pushable != 0,
        cross_lab=cross_lab, vmask=vm, d_inf=dinf, sink_open=sink_open)
    out_push = torch.zeros_like(cf)
    sp = torch.zeros(K, dtype=_I32, device=dev)
    rs = torch.zeros_like(sp)
    it = torch.zeros_like(sp)
    while True:
        run = (it < limit) & ((excess > 0) & (lab < dinf[:, None])
                              & vm).any(dim=1)
        if not bool(run.any()):
            break
        ncf, nsink, nexc, nlab, d_cross, d_sink, rinc = iteration(
            cf, sink_cf, excess, lab)
        w3, w2 = run[:, None, None], run[:, None]
        cf = torch.where(w3, ncf, cf)
        sink_cf = torch.where(w2, nsink, sink_cf)
        excess = torch.where(w2, nexc, excess)
        lab = torch.where(w2, nlab, lab)
        out_push = out_push + torch.where(w3, d_cross, 0)
        sp = sp + torch.where(run, d_sink, 0)
        rs = rs + torch.where(run, rinc, 0)
        it = it + run.to(_I32)
    return cf, sink_cf, excess, lab, out_push, sp, rs, it


_FUSED_ARGS = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _fused_lib():
    lib = _build.load("fused_engine")
    if lib.fused_engine_i32.argtypes is None:
        lib.fused_engine_i32.argtypes = _FUSED_ARGS
        lib.fused_engine_i32.restype = ctypes.c_int
    return lib


def fused_engine_run_batched(lab, cf, sink_cf, excess, nbr, rev_slot, intra,
                             pushable, cross_lab, vmask, d_inf, iter_limit, *,
                             sink_open: bool = True):
    """Kernel A: all regions, up to ``iter_limit`` iterations each, in one
    launch.  Same contract as :func:`fused_engine_run_batched_plain`, which
    it takes for CPU tensors.  Masks are 0/1 int32."""
    if cf.device.type == "cpu":
        return fused_engine_run_batched_plain(
            lab, cf, sink_cf, excess, nbr, rev_slot, intra, pushable,
            cross_lab, vmask, d_inf, iter_limit, sink_open=sink_open)
    K, V, E = cf.shape
    dev = cf.device
    dinf = _per_region(d_inf, K, dev)
    limit = _per_region(iter_limit, K, dev)
    kv, kve = (K, V), (K, V, E)
    _check_args("fused_engine_run_batched", dev,
                dict(lab=kv, sink_cf=kv, excess=kv, vmask=kv, cf=kve,
                     nbr=kve, rev_slot=kve, intra=kve, pushable=kve,
                     cross_lab=kve),
                dict(lab=lab, sink_cf=sink_cf, excess=excess, vmask=vmask,
                     cf=cf, nbr=nbr, rev_slot=rev_slot, intra=intra,
                     pushable=pushable, cross_lab=cross_lab))
    # the kernel updates the state in place: start from copies
    cf_o, sink_o, exc_o, lab_o = (cf.clone(), sink_cf.clone(),
                                  excess.clone(), lab.clone())
    out_push = torch.zeros_like(cf)
    sp, rs, it = (torch.empty(K, dtype=_I32, device=dev) for _ in range(3))
    d_intra = torch.empty_like(cf)          # scratch: this iteration's
    new_lab = torch.empty_like(lab)         # intra deltas and relabels
    lib = _fused_lib()
    with torch.cuda.device(dev):
        err = lib.fused_engine_i32(
            nbr.data_ptr(), rev_slot.data_ptr(), intra.data_ptr(),
            pushable.data_ptr(), cross_lab.data_ptr(), vmask.data_ptr(),
            dinf.data_ptr(), limit.data_ptr(),
            cf_o.data_ptr(), sink_o.data_ptr(), exc_o.data_ptr(),
            lab_o.data_ptr(), out_push.data_ptr(),
            sp.data_ptr(), rs.data_ptr(), it.data_ptr(),
            d_intra.data_ptr(), new_lab.data_ptr(),
            K, V, E, int(bool(sink_open)),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused_engine_run_batched")
    LAUNCHES["fused_engine_run_batched"] += 1
    return cf_o, sink_o, exc_o, lab_o, out_push, sp, rs, it
