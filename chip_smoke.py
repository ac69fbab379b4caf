#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repo root, on the GPU machine

Phases (any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi), and the build of
   every kernel from ``src/repro_torch/csrc`` (one nvcc per source, in
   parallel);
2. kernels: kernel A (``fused_engine_run_batched``) and kernel B
   (``push_relabel_phase``) against their plain PyTorch versions on the
   card, bit for bit, at the main path's shapes and at K=4, V=4096, E=8,
   with mixed budgets, an early exit and every phase mode;
3. main path: ``Solver(...).prepare(problem, part).solve()`` on a
   1024x1024 segmentation image (1,048,576 vertices) cut into 8x8 regions,
   fused engine on kernel A; certificate (cut cost == flow), kernel A's
   launch count == the solve's ``engine_launches``, the same solve with
   the plain "torch" backend (equal flow, state and counters), and the
   flow against scipy's maximum_flow;
4. multi-sweep path: the paper's 128x128 synthetic grid at connectivity 8
   (E = 8) with 4x4 regions, the unfused engine on kernel B against the
   fused engine on kernel A;
5. times: per launch of each kernel and of its plain version at the main
   path's shapes, the solves, and a profiled main-path solve (device time
   by kernel, busy and idle share);
6. flash: the flash-attention kernel against its plain version on the
   card, causal, at the LM slice's shape (bf16, B=1, H=32, S=4096, D=96)
   and at small shapes (f32 and bf16; GQA, MQA, decode, ragged, Sq > Sk);
7. LM forward: phi3-mini-3.8b at full width, all 32 layers, random
   weights from a seeded generator, ``forward(mode="train")`` on B=1,
   S=4096: in f32 the flash forward against the plain ``_sdpa`` forward
   (TF32 off), f32 prefill + decode against the train pass, then the same
   weights in bf16: 32 flash launches per forward, finite logits, time;
8. LM serving: ``greedy_generate`` in bf16, 4 prompts of 512 tokens, 32
   new tokens (prefill ms, ms per decode step, tokens/s), and the same
   run profiled (busy and idle share);
9. times: the flash kernel per launch at the slice's shape against its
   bound, its plain version and SDPA; a profiled bf16 forward (flash
   against matmul device time, busy and idle share).

The last two lines are the card (nvidia-smi) and ``{"ok": true, "device":
{...}}``; the line before them is the kernels' JSON report.  Where torch
sees no card, or the repo's sources are not beside this script, it exits
non-zero without a result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_INT32_OPS_PER_S = 67e12    # 32-bit CUDA-core rate (the fp32 peak)
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
MAIN_SIDE, MAIN_REGIONS = 1024, 8    # 1,048,576 vertices in 8x8 regions
MULTI_SIDE, MULTI_REGIONS = 128, 4   # E = 8, several sweeps
LM_ARCH, LM_SEQ = "phi3-mini-3.8b", 4096     # all 32 layers, full width
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 512, 32


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    err = 0
    for x, y in zip(got, want):
        if x is None and y is None:
            continue
        err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def random_regions(K, V, E, seed, device):
    """Random int32 regions (not consistent networks: the kernels and their
    plain versions only need to see the same bits)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    mk = lambda *s, hi: torch.from_numpy(
        rng.randint(0, hi, s).astype(np.int32)).to(device)
    mask = lambda p, *s: torch.from_numpy(
        (rng.rand(*s) < p).astype(np.int32)).to(device)
    return dict(lab=mk(K, V, hi=8), cf=mk(K, V, E, hi=50),
                sink_cf=mk(K, V, hi=20), excess=mk(K, V, hi=40),
                nbr=mk(K, V, E, hi=V), rev_slot=mk(K, V, E, hi=E),
                intra=mask(0.8, K, V, E), pushable=mask(0.9, K, V, E),
                cross_lab=mk(K, V, E, hi=6), vmask=mask(0.95, K, V))


FUSED_ARGS = ("lab", "cf", "sink_cf", "excess", "nbr", "rev_slot", "intra",
              "pushable", "cross_lab", "vmask")
PHASE_ARGS = ("lab", "cf", "sink_cf", "excess", "nbr", "intra", "pushable",
              "cross_lab")


def first_stage_inputs(problem, part, device):
    """Kernel inputs of the main path's first engine run (sweep 0, stage 0):
    the state as built, BFS labels toward the sink, no cross targets."""
    import torch
    from repro_torch.core import engine, graph
    from repro_torch.core.labels import gather_ghost_labels

    meta, state, _ = graph.build(problem, part, device=device)
    intra = graph.intra_mask(state)
    K, V, E = state.cf.shape
    target = state.emask & ~intra & (gather_ghost_labels(state) <= -1)
    lab0 = engine.bfs_to_targets(
        state.cf, state.sink_cf, nbr_local=state.nbr_local,
        intra=intra, emask=state.emask, vmask=state.vmask,
        target_cross=target, linf=V + 2)
    i32 = lambda m: m.to(torch.int32)
    return dict(lab=lab0, cf=state.cf, sink_cf=state.sink_cf,
                excess=torch.where(state.vmask, state.excess, 0),
                nbr=state.nbr_local, rev_slot=state.rev_slot,
                intra=i32(intra),
                pushable=i32((target | intra) & state.emask),
                cross_lab=torch.zeros_like(state.nbr_local),
                vmask=i32(state.vmask)), V + 2


def check_kernels(cases):
    """Phase 2: every kernel against its plain version, bit for bit."""
    import torch
    from repro_torch.kernels import push_relabel as pr

    err = {"fused_engine_run_batched": 0, "push_relabel_phase": 0}
    iters_of = {}
    for name, r, d_inf, limit in cases:
        K, V, E = r["cf"].shape
        args = [r[a] for a in FUSED_ARGS]
        got = pr.fused_engine_run_batched(*args, d_inf, limit)
        want = pr.fused_engine_run_batched_plain(*args, d_inf, limit)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        iters = iters_of[name] = got[-1].tolist()
        log(f"  kernel A {name} K={K} V={V} E={E}: max_abs_err={e} "
            f"iters min={min(iters)} max={max(iters)}")
        if e != 0:
            raise AssertionError(f"kernel A differs from its plain version "
                                 f"on {name}")
        err["fused_engine_run_batched"] = max(err["fused_engine_run_batched"],
                                              e)
        pargs = [r[a] for a in PHASE_ARGS]
        for mode in pr.MODES:
            got = pr.push_relabel_phase(*pargs, d_inf, mode=mode)
            want = pr.push_relabel_phase_plain(*pargs, d_inf, mode=mode)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            log(f"  kernel B {name} mode={mode}: max_abs_err={e}")
            if e != 0:
                raise AssertionError(f"kernel B ({mode}) differs from its "
                                     f"plain version on {name}")
            err["push_relabel_phase"] = max(err["push_relabel_phase"], e)
    return err, iters_of


def same_solve(a, b, what):
    """Equal flow, cut, final state and every counter but launches."""
    import torch

    if a.flow_value != b.flow_value:
        raise AssertionError(f"{what}: flow {a.flow_value} != "
                             f"{b.flow_value}")
    for f in ("cf", "sink_cf", "excess", "d", "flow_to_t"):
        if not torch.equal(getattr(a.state, f), getattr(b.state, f)):
            raise AssertionError(f"{what}: final {f} differs")
    if not (a.source_side == b.source_side).all():
        raise AssertionError(f"{what}: cut differs")
    for f in ("sweeps", "engine_iters", "host_syncs", "boundary_bytes",
              "page_bytes", "flow_curve", "active_curve", "converged"):
        if getattr(a.stats, f) != getattr(b.stats, f):
            raise AssertionError(f"{what}: {f} {getattr(a.stats, f)} != "
                                 f"{getattr(b.stats, f)}")


def scipy_maxflow(problem) -> int:
    """Maxflow of the same graph by scipy (super source n, sink n+1)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow

    n = problem.num_vertices
    u, v = problem.edges[:, 0], problem.edges[:, 1]
    verts = np.arange(n)
    rows = np.concatenate([u, v, np.full(n, n), verts])
    cols = np.concatenate([v, u, verts, np.full(n, n + 1)])
    caps = np.concatenate([problem.cap_fwd, problem.cap_bwd, problem.excess,
                           problem.sink_cap]).astype(np.int32)
    keep = caps > 0
    g = csr_matrix((caps[keep], (rows[keep], cols[keep])),
                   shape=(n + 2, n + 2), dtype=np.int32)
    return int(maximum_flow(g, n, n + 1).flow_value)


def timed_solve(opts, problem, part):
    import torch
    from repro_torch.core.solver import Solver
    from repro_torch.kernels import push_relabel as pr

    handle = Solver(opts).prepare(problem, part)
    torch.cuda.synchronize()
    pr.reset_launch_counts()
    t0 = time.perf_counter()
    res = handle.solve()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = pr.launch_counts()
    s = res.stats
    log(f"  {opts.engine_backend} chunk={opts.engine_chunk_iters}: "
        f"flow={res.flow_value} sweeps={s.sweeps} "
        f"engine_iters={s.engine_iters} engine_launches={s.engine_launches} "
        f"host_syncs={s.host_syncs} wall_s={sec:.3f} "
        f"kernel_launches={counts}")
    return res, sec, counts


def profile_run(fn, what):
    """``fn()`` once under torch.profiler: device time by kernel and the
    device's busy share of the wall time.  Returns ``(rows, busy_s)``,
    rows ``(device_s, kernel name, count)``; ``busy_s`` is 0 where the
    profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []      # device-side events only (kernels, copies, fills):
    for ev in prof.key_averages():   # host ops repeat their kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e6, ev.key, ev.count))
    busy = sum(r[0] for r in rows)     # one stream: kernels do not overlap
    if busy == 0:
        log(f"  profiled {what}: wall {wall:.3f} s; the profiler saw no "
            f"device time (busy share not measured)")
        return rows, 0.0
    log(f"  profiled {what}: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for sec, key, count in sorted(rows, reverse=True)[:8]:
        log(f"    {sec:9.4f} s {100 * sec / busy:5.1f}%  x{count:<7d} "
            f"{key[:70]}")
    return rows, busy


# --------------------------------------------------------------------------
# LM slice: flash kernel, full-width forward, greedy serving
# --------------------------------------------------------------------------

# B, H, Hkv, Sq, Sk, D: GQA, MQA, decode, ragged, Sq > Sk, D = 128, the
# smoke config's D = 16 and phi3's D = 96
FLASH_SMALL = [(2, 4, 2, 128, 128, 64), (1, 4, 1, 96, 96, 32),
               (1, 2, 1, 1, 128, 32), (1, 1, 1, 37, 53, 16),
               (1, 2, 1, 80, 48, 32), (1, 2, 2, 200, 200, 128),
               (2, 4, 2, 40, 40, 16), (1, 3, 3, 300, 300, 96)]
# f32: the same sums in another order; bf16: one unit in the last place of
# the bf16 output (2^-8 relative)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# f32 logits of the full-width forward, flash kernel against plain _sdpa:
# 32 layers of f32 sums in another order, relative to the largest logit
FORWARD_REL_TOL = 1e-3


def check_flash(dev, slice_shape):
    """Phase 6: the flash kernel against its plain version on the card;
    returns the max abs error at the slice's shape (bf16)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    slice_err = None
    for shape in [slice_shape] + FLASH_SMALL:
        B, H, Hkv, Sq, Sk, D = shape
        dtypes = (["bfloat16"] if shape == slice_shape
                  else ["float32", "bfloat16"])
        for dt in dtypes:
            mk = lambda *s: torch.randn(s, generator=g, device=dev,
                                        dtype=getattr(torch, dt))
            q, k, v = mk(B, H, Sq, D), mk(B, Hkv, Sk, D), mk(B, Hkv, Sk, D)
            got = fa.flash_attention(q, k, v, causal=True)
            want = fa.flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            lim = FLASH_TOL[dt] * (1 + want.float().abs())
            ok = bool((diff <= lim).all())
            log(f"  flash {shape} {dt}: max_abs_err={err:.3g} "
                f"(tol {FLASH_TOL[dt]} abs+rel) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash kernel differs from its plain "
                                     f"version at {shape} {dt}")
            if shape == slice_shape:
                slice_err = err
    return slice_err


def lm_forward(model, tokens):
    """One full-sequence forward; returns (logits, flash launches)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    logits, _ = model({"tokens": tokens}, mode="train")
    torch.cuda.synchronize()
    return logits, fa.launch_counts()["flash_attention"]


def lm_phases(dev, reps):
    """Phases 6-9 of the LM slice; returns the flash kernel's report."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as model_lib
    from repro_torch.train.serve import greedy_generate

    cfg = dataclasses.replace(get_arch(LM_ARCH), use_flash_attention=True)
    L, H, D = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    S = LM_SEQ
    slice_shape = (1, H, cfg.num_kv_heads, S, S, D)

    log(f"[flash] kernel against its plain version (causal) at the slice's "
        f"shape and small shapes")
    slice_err = check_flash(dev, slice_shape)

    # ---- phase 7: full-sequence forward at full width ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = model_lib.init_params(cfg, generator=g, dtype=torch.float32,
                                  device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[forward] {cfg.name}: {L} layers, d_model {cfg.d_model}, {H} "
        f"heads x {D}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params} parameters (f32 init {time.perf_counter() - t0:.1f} s)")
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                           device=dev)
    flash32, n32 = lm_forward(model, tokens)
    if n32 != L:
        raise AssertionError(f"f32 forward launched the flash kernel {n32} "
                             f"times, want {L}")
    model.cfg = dataclasses.replace(cfg, use_flash_attention=False)
    plain32, n_plain = lm_forward(model, tokens)
    model.cfg = cfg
    if n_plain:
        raise AssertionError("the plain _sdpa forward launched the kernel")
    scale = float(plain32.abs().max())
    ferr = float((flash32 - plain32).abs().max())
    log(f"  f32 forward B=1 S={S}: flash (x{n32} launches) against plain "
        f"_sdpa: max_abs_err={ferr:.3g}, max |logit| {scale:.3g}, "
        f"rel {ferr / scale:.3g} (tol {FORWARD_REL_TOL}); TF32 off")
    if not (torch.isfinite(flash32).all() and ferr <= FORWARD_REL_TOL * scale):
        raise AssertionError("f32 flash forward differs from plain _sdpa")
    del flash32, plain32

    # f32 serving against the train pass (tests/test_models_smoke.py:71)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                         device=dev)
    tlog, _ = model({"tokens": toks})
    cache = model_lib.init_cache(cfg, 2, 32, torch.float32, dev)
    plog, cache = model({"tokens": toks[:, :23]}, mode="prefill",
                        cache=cache)
    dlog, cache = model({"tokens": toks[:, 23:]}, mode="decode", cache=cache)
    torch.testing.assert_close(plog, tlog[:, 22], atol=3e-4, rtol=1e-3)
    torch.testing.assert_close(dlog, tlog[:, 23], atol=3e-4, rtol=1e-3)
    log(f"  f32 prefill(23)+decode(1) against the train pass, B=2: max "
        f"abs diff {float((plog - tlog[:, 22]).abs().max()):.3g} / "
        f"{float((dlog - tlog[:, 23]).abs().max()):.3g} (atol 3e-4, "
        f"rtol 1e-3)")
    del tlog, plog, dlog, cache

    model.to(torch.bfloat16)             # the same weights, f32 freed
    torch.cuda.empty_cache()
    _, n16 = lm_forward(model, tokens)           # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, n16 = lm_forward(model, tokens)
        times.append(time.perf_counter() - t0)
    if n16 != L or not torch.isfinite(logits).all():
        raise AssertionError(f"bf16 forward: {n16} flash launches, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    fwd_s = min(times)
    log(f"  bf16 forward B=1 S={S}: {fwd_s * 1e3:.1f} ms (best of "
        f"{[round(t * 1e3, 1) for t in times]} ms), {S / fwd_s:.0f} "
        f"tokens/s, flash launches {n16}, logits finite")
    del logits

    # ---- phase 8: greedy serving at full width, bf16 ----
    B, P, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                            device=dev)

    def serve(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = greedy_generate(model, prompts, steps, P + new)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    serve(2)                                     # warm-up
    first, pre_s = serve(1)
    out, gen_s = serve(new)
    if not torch.equal(out[:, :1], first) or out.shape != (B, new):
        raise AssertionError("greedy generation is not deterministic")
    step_ms = (gen_s - pre_s) / (new - 1) * 1e3
    log(f"[serving] greedy_generate bf16, {B} prompts x {P} tokens, {new} "
        f"new: prefill {pre_s * 1e3:.1f} ms, {step_ms:.2f} ms per decode "
        f"step, {B * new / gen_s:.1f} tokens/s ({gen_s:.3f} s in all)")
    log(f"  sample: {out[0, :12].tolist()}")
    profile_run(lambda: serve(new), "greedy serving")

    # ---- phase 9: times ----
    q, k, v = (torch.randn(1, n, S, D, generator=g, device=dev,
                           dtype=torch.bfloat16)
               for n in (H, cfg.num_kv_heads, cfg.num_kv_heads))
    f_ms = time_ms(lambda: fa.flash_attention(q, k, v), reps)
    f_plain = time_ms(lambda: fa.flash_attention_plain(q, k, v),
                      max(2, reps // 4))
    f_lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=cfg.num_kv_heads != H), reps)
    pairs = S * (S + 1) // 2                 # visible (query, key) pairs
    f_ops = 4 * H * D * pairs
    f_bytes = 2 * (2 * H + 2 * cfg.num_kv_heads) * S * D
    t_ops = f_ops / H100_BF16_FLOP_PER_S * 1e3
    t_bytes = f_bytes / H100_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    log(f"[times] flash at B=1 H={H} S={S} D={D} bf16 causal: {f_ms:.4f} "
        f"ms/launch, plain {f_plain:.4f} ms, SDPA {f_lib:.4f} ms, bound "
        f"{bound:.4f} ms ({f_ops} FLOP, {f_bytes} bytes); "
        f"{100 * bound / f_ms:.1f}% of bound")
    rows, busy = profile_run(lambda: lm_forward(model, tokens),
                             "bf16 forward")
    if busy:
        flash_s = sum(r[0] for r in rows if "flash_fwd" in r[1])
        gemm_s = sum(r[0] for r in rows
                     if any(w in r[1].lower() for w in
                            ("gemm", "nvjet", "xmma", "cutlass")))
        log(f"  forward device time: flash {flash_s:.4f} s "
            f"({100 * flash_s / busy:.1f}%), matmuls {gemm_s:.4f} s "
            f"({100 * gemm_s / busy:.1f}%), other "
            f"{busy - flash_s - gemm_s:.4f} s")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:109",
                launches=n16, max_abs_err=slice_err, ms=f_ms,
                plain_ms=f_plain, bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=f_lib)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per kernel timing")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.partition import grid_partition
    from repro_torch.core.solver import Solver, SolverOptions
    from repro_torch.data.grids import segmentation_grid, synthetic_grid
    from repro_torch.kernels import _build
    from repro_torch.kernels import push_relabel as pr

    dev = torch.device(DEVICE)
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- main path instance ----
    side, reg = MAIN_SIDE, MAIN_REGIONS
    problem = segmentation_grid(side, side, seed=0)
    part = grid_partition((side, side), (reg, reg))
    main_in, main_dinf = first_stage_inputs(problem, part, dev)
    K, V, E = main_in["cf"].shape
    log(f"[instance] segmentation_grid({side},{side}) {reg}x{reg} regions: "
        f"K={K} V={V} E={E}, {problem.num_vertices} vertices, "
        f"{len(problem.edges)} edges")

    # ---- phase 2: kernels against their plain versions ----
    log("[kernels] bit-exact against the plain versions")
    rng_limits = lambda K: torch.tensor([0] + [1 + (7 * k) % 9
                                               for k in range(1, K)],
                                        dtype=torch.int32, device=dev)
    small_p = segmentation_grid(64, 64, seed=1)
    small_in, small_dinf = first_stage_inputs(
        small_p, grid_partition((64, 64), (2, 2)), dev)
    cases = [
        ("random", random_regions(K, V, E, 0, dev), V + 2, rng_limits(K)),
        ("random", random_regions(4, 4096, 8, 1, dev), 4098, rng_limits(4)),
        ("main-path stage 0", main_in, main_dinf,
         torch.full((K,), 8, dtype=torch.int32, device=dev)),
        ("early exit", small_in, small_dinf,
         torch.full((4,), 100000, dtype=torch.int32, device=dev)),
    ]
    errs, iters_of = check_kernels(cases)
    if not 0 < max(iters_of["early exit"]) < 100000:
        raise AssertionError("the early-exit case did not exit early")

    # ---- phase 3: the main path ----
    log("[main path] Solver(method='ard', parallel=True, "
        "engine_backend='cuda', engine_chunk_iters=8).prepare().solve()")
    opts = SolverOptions(method="ard", parallel=True, engine_backend="cuda",
                         engine_chunk_iters=8, check=True, device=DEVICE)
    res, cuda_s, counts = timed_solve(opts, problem, part)
    launches_a = counts["fused_engine_run_batched"]
    if launches_a <= 0 or launches_a != res.stats.engine_launches:
        raise AssertionError(f"kernel A launched {launches_a} times, the "
                             f"solve counts {res.stats.engine_launches}")
    if not res.converged:
        raise AssertionError("main path did not converge")
    log(f"  certificate: cut cost == flow == {res.flow_value}")
    t_opts = SolverOptions(method="ard", parallel=True,
                           engine_backend="torch", engine_chunk_iters=8,
                           check=True, device=DEVICE)
    t_res, torch_s, t_counts = timed_solve(t_opts, problem, part)
    if sum(t_counts.values()):
        raise AssertionError("the plain 'torch' backend launched a kernel")
    same_solve(res, t_res, "cuda vs torch")
    log("  torch backend: equal flow, state and counters")
    t0 = time.perf_counter()
    want = scipy_maxflow(problem)
    if want != res.flow_value:
        raise AssertionError(f"flow {res.flow_value} != scipy {want}")
    log(f"  scipy maximum_flow: {want} (equal, {time.perf_counter() - t0:.1f}"
        f" s)")

    # ---- phase 4: a multi-sweep path, kernel B against kernel A ----
    ms, mreg = MULTI_SIDE, MULTI_REGIONS
    m_problem = synthetic_grid(ms, ms, connectivity=8)
    m_part = grid_partition((ms, ms), (mreg, mreg))
    log(f"[multi-sweep] synthetic_grid({ms},{ms}, connectivity=8) "
        f"{mreg}x{mreg} regions")
    u_opts = SolverOptions(engine_backend="cuda", engine_chunk_iters=None,
                           device=DEVICE)
    u_res, unfused_s, u_counts = timed_solve(u_opts, m_problem, m_part)
    launches_b = u_counts["push_relabel_phase"]
    if launches_b <= 0:
        raise AssertionError("kernel B was not launched on the unfused path")
    f_res, fused_s, f_counts = timed_solve(opts, m_problem, m_part)
    if f_counts["fused_engine_run_batched"] != f_res.stats.engine_launches:
        raise AssertionError("kernel A count != engine_launches (multi)")
    same_solve(u_res, f_res, "unfused kernel B vs fused kernel A")
    if u_res.stats.sweeps < 2:
        raise AssertionError("the multi-sweep path took one sweep")
    log(f"  unfused (kernel B) == fused (kernel A) over "
        f"{u_res.stats.sweeps} sweeps")
    m_want = scipy_maxflow(m_problem)
    if m_want != u_res.flow_value:
        raise AssertionError(f"multi-sweep flow {u_res.flow_value} != scipy "
                             f"{m_want}")
    log(f"  scipy maximum_flow: {m_want} (equal)")

    # ---- phase 5: times at the main path's shapes ----
    log(f"[times] per launch at K={K} V={V} E={E}, {args.reps} launches "
        f"each | {card}")
    fargs = [main_in[a] for a in FUSED_ARGS]
    limit8 = torch.full((K,), 8, dtype=torch.int32, device=dev)
    a_ms = time_ms(lambda: pr.fused_engine_run_batched(
        *fargs, main_dinf, limit8), args.reps)
    a_plain = time_ms(lambda: pr.fused_engine_run_batched_plain(
        *fargs, main_dinf, limit8), max(2, args.reps // 4))
    a_iters = int(pr.fused_engine_run_batched(
        *fargs, main_dinf, limit8)[-1].sum())
    kve, kv = K * V * E, K * V
    a_bytes = 4 * (6 * kve + 4 * kv + 2 * K) + 4 * (2 * kve + 3 * kv + 3 * K)
    a_ops = a_iters * V * (26 + 20 * E)
    pargs = [main_in[a] for a in PHASE_ARGS]
    b_ms = time_ms(lambda: (pr.push_relabel_phase(*pargs, main_dinf,
                                                  mode="push"),
                            pr.push_relabel_phase(*pargs, main_dinf,
                                                  mode="relabel")),
                   args.reps) / 2
    b_plain = time_ms(lambda: (pr.push_relabel_phase_plain(
        *pargs, main_dinf, mode="push"), pr.push_relabel_phase_plain(
        *pargs, main_dinf, mode="relabel")), args.reps) / 2
    b_bytes = 4 * (5 * kve + 3 * kv + K) + 4 * (kv * (1 + E) + kv) / 2
    b_ops = kv * (14 + 18 * E) / 2
    report = []
    for name, src, repl, launches, err, ms, plain, nbytes, ops in (
            ("fused_engine_run_batched", "src/repro_torch/csrc/fused_engine.cu",
             "src/repro/kernels/push_relabel.py:451", launches_a,
             errs["fused_engine_run_batched"], a_ms, a_plain, a_bytes,
             a_ops),
            ("push_relabel_phase", "src/repro_torch/csrc/push_relabel_phase.cu",
             "src/repro/kernels/push_relabel.py:171", launches_b,
             errs["push_relabel_phase"], b_ms, b_plain, b_bytes, b_ops)):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_INT32_OPS_PER_S * 1e3
        report.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None))
        log(f"  {name}: {ms:.4f} ms/launch, plain {plain:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes} bytes, {ops:.0f} ops)")
    log(f"  kernel A launch ran {a_iters} region-iterations")
    log(f"  main path solve: cuda {cuda_s:.3f} s, torch {torch_s:.3f} s; "
        f"multi-sweep: unfused cuda {unfused_s:.3f} s, fused cuda "
        f"{fused_s:.3f} s")

    handle = Solver(opts).prepare(problem, part)
    profile_run(handle.solve, "main-path solve")
    del handle

    # ---- phases 6-9: the LM slice ----
    report.append(lm_phases(dev, args.reps))

    print(json.dumps({"kernels": report}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
