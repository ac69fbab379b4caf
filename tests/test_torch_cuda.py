"""Both CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the reference package, so it also runs where the
card is (the repo's ``tests/conftest.py`` imports JAX; skip it there):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import push_relabel as pr

FUSED_ARGS = ("lab", "cf", "sink_cf", "excess", "nbr", "rev_slot", "intra",
              "pushable", "cross_lab", "vmask")
PHASE_ARGS = ("lab", "cf", "sink_cf", "excess", "nbr", "intra", "pushable",
              "cross_lab")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def _regions(K, V, E, seed, device):
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


@pytest.mark.cuda
@pytest.mark.parametrize("K,V,E", [(3, 16, 4), (4, 300, 8)])
def test_kernels_match_plain_on_card(cuda_device, K, V, E):
    r = _regions(K, V, E, K + V, cuda_device)
    limit = torch.tensor([7, 0] + [50] * (K - 2), dtype=torch.int32,
                         device=cuda_device)
    args = [r[a] for a in FUSED_ARGS]
    pr.reset_launch_counts()
    got = pr.fused_engine_run_batched(*args, V + 2, limit)
    want = pr.fused_engine_run_batched_plain(*args, V + 2, limit)
    for i, (x, y) in enumerate(zip(got, want)):
        assert torch.equal(x, y), f"kernel A output {i}"
    pargs = [r[a] for a in PHASE_ARGS]
    for mode in pr.MODES:
        got = pr.push_relabel_phase(*pargs, V + 2, mode=mode)
        want = pr.push_relabel_phase_plain(*pargs, V + 2, mode=mode)
        for x, y in zip(got, want):
            assert (x is None and y is None) or torch.equal(x, y), mode
    assert pr.launch_counts() == {"fused_engine_run_batched": 1,
                                  "push_relabel_phase": 3}


@pytest.mark.cuda
def test_wrappers_refuse_bad_input_on_card(cuda_device):
    r = _regions(2, 16, 4, 0, cuda_device)
    args = [r[a] for a in FUSED_ARGS]
    args[1] = args[1].to(torch.int64)
    with pytest.raises(TypeError, match="int32"):
        pr.fused_engine_run_batched(*args, 18, 4)
    pargs = [r[a] for a in PHASE_ARGS]
    pargs[1] = pargs[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pr.push_relabel_phase(*pargs, 18, mode="push")


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

FLASH_SHAPES = [
    # B, H, Hkv, Sq, Sk, D
    (1, 2, 2, 64, 64, 32),
    (2, 4, 2, 128, 128, 64),
    (1, 4, 1, 96, 96, 32),      # MQA
    (1, 2, 1, 1, 128, 32),      # decode: one query against a cache
    (1, 1, 1, 37, 53, 16),      # ragged
    (1, 2, 2, 200, 200, 128),
    (2, 4, 2, 40, 40, 16),      # smoke config
    (1, 2, 1, 80, 48, 32),      # Sq > Sk: rows without keys are 0
    (1, 3, 3, 300, 300, 96),    # phi3's head dim
]
# f32: the kernel and its plain version sum in another order; bf16: one
# unit in the last place of the bf16 output (2^-8 relative)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=[str(s) for s in FLASH_SHAPES])
def test_flash_matches_plain_on_card(cuda_device, shape, dtype, causal):
    from repro_torch.kernels import flash_attention as fa

    B, H, Hkv, Sq, Sk, D = shape
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Sk + D)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda_device,
                                dtype=dtype)
    q, k, v = mk(B, H, Sq, D), mk(B, Hkv, Sk, D), mk(B, Hkv, Sk, D)
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_attention": 1}
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_strided_views_on_card(cuda_device):
    """The model's transposed [B,S,H,D] projections go in without a copy
    and the output comes back in the same layout."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(2, 70, h, 96, generator=g, device=cuda_device)
               for h in (4, 2, 2))
    got = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = fa.flash_attention_plain(q.transpose(1, 2).contiguous(),
                                    k.transpose(1, 2).contiguous(),
                                    v.transpose(1, 2).contiguous())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_flash_refuses_bad_input_on_card(cuda_device):
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 2, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        fa.flash_attention(q, q, q)
