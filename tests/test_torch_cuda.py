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
