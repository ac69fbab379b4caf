"""The port's flash attention against the JAX reference on the CPU.

On CPU tensors ``repro_torch.kernels.flash_attention.flash_attention`` takes
its plain version, which is held here against the reference's Pallas
kernel in interpret mode (``repro.kernels.flash_attention.flash_attention``)
on the shapes of ``tests/test_kernels.py`` plus the smoke config's head dim
and a case with more queries than keys.  The CUDA kernel itself runs only
on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances are those of ``tests/test_kernels.py``: f32 2e-5 (the two
compute the same f32 sums in another order and blocking), bf16 2e-2 (the
output is rounded to bf16, whose unit in the last place is 2^-8 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from test_kernels import ATTN_SHAPES

SHAPES = ATTN_SHAPES + [
    (2, 4, 2, 40, 40, 16),      # smoke config: GQA, head_dim 16
    (1, 2, 1, 80, 48, 32),      # Sq > Sk: the first 32 rows see no key
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(shape, dtype, seed=0):
    B, H, Hkv, Sq, Sk, D = shape
    rng = np.random.RandomState(seed)
    # round to the working type once, so both packages see the same bits
    arrs = [np.array(jnp.asarray(rng.randn(*s), JDT[dtype]), np.float32)
            for s in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
    return arrs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_interpret(shape, dtype, causal):
    q, k, v = _qkv(shape, dtype)
    want = jflash(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
                  causal=causal, block_q=32, block_k=64, interpret=True)
    tfa.reset_launch_counts()
    got = tfa.flash_attention(*(torch.from_numpy(a).to(TDT[dtype])
                                for a in (q, k, v)), causal=causal)
    assert tfa.launch_counts() == {"flash_attention": 0}   # plain on CPU
    assert got.dtype == TDT[dtype] and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_rows_without_keys_are_zero():
    """Sq > Sk, causal: query i < Sq - Sk sees no key; the kernel's l > 0
    guard (and the reference's) makes the row 0, where attention_ref's
    -1e30 fill would average the keys uniformly."""
    q, k, v = _qkv((1, 2, 1, 80, 48, 32), "float32", seed=3)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), block_q=32,
                             block_k=64, interpret=True))
    assert not got[:, :, :32].any() and not want[:, :, :32].any()
    assert got[:, :, 32:].abs().min() > 0


def test_flash_takes_strided_views():
    """The model hands over transposed [B,S,H,D] projections; the plain
    version and the reference agree on such views."""
    q, k, v = _qkv((2, 4, 2, 24, 24, 16), "float32", seed=5)
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1,
                                                                     3)))
                  .transpose(1, 2) for a in (q, k, v))
    assert not tq.is_contiguous()
    got = tfa.flash_attention(tq, tk, tv)
    want = jflash(*map(jnp.asarray, (q, k, v)), block_q=32, block_k=64,
                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(64, 64), (1, 40), (30, 50)])
def test_attention_ref_matches_reference(tq, tk, causal, dtype):
    rng = np.random.RandomState(tq + tk)
    q, k, v = (np.array(jnp.asarray(rng.randn(2, 3, t, 32), JDT[dtype]),
                          np.float32) for t in (tq, tk, tk))
    want = jref.attention_ref(*(jnp.asarray(a, JDT[dtype])
                                for a in (q, k, v)), causal=causal)
    got = tref.attention_ref(*(torch.from_numpy(a).to(TDT[dtype])
                               for a in (q, k, v)), causal=causal)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_kernel_argument_checks():
    """On the CPU the wrapper is the plain version; the kernel's argument
    checks (head dims, types, GQA ratio) are exercised without a card."""
    q = torch.zeros(1, 3, 4, 20)
    k = torch.zeros(1, 2, 4, 20)
    with pytest.raises(ValueError, match="multiple"):
        tfa._check(q, k, k)
    with pytest.raises(ValueError, match="head dim 20"):
        tfa._check(q, q, q)
    q16 = torch.zeros(1, 2, 4, 16, dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        tfa._check(q16, q16, q16)
    qs = torch.zeros(1, 2, 16, 4).transpose(2, 3)
    with pytest.raises(ValueError, match="stride"):
        tfa._check(qs, qs, qs)
