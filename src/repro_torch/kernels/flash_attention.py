"""Flash attention of the port: wrapper, plain version, launch count.

``flash_attention`` (``csrc/flash_attention.cu``) is a hand-written Hopper
kernel that replaces the reference's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention`` (``_flash_kernel``)
and its ``repro/kernels/ops.py::flash_attention`` wrapper: causal
online-softmax attention, GQA by indexing kv head ``h // (H // Hkv)``,
f32 accumulation, output in q's type.

The wrapper takes its plain PyTorch version (:func:`flash_attention_plain`,
beside it) when its tensors lie on the CPU, and only then; on CUDA tensors
it launches the kernel or raises.  ``LAUNCHES`` counts kernel launches
(plain calls do not count).

Layout: q ``[B, H, Sq, D]``, k/v ``[B, Hkv, Sk, D]``, any strides on the
first three axes and a unit stride on D.  The kernel reads and writes
through those strides, so the transposed ``[B, S, H, D]`` projections of
the model are passed without a copy; the output is allocated with q's
strides (``torch.empty_like``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"flash_attention": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _scale(D: int) -> float:
    return 1.0 / (D ** 0.5)


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain PyTorch version of the kernel: the same function in f32.

    Query i sees key j iff ``j < Sk`` and, when causal, ``j <= i + (Sk -
    Sq)``; a row that sees no key (Sq > Sk) is 0, as the kernel's ``l > 0``
    guard makes it.  q is scaled by ``D**-0.5`` in f32 before the product.
    """
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qf = (q.float() * _scale(D)).reshape(B, Hkv, H // Hkv, Sq, D)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float())
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
    else:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    out = torch.where(l > 0, out / l, 0.0)
    return out.reshape(B, H, Sq, D).to(q.dtype)


_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float]
         + [ctypes.c_int64] * 12 + [ctypes.c_void_p])


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _ARGS
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d "
                         "([B,H,Sq,D], [B,Hkv,Sk,D])")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    Hkv = k.shape[1]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {Hkv} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} has no kernel "
                         f"instance; the kernel takes {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            f"kernel takes float32 or bfloat16, all alike")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} has stride "
                             f"{t.stride(3)} on D; the kernel needs 1")


def flash_attention(q, k, v, *, causal: bool = True):
    """Kernel: attention of q ``[B,H,Sq,D]`` against k/v ``[B,Hkv,Sk,D]``.

    Same contract as :func:`flash_attention_plain`, which it takes for CPU
    tensors.  Takes float32 or bfloat16 and head dims ``HEAD_DIMS``.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)         # q's strides where q is dense
    lib = _lib()
    st = lambda t: t.stride()[:3]
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            Hkv, Sq, Sk, D, _DTYPE_CODE[q.dtype], int(bool(causal)),
            _scale(D), *st(q), *st(k), *st(v), *st(o),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
