"""Shared neural layers: norms, RoPE, GQA attention, SwiGLU MLP, embeddings
(port of ``repro.models.layers``, global attention only).

Parameters live in ``nn.Module``s (:class:`RMSNorm`, :class:`Attention`,
:class:`MLP`) with the reference's layouts (``wq [D, H, Dh]``, ``wo [H, Dh,
D]``, ``w_gate [D, F]``, ...); the math is plain functions on tensors that
take such a module as ``params``.  Dtype policy as the reference's:
parameters and activations in the caller's dtype, reductions and softmax in
f32.  The projections, the MLP and ``_sdpa`` are ``torch.einsum``, as the
reference left them to XLA; only the flash branch of :func:`attention` runs
a hand-written kernel (``repro_torch.kernels.flash_attention``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30


# --------------------------------------------------------------------------
# norms / embeddings
# --------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """RMS norm with a zero-initialised weight applied as ``(1 + w)``."""

    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x, eps: float):
        return rms_norm(x, self.weight, eps)


def rms_norm(x, w, eps: float = 1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * (1.0 + w)


def embed_lookup(table, tokens):
    return table[tokens.long()]


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x [..., S, H, Dh]; positions [..., S] (absolute).  Rotates the two
    halves of Dh (not interleaved pairs), with f32 angles."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq              # [..,S,half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projections: ``wq [D,H,Dh]``, ``wk``/``wv [D,Kv,Dh]``, ``wo
    [H,Dh,D]`` and, with ``qkv_bias``, ``bq [H,Dh]``, ``bk``/``bv
    [Kv,Dh]``."""

    def __init__(self, d_model, n_heads, n_kv, head_dim, *, qkv_bias: bool,
                 dtype, device):
        super().__init__()
        mk = lambda *s: nn.Parameter(torch.empty(s, dtype=dtype,
                                                 device=device))
        self.wq = mk(d_model, n_heads, head_dim)
        self.wk = mk(d_model, n_kv, head_dim)
        self.wv = mk(d_model, n_kv, head_dim)
        self.wo = mk(n_heads, head_dim, d_model)
        if qkv_bias:
            self.bq = mk(n_heads, head_dim)
            self.bk = mk(n_kv, head_dim)
            self.bv = mk(n_kv, head_dim)
        else:
            self.bq = self.bk = self.bv = None


def _sdpa(q, k, v, mask):
    """q [B,S,H,Dh], k/v [B,T,Kv,Dh], mask [B,1,S,T] bool — plain path."""
    B, S, H, Dh = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, S, Kv, H // Kv, Dh)
    logits = torch.einsum("bskrd,btkd->bkrst", qg.float(),
                          k.float()) / math.sqrt(Dh)
    logits = torch.where(mask[:, :, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v.float())
    return out.reshape(B, S, H, Dh).to(q.dtype)


def _sdpa_q_chunked(q, k, v, mask, q_chunk: int):
    """Query-chunked SDPA: scores exist only as [.., q_chunk, T] tiles.

    Each chunk is a full softmax over T for its query rows, so the result
    equals :func:`_sdpa`; the reference pads the last chunk with masked
    rows and drops them, the port takes a shorter last chunk.
    """
    outs = [_sdpa(q[:, i:i + q_chunk], k, v, mask[:, :, i:i + q_chunk])
            for i in range(0, q.shape[1], q_chunk)]
    return torch.cat(outs, dim=1)


def attention(params, x, *, positions, kv_positions, k_cache, v_cache,
              causal: bool, window: int, rope_theta: float,
              use_flash: bool = False, q_chunk: int | None = None):
    """Generic GQA attention against a (possibly cached) KV set.

    x [B,S,D]; k_cache/v_cache [B,T,Kv,Dh] already containing this step's
    keys (the caller writes them); kv_positions [B,T] absolute positions of
    cache slots (-1 = empty).  ``window > 0`` masks keys older than
    position - window + 1; ``window == 0`` means global.  With
    ``use_flash``, causal attention with S == T runs the flash kernel.
    """
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    if params.bq is not None:
        q = q + params.bq
    q = rope(q, positions, rope_theta)
    T = k_cache.shape[1]
    kvp = kv_positions[:, None, None, :]                        # [B,1,1,T]
    qp = positions[:, None, :, None]                            # [B,1,S,1]
    mask = (kvp >= 0).expand(B, 1, S, T)
    if causal:
        mask = mask & (kvp <= qp)
    eff = window if window > 0 else T + S + 2       # 0 => effectively inf
    mask = mask & (kvp > qp - eff)
    if use_flash and causal and S == T:
        # contiguous full-causal case: the hand-written kernel, reading the
        # [B,S,H,Dh] projections through their strides (no copy)
        o = flash_attention(q.transpose(1, 2), k_cache.transpose(1, 2),
                            v_cache.transpose(1, 2),
                            causal=True).transpose(1, 2)
    elif q_chunk is not None and S > q_chunk:
        o = _sdpa_q_chunked(q, k_cache, v_cache, mask, q_chunk)
    else:
        o = _sdpa(q, k_cache, v_cache, mask)
    return torch.einsum("bshk,hkd->bsd", o, params.wo)


def project_kv(params, x, positions, rope_theta):
    k = torch.einsum("bsd,dhk->bshk", x, params.wk)
    v = torch.einsum("bsd,dhk->bshk", x, params.wv)
    if params.bk is not None:
        k = k + params.bk
        v = v + params.bv
    k = rope(k, positions, rope_theta)
    return k, v


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU: ``w_gate``/``w_up [D,F]``, ``w_down [F,D]``."""

    def __init__(self, d_model, d_ff, *, dtype, device):
        super().__init__()
        mk = lambda *s: nn.Parameter(torch.empty(s, dtype=dtype,
                                                 device=device))
        self.w_gate = mk(d_model, d_ff)
        self.w_up = mk(d_model, d_ff)
        self.w_down = mk(d_ff, d_model)

    def forward(self, x):
        return mlp(self, x)


def mlp(params, x):
    h = F.silu(torch.einsum("bsd,df->bsf", x, params.w_gate))
    h = h * torch.einsum("bsd,df->bsf", x, params.w_up)
    return torch.einsum("bsf,fd->bsd", h, params.w_down)
