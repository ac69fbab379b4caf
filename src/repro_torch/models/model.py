"""The LM: a stack of dense attention + SwiGLU layers (port of
``repro.models.model`` for dense, all-global decoder configs).

The reference scans one period of layers over stacked parameters; the port
holds the layers unstacked in an ``nn.ModuleList`` and runs them in a
Python loop.  Modes, as the reference's:

  train    — full-sequence logits ``(logits [B,S,V], aux)``; attention goes
             through the flash kernel when ``cfg.use_flash_attention``;
  prefill  — attends within the chunk, fills the cache, returns
             ``(last-position logits [B,V], cache)``;
  decode   — one token against the filled cache, same return.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
sliding-window layers and their ring caches, MoE, xLSTM and RG-LRU blocks,
the modality frontends and encoder-only stacks, and sharded activations.
``cfg.remat`` is a training concern (rematerialisation in the backward) and
the inference forward ignores it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.executor import not_ported
from repro_torch.core.graph import resolve_device
from repro_torch.models import layers

_I32 = torch.int32


# --------------------------------------------------------------------------
# period plan
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Plan:
    period: tuple                 # block kinds in one period
    n_periods: int
    active: dict                  # kind -> np.bool_[n_periods]
    is_global: np.ndarray         # [n_periods] attention flavour per period


def build_plan(cfg: ArchConfig) -> Plan:
    L = cfg.num_layers
    if cfg.block_kind == "xlstm":
        period = ("mlstm", "slstm")
        n = -(-L // 2)
        active = {"mlstm": np.arange(n) * 2 < L,
                  "slstm": np.arange(n) * 2 + 1 < L}
        return Plan(period, n, active, np.zeros(n, bool))
    if cfg.block_kind == "rglru":
        period = ("rglru", "rglru2", "attn")
        n = -(-L // 3)
        active = {"rglru": np.arange(n) * 3 < L,
                  "rglru2": np.arange(n) * 3 + 1 < L,
                  "attn": np.arange(n) * 3 + 2 < L}
        return Plan(period, n, active, np.zeros(n, bool))  # attn all local
    period = ("attn",)
    if cfg.pattern_local:
        p = cfg.pattern_local + cfg.pattern_global
        is_global = (np.arange(L) % p) >= cfg.pattern_local
    else:
        is_global = np.ones(L, bool)
    return Plan(period, L, {"attn": np.ones(L, bool)}, is_global)


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a config this slice of the port does not run."""
    if cfg.block_kind == "xlstm":
        raise not_ported(f"{cfg.name}: xLSTM blocks", "queue 1, item 18")
    if cfg.block_kind == "rglru":
        raise not_ported(f"{cfg.name}: RG-LRU blocks", "queue 1, item 19")
    if cfg.moe is not None:
        raise not_ported(f"{cfg.name}: MoE layers", "queue 1, item 17")
    if cfg.local_window or cfg.pattern_local:
        raise not_ported(f"{cfg.name}: sliding-window attention and its "
                         f"ring caches", "queue 1, item 16")
    if cfg.frontend != "none" or cfg.encoder_only:
        raise not_ported(f"{cfg.name}: modality frontends and encoder-only "
                         f"stacks", "queue 1, item 20")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class Block(nn.Module):
    """One dense layer: attention and SwiGLU MLP, each pre-normed."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        D = cfg.d_model
        kw = dict(dtype=dtype, device=device)
        self.ln_attn = layers.RMSNorm(D, **kw)
        self.attn = layers.Attention(D, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.resolved_head_dim,
                                     qkv_bias=cfg.qkv_bias, **kw)
        self.ln_mlp_attn = layers.RMSNorm(D, **kw)
        self.mlp_attn = layers.MLP(D, cfg.d_ff, **kw)


class Model(nn.Module):
    """Embedding, ``cfg.num_layers`` :class:`Block`s, final norm and head
    (the embedding's transpose where ``cfg.tie_embeddings``).  Parameters
    are uninitialised; :func:`init_params` or
    :func:`repro_torch.models.convert.params_from_jax` fill them."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        kw = dict(dtype=dtype, device=device)
        self.embed = nn.Parameter(torch.empty(V, D, **kw))
        self.head = (None if cfg.tie_embeddings
                     else nn.Parameter(torch.empty(D, V, **kw)))
        self.final_norm = layers.RMSNorm(D, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.inference_mode()
    def forward(self, batch_inputs: dict, *, mode: str = "train",
                cache: dict | None = None, act_sharding=None,
                attn_q_chunk: int | None = None):
        """train: ``(logits [B,S,V], aux)``;  prefill/decode: ``(logits
        [B,V], cache)``.

        ``attn_q_chunk`` runs attention in query chunks of that size
        (``layers._sdpa_q_chunked``) outside the flash branch.  The
        reference's ``return_hidden`` (for the training loss) comes with
        training (ROADMAP queue 1, item 21).  The cache's tensors are
        updated in place (slice writes where the reference uses
        ``dynamic_update_slice``); the returned dict holds the same tensors
        and the advanced ``pos``.
        """
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if act_sharding is not None:
            raise not_ported("sharded activations (act_sharding)",
                             "queue 1, item 13")
        cfg = self.cfg
        x = layers.embed_lookup(self.embed, batch_inputs["tokens"])
        B, S, _ = x.shape
        serving = mode != "train"
        if serving:
            if cache is None:
                raise ValueError(f"mode={mode!r} needs a cache")
            pos0 = cache["pos"]
            max_seq = cache["gk"].shape[2]
            if pos0 + S > max_seq:
                # the reference's dynamic_update_slice would clamp the
                # write and silently overwrite earlier slots
                raise ValueError(f"cache full: {pos0} + {S} tokens > "
                                 f"max_seq {max_seq}")
        else:
            pos0 = 0
        positions = (pos0 + torch.arange(S, dtype=_I32, device=x.device)
                     ).expand(B, S)
        if serving:
            gpos = cache["gpos"]
            gpos[:, pos0:pos0 + S] = positions

        for i, blk in enumerate(self.blocks):
            h = blk.ln_attn(x, cfg.norm_eps)
            k, v = layers.project_kv(blk.attn, h, positions, cfg.rope_theta)
            if not serving:
                out = layers.attention(
                    blk.attn, h, positions=positions, kv_positions=positions,
                    k_cache=k, v_cache=v, causal=True, window=0,
                    rope_theta=cfg.rope_theta,
                    use_flash=cfg.use_flash_attention, q_chunk=attn_q_chunk)
            else:
                kc, vc = cache["gk"][i], cache["gv"][i]
                kc[:, pos0:pos0 + S] = k.to(kc.dtype)
                vc[:, pos0:pos0 + S] = v.to(vc.dtype)
                if S > 1:
                    # a chunk of several tokens (prefill) attends within
                    # itself, as the reference's (it starts at pos 0); one
                    # token (decode) attends against the cache
                    out = layers.attention(
                        blk.attn, h, positions=positions,
                        kv_positions=positions, k_cache=k, v_cache=v,
                        causal=True, window=0, rope_theta=cfg.rope_theta,
                        q_chunk=attn_q_chunk)
                else:
                    out = layers.attention(
                        blk.attn, h, positions=positions, kv_positions=gpos,
                        k_cache=kc, v_cache=vc, causal=True, window=0,
                        rope_theta=cfg.rope_theta)
            x = x + out
            x = x + blk.mlp_attn(blk.ln_mlp_attn(x, cfg.norm_eps))

        x = self.final_norm(x, cfg.norm_eps)
        if serving:
            x = x[:, -1:]
        if self.head is None:
            logits = torch.einsum("bsd,vd->bsv", x, self.embed)
        else:
            logits = torch.einsum("bsd,dv->bsv", x, self.head)
        if not serving:
            # aux: the MoE load-balancing loss, 0 for dense layers
            return logits, torch.zeros((), dtype=torch.float32,
                                       device=x.device)
        return logits[:, 0], dict(cache, pos=pos0 + S)


@torch.no_grad()
def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Model:
    """A :class:`Model` with the reference's distributions: normal x
    1/sqrt(fan-in) (1/sqrt(d_model) for ``wo``, as the reference has it),
    zeros for norms and biases.  The numbers differ from ``jax.random``'s;
    to share weights with the reference, use ``convert.params_from_jax``."""
    model = Model(cfg, dtype=dtype, device=device)
    s_d = 1.0 / np.sqrt(cfg.d_model)
    normal = lambda p, s: p.normal_(generator=generator).mul_(s)
    normal(model.embed, s_d)
    if model.head is not None:
        normal(model.head, s_d)
    for blk in model.blocks:
        for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                  blk.mlp_attn.w_gate, blk.mlp_attn.w_up):
            normal(w, s_d)
        normal(blk.mlp_attn.w_down, 1.0 / np.sqrt(cfg.d_ff))
        for b in (blk.attn.bq, blk.attn.bk, blk.attn.bv):
            if b is not None:
                b.zero_()
    return model


def param_count(cfg: ArchConfig) -> int:
    """Parameter count, from a model built on the meta device (nothing is
    allocated)."""
    return sum(p.numel() for p in Model(cfg, device="meta").parameters())


# --------------------------------------------------------------------------
# cache
# --------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Global-attention KV cache: ``gk``/``gv [L, B, max_seq, Kv, Dh]``,
    ``gpos [B, max_seq]`` (-1 = empty slot) and ``pos`` (a host int)."""
    check_ported(cfg)
    device = resolve_device(device)
    n = build_plan(cfg).n_periods
    shape = (n, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"pos": 0,
            "gk": torch.zeros(shape, dtype=dtype, device=device),
            "gv": torch.zeros(shape, dtype=dtype, device=device),
            "gpos": torch.full((batch, max_seq), -1, dtype=_I32,
                               device=device)}
