"""Serving steps: prefill and single-token decode, plus a batched
greedy-decode driver (port of ``repro.train.serve``, one device).

The reference's steps close over ``(cfg, dtype)`` and take the parameter
pytree; the port's close over a :class:`~repro_torch.models.model.Model`,
which carries its config and dtype.
"""

from __future__ import annotations

import torch

from repro_torch.core.executor import not_ported
from repro_torch.models import model as model_lib


def make_prefill_step(model: model_lib.Model, q_chunk: int | None = None):
    def prefill(batch, cache):
        return model(batch, mode="prefill", cache=cache, attn_q_chunk=q_chunk)
    return prefill


def make_decode_step(model: model_lib.Model):
    def decode(tokens, cache):
        return model({"tokens": tokens}, mode="decode", cache=cache)
    return decode


def make_sharded_decode_step(*args, **kwargs):
    raise not_ported("the sharded decode step (make_sharded_decode_step)",
                     "queue 1, item 13")


@torch.inference_mode()
def greedy_generate(model: model_lib.Model, prompt_tokens: torch.Tensor,
                    steps: int, max_seq: int) -> torch.Tensor:
    """Greedy generation: one prefill of the prompts ``[B, S]``, then
    ``steps - 1`` decode steps; returns the ``[B, steps]`` new tokens.

    The cache holds ``max_seq`` positions in the model's dtype; the
    prompt and the decoded tokens must fit (the forward raises where the
    reference would clamp its cache writes).
    """
    B, S = prompt_tokens.shape
    if S + steps - 1 > max_seq:
        raise ValueError(f"{S} prompt + {steps - 1} decoded tokens do not "
                         f"fit max_seq {max_seq}")
    cache = model_lib.init_cache(model.cfg, B, max_seq, model.dtype,
                                 model.device)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill({"tokens": prompt_tokens}, cache)
    toks = [logits.argmax(-1)[:, None]]
    for _ in range(steps - 1):
        logits, cache = decode(toks[-1], cache)
        toks.append(logits.argmax(-1)[:, None])
    return torch.cat(toks, dim=1)
