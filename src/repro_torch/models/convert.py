"""Carry the reference's weights into the port.

``params_from_jax`` takes the parameter pytree of the reference's
``repro.models.model.init_params`` as numpy arrays (``jax.tree.map(
np.asarray, params)``) and fills a :class:`~repro_torch.models.model.Model`
with it: each ``blocks`` leaf stacked over the period axis ``n`` is
unstacked into layer ``i``.  Tests use it to run both packages on the same
weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model


@torch.no_grad()
def params_from_jax(params_np: dict, cfg: ArchConfig, *,
                    device="cuda") -> Model:
    """A :class:`Model` holding the reference's parameters ``params_np``
    (nested dict of numpy arrays, float32 or float16: numpy has no
    bfloat16), in their dtype."""
    dtype = torch.tensor(np.asarray(params_np["embed"])[:0]).dtype
    model = Model(cfg, dtype=dtype, device=device)

    def put(param, arr):
        arr = np.asarray(arr)
        if tuple(param.shape) != arr.shape:
            raise ValueError(f"shape {arr.shape} does not fit parameter "
                             f"{tuple(param.shape)}")
        param.copy_(torch.tensor(arr))

    put(model.embed, params_np["embed"])
    if model.head is not None:
        put(model.head, params_np["head"])
    put(model.final_norm.weight, params_np["final_norm"])
    blocks = params_np["blocks"]
    attn, mlp = blocks["attn"], blocks["mlp_attn"]
    for i, blk in enumerate(model.blocks):
        for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            if getattr(blk.attn, name) is not None:
                put(getattr(blk.attn, name), attn[name][i])
        for name in ("w_gate", "w_up", "w_down"):
            put(getattr(blk.mlp_attn, name), mlp[name][i])
        put(blk.ln_attn.weight, blocks["ln_attn"][i])
        put(blk.ln_mlp_attn.weight, blocks["ln_mlp_attn"][i])
    return model
