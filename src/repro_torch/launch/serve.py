"""Serving launcher: batched prefill + greedy decode (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Weights are random, from a seeded ``torch.Generator``.  Runs on the card
(``--device cuda``, the default) unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.graph import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.train.serve import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    dtype = torch.float32 if args.smoke else torch.bfloat16
    device = resolve_device(args.device)

    gen = torch.Generator(device=device).manual_seed(0)
    model = model_lib.init_params(cfg, generator=gen, dtype=dtype,
                                  device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    t0 = time.time()
    out = greedy_generate(model, prompts, args.gen,
                          args.prompt_len + args.gen + 8)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"[serve] arch={cfg.name} device={device} batch={args.batch} "
          f"generated {args.gen} tokens/seq in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", out[0, :12].tolist())


if __name__ == "__main__":
    main()
