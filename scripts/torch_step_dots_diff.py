#!/usr/bin/env python3
"""How far the fused decode step's dot modes move the logits, on the CPU.

    python3 scripts/torch_step_dots_diff.py LAYERS

builds Llama-2-7B-width fused W4A8 params with ``LAYERS`` layers (seed 0,
rank 128, int8 factors; plain PyTorch versions of every kernel), prefills
eight seeded 128-token prompts into a 256-token head-major cache, and
prints the logits' rel-Frobenius difference of one staged step at
``attn_dots`` "bf16" and "i8" against the same step at "f32" from the same
cache, and whether the argmax agrees. It needs a few GiB of memory at 8
layers.
"""

import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as CS  # noqa: E402
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (  # noqa
    config as C, fused, llama)


def main() -> int:
    cfg = dataclasses.replace(C.LLAMA2_7B, num_layers=int(sys.argv[1]))
    dev = torch.device("cpu")
    params = CS._build_fused(cfg, dev, seed=0)
    B, T, P0 = 8, 256, 128
    cache = llama.HeadMajorQuantKVCache.create(cfg, B, T, device=dev)
    gen = torch.Generator().manual_seed(13)
    prompts = torch.randint(0, cfg.vocab_size, (B, P0), generator=gen)
    tok = torch.stack([fused.prefill_into_slot_fused(
        params, prompts[b:b + 1], b, cache, cfg, flash=True)[0].argmax()
        for b in range(B)])
    pos = torch.full((B,), P0, dtype=torch.int32)
    out = {d: fused.decode_step_fused(
        params, tok, pos, CS._copy_cache(cache, dev), cfg,
        staged_kv="uniform", attn_dots=d)[0] for d in ("f32", "bf16", "i8")}
    for d in ("bf16", "i8"):
        print(f"{cfg.num_layers} layers, {d} against f32: logits "
              f"rel-Frobenius {CS._rel(torch, out[d], out['f32']):.3e}, "
              f"argmax equal {CS._same_argmax(torch, out[d], out['f32'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
