"""Serving: batched prefill, then greedy decode with a KV cache.

The same entry point as ``repro.launch.serve``: the prompts come from the
synthetic numpy pipeline (the same seed gives the reference's prompts),
the prompt is prefilled, the argmax token is fed back ``gen`` times, and
the phases are timed, each ending after ``torch.cuda.synchronize()`` on
the card.  Attention runs through the flash-attention kernel
(``repro_torch.kernels.flash_attention``), an RWKV-6 prompt's time mix
through the RWKV-6 scan kernel (``repro_torch.kernels.rwkv6_scan``), every
expert product of an MoE layer through the grouped-matmul kernel
(``repro_torch.kernels.moe_gmm``), an RG-LRU prompt's recurrence through
the RG-LRU scan kernel (``repro_torch.kernels.rglru_scan``); the
attention, MLP and expert matmul weights and the head are cast to the
compute dtype once, before the timed phases (``cast_s``; RWKV layers,
RG-LRU blocks and the MoE router compute in float32).  The cache holds
``prompt_len + gen`` rows (the reference's ``max_len``); a local layer's
ring holds at most its window; ``kv_cache_dtype="int8"`` quantizes it.
An audio model's prompt is (B, K, S) codebook ids and each step decodes K
tokens; a VLM's prompt carries the pipeline's ``vision_embeds`` and
``mrope_positions``, and each decode step the M-RoPE positions
``prompt_len + i`` on all three streams, as the reference's.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch musicgen-large --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import DataConfig, host_batch
from repro_torch.models import transformer


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve(cfg: ArchConfig, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device=None,
          params: transformer.Transformer | None = None) -> dict:
    """Prefill ``batch`` synthetic prompts of ``prompt_len`` tokens and
    decode ``gen`` tokens greedily.

    ``params`` defaults to random float32 weights from a generator seeded
    with ``seed`` on the device.  Returns the reference's ``prefill_s``,
    ``decode_s``, ``decode_tok_per_s`` and ``generated``, (B, gen) int32
    (with K codebooks the reference's (gen, B, K, 1)), plus ``cast_s``,
    ``prefill_logits`` (B, 1, V) and ``logits`` (B, gen, V) (with K
    codebooks (B, K, 1, V) and (B, K, gen, V)), the float32 logits each
    generated token was taken from."""
    dev = resolve_device(device)
    if params is None:
        rng = torch.Generator(device=dev).manual_seed(seed)
        params = transformer.init_params(cfg, rng, dev)
    data = host_batch(cfg, DataConfig(prompt_len, batch, seed=seed), 0)
    prompt = {k: torch.from_numpy(v).to(dev) for k, v in data.items()
              if k != "labels"}

    _sync(dev)
    t0 = time.perf_counter()
    run = transformer.compute_copy(cfg, params)
    _sync(dev)
    t_cast = time.perf_counter() - t0

    t0 = time.perf_counter()
    cache, prefill_logits = transformer.prefill(cfg, run, prompt,
                                                max_len=prompt_len + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(prefill_logits, dim=-1).to(torch.int32)  # greedy
    toks, logits = [], []
    t1 = time.perf_counter()
    for i in range(gen):
        step = {"tokens": tok}
        if cfg.family == "vlm":
            step["mrope_positions"] = torch.full(
                (3, batch, 1), prompt_len + i, dtype=torch.int32, device=dev)
        cache, step_logits = transformer.decode_step(
            cfg, run, cache, step, prompt_len + i)
        tok = torch.argmax(step_logits, dim=-1).to(torch.int32)
        toks.append(tok)
        logits.append(step_logits)
    _sync(dev)
    t_decode = time.perf_counter() - t1

    if cfg.n_codebooks:
        generated = (torch.stack(toks).cpu().numpy().astype(np.int32)
                     if toks else np.zeros((0, batch, cfg.n_codebooks, 1),
                                           np.int32))
    else:
        generated = (torch.cat(toks, dim=-1).cpu().numpy().astype(np.int32)
                     if toks else np.zeros((batch, 0), np.int32))
    return {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * gen / max(t_decode, 1e-9),
        "generated": generated,
        "cast_s": t_cast,
        "prefill_logits": prefill_logits,
        "logits": torch.cat(logits, dim=-2) if logits else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    out = serve(cfg, args.batch, args.prompt_len, args.gen,
                device=args.device)
    where = (torch.cuda.get_device_name(0) if args.device is None
             else args.device)
    print(f"{cfg.name} on {where}: prefill {out['prefill_s'] * 1e3:.1f} ms | "
          f"decode {out['decode_s'] * 1e3:.1f} ms "
          f"({out['decode_tok_per_s']:.0f} tok/s) | cast "
          f"{out['cast_s'] * 1e3:.1f} ms | sample tokens: "
          f"{out['generated'].reshape(-1)[:16]}")
    return out


if __name__ == "__main__":
    main()
