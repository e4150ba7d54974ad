"""Time and peak memory of the attention backward and of a 4k train step, on the card.

    PYTHONPATH=src python -P src/repro_torch/launch/train_memory.py [--seed N]

It uses only public calls (``flash_attention`` under ``torch.autograd.grad``;
``build_model``, ``make_train_step``, ``adamw``, ``SyntheticLM``), so it runs
on the ``repro_torch`` package of any checkout put on ``PYTHONPATH`` (``-P``
keeps this file's directory off the import path): two trees can then be
compared on one card in one call.  Inputs and weights are synthetic, from
``--seed``:

  * the attention backward at smollm-135m's heads (9 over 3, head dim 64),
    batch 4, causal, bf16, at 2048 and 4096 keys: CUDA events around
    ``torch.autograd.grad`` of the flash route's output (the forward
    excluded; a warm-up, then 3 calls), and the bytes the allocator held
    above what was allocated before the call at its peak;
  * smollm-135m trains 2 AdamW steps at 4 x 4096 (bf16; the reference's
    ``train_4k`` length, batch 256 cut to 4), as ``chip_smoke.py`` phase
    24c: each step's wall ms (the first includes allocations) and the
    allocator's peak over both.

It prints one line a measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def attention_backward(seed: int, sk: int, reps: int = 3) -> dict:
    """ms a call and peak bytes above the start of ``grad`` through the flash route."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device="cuda", dtype=torch.bfloat16)
               .requires_grad_(True) for s in ((4, 9, sk, 64), (4, 3, sk, 64), (4, 3, sk, 64)))
    g = torch.randn(q.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    times, peaks = [], []
    for i in range(reps + 1):
        o = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        grads = torch.autograd.grad(o, (q, k, v), g)
        end.record()
        end.synchronize()
        if i:                                          # the first call warms up
            times.append(start.elapsed_time(end))
            peaks.append(torch.cuda.max_memory_allocated() - base)
        del o, grads
    return {"shape": [4, 9, sk, 64], "kv_heads": 3, "ms": float(np.mean(times)),
            "ms_each": times, "peak_bytes_above_start": max(peaks),
            "float32_scores_bytes": 4 * 4 * 9 * sk * sk}


def smollm_4k(seed: int) -> dict:
    """Two AdamW steps of smollm-135m at 4 x 4096, bf16: wall ms and peak."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding.context import ParallelContext
    from repro_torch.train.step import make_train_step

    bf16 = torch.bfloat16
    ctx = ParallelContext(param_dtype=bf16, compute_dtype=bf16, device="cuda")
    cfg = get_config("smollm-135m")
    model = build_model(cfg, ctx)
    params = model.init(seed)
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=4096, global_batch=4, seed=seed))
    batches = [to_device(data.batch(i), "cuda") for i in range(2)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(losses).all(), losses
    return {"batch": [4, 4096], "step_ms": walls, "peak_bytes": peak,
            "peak_bytes_above_start": peak - base, "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_memory: no CUDA device")
    out = {"device": torch.cuda.get_device_name(0), "attention_backward": []}
    for sk in (2048, 4096):
        r = attention_backward(args.seed, sk)
        out["attention_backward"].append(r)
        print(f"attention backward {r['shape']} over 3 KV heads, causal, bf16: {r['ms']:.3f} ms "
              f"a call, peak {r['peak_bytes_above_start'] / 1e9:.3f} GB above its start "
              f"(one float32 [4, 9, {sk}, {sk}]: {r['float32_scores_bytes'] / 1e9:.3f} GB)",
              flush=True)
        torch.cuda.empty_cache()
    r = out["smollm_4k"] = smollm_4k(args.seed)
    print(f"smollm-135m 4 x 4096 bf16, 2 AdamW steps: {r['step_ms'][0]:.1f} and "
          f"{r['step_ms'][1]:.1f} ms, peak {r['peak_bytes'] / 1e9:.2f} GB "
          f"({r['peak_bytes_above_start'] / 1e9:.2f} above the start), losses {r['losses']}",
          flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
