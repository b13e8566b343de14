"""Training throughput and MFU of the fused train step on one GPU.

    python -m accelerate_tpu_torch.bench

Counterpart of the repository's ``bench.py`` (``METRIC``,
``model_flops_per_token``, ``tier1_llama_config``, ``mfu_fields``,
``run_bench``): the same model, optimizer, loss and step, through the
port's entry points, at the same widths and shape, on the card:

    PipelinedLlamaForCausalLM(tier1_llama_config()), f32 master parameters
    Accelerator(mixed_precision="bf16").prepare(model, AdamW(lr=1e-4, weight_decay=1e-4))
    compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0)

on 8 x 1024 random tokens (4 seeded batches), 3 warm-up steps and 20 timed
ones. Prints one JSON line: the metric (tokens/s), ``backend: "cuda"``,
``device_kind``, ``step_ms``, ``mfu`` against the card's dense bf16 peak,
the loss of every step, the last grad norm and the peak device memory. The
FLOP count per token is the JAX bench's formula, unchanged (6N over the
matmul parameters plus 12 * L * hidden * seq for attention), so the two
lines compare. Raises without a card.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

METRIC = "llama_train_tokens_per_sec_per_chip"
#: Dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet), the
#: MFU denominator; the card's power limit is reported beside it.
PEAK_TFLOPS = 989.0


def model_flops_per_token(n_params: int, cfg, seq: int) -> float:
    """Training FLOPs/token: 6N for matmul params + attention score/value
    term 12*L*h*seq (fwd 2 matmuls * 2 FLOPs * s*h per token, x3 for bwd)."""
    attn = 12.0 * cfg.num_hidden_layers * cfg.hidden_size * seq
    return 6.0 * n_params + attn


def tier1_llama_config(**overrides):
    """The tier-1 2B-class Llama of the JAX bench: hidden 2048, intermediate
    5632, 10 layers, 16 query / 8 kv heads (head_dim 128), vocab 32000.

    ``remat=False``, where the JAX bench tries remat first: its ladder was
    sized for a 16 GB TPU. Here the whole train state (~0.6 B f32 master
    parameters, their gradients and AdamW's two moments, ~9.6 GB) and the
    activations of a step without remat (~10 GB at 8 x 1024 tokens) fit on
    one 80 GB card, and recomputing every layer would cost a third more
    forward work for memory that is not short."""
    from .models.llama import LlamaConfig

    cfg = LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=10, num_attention_heads=16, num_key_value_heads=8,
        max_position_embeddings=2048, remat=False, use_flash_attention=True,
    )
    return dataclasses.replace(cfg, **overrides)


def mfu_fields(tokens_per_sec: float, cfg, seq: int, n_params: int,
               peak_tflops: float = PEAK_TFLOPS) -> dict:
    """Shared MFU arithmetic: 6N (matmul params only; the input embedding
    is a gather) + attention FLOPs against the peak."""
    n_matmul_params = n_params - cfg.vocab_size * cfg.hidden_size
    achieved_tflops = tokens_per_sec * model_flops_per_token(n_matmul_params, cfg, seq) / 1e12
    return {"mfu": achieved_tflops / peak_tflops, "achieved_tflops": achieved_tflops,
            "peak_tflops": peak_tflops}


def build_train_step(batch: int = 8, seq: int = 1024, seed: int = 0,
                     accelerator_kwargs: dict | None = None, **config_overrides):
    """The bench's model, prepared, its fused train step and 4 seeded
    batches: ``(cfg, model, step, batches)``. Random weights come from a
    ``torch.Generator`` seeded with ``seed``, token ids from numpy's.
    ``accelerator_kwargs`` go to the ``Accelerator`` (e.g. an
    ``fsdp_plugin``)."""
    from . import Accelerator, PipelinedLlamaForCausalLM, fused_causal_lm_loss, make_global_batch

    # On the card; raises without one.
    acc = Accelerator(mixed_precision="bf16", **(accelerator_kwargs or {}))
    cfg = tier1_llama_config(**config_overrides)
    gen = torch.Generator(device=acc.device).manual_seed(seed)
    model = PipelinedLlamaForCausalLM(cfg, device=acc.device, dtype=torch.float32, generator=gen)
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                    weight_decay=1e-4))
    step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=1.0)
    rng = np.random.default_rng(seed)
    batches = [make_global_batch({"input_ids": rng.integers(0, cfg.vocab_size, size=(batch, seq))},
                                 acc) for _ in range(4)]
    return cfg, model, step, batches


def run_bench(batch: int = 8, seq: int = 1024, iters: int = 20, warmup: int = 3, seed: int = 0,
              accelerator_kwargs: dict | None = None, **config_overrides) -> dict:
    """Train the tier-1 model for ``warmup + iters`` steps and return the
    bench's JSON object. ``config_overrides`` change the config (e.g.
    ``remat=True``), ``accelerator_kwargs`` the ``Accelerator``."""
    cfg, model, step, batches = build_train_step(batch, seq, seed, accelerator_kwargs,
                                                 **config_overrides)
    device = next(model.parameters()).device
    torch.cuda.reset_peak_memory_stats(device)
    losses = []
    for i in range(warmup):
        metrics = step(batches[i % 4])
        losses.append(metrics["loss"])
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(iters):
        metrics = step(batches[i % 4])
        losses.append(metrics["loss"])
    torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    tokens_per_sec = batch * seq * iters / dt
    n_params = sum(p.numel() for p in model.parameters())
    flops = mfu_fields(tokens_per_sec, cfg, seq, n_params)
    return {
        "metric": METRIC,
        "value": tokens_per_sec,
        "unit": "tokens/s/chip",
        "extra": {
            "mfu": flops["mfu"],
            "achieved_tflops": flops["achieved_tflops"],
            "peak_tflops": flops["peak_tflops"],
            "step_ms": 1000 * dt / iters,
            "config": {"hidden": cfg.hidden_size, "layers": cfg.num_hidden_layers,
                       "batch": batch, "seq": seq, "backend": "cuda",
                       "flash_attention": cfg.use_flash_attention,
                       "remat_policy": cfg.remat_policy if cfg.remat else None,
                       "n_params": n_params},
            "device_kind": torch.cuda.get_device_name(device),
            "loss": float(metrics["loss"]),
            "losses": torch.stack(losses).tolist(),
            "grad_norm": float(metrics["grad_norm"]),
            "steps": warmup + iters,
            "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        },
    }


if __name__ == "__main__":
    print(json.dumps(run_bench()))
