"""Stage-parallel (pipeline) inference on the PyTorch/CUDA port (counterpart
of examples/inference/pipeline_inference.py).

The stacked model's layers split over the ``pp`` mesh axis, one stage a
process, and microbatched rounds keep every stage busy (GPipe by
send/recv); ``prepare_pipeline`` pads the inputs to the microbatch count,
so any batch size works. A world of 4 at pp 2 x tp 2 on the CPU:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch --num_processes 4 \
        --use_cpu_emulation --pp 2 --tp 2 examples/inference_torch/pipeline_inference.py
    python examples/inference_torch/pipeline_inference.py       # mesh from env/config

On the card by default (one process a card); ``--cpu`` on the CPU.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import (
    Accelerator,
    MeshConfig,
    PipelineParallelPlugin,
    TensorParallelPlugin,
    prepare_pipeline,
)
from accelerate_tpu_torch.models.llama import LlamaConfig, PipelinedLlamaForCausalLM


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args()
    # The launcher's --pp/--tp (else 1). A torch module's layers split over
    # an axis only under its plugin: the stages hold their own layers.
    axes = MeshConfig.from_env()
    plugins = {}
    if axes.pp > 1:
        plugins["pp_plugin"] = PipelineParallelPlugin(pp_size=axes.pp)
    if axes.tp > 1:
        plugins["tp_plugin"] = TensorParallelPlugin(tp_size=axes.tp)
    accelerator = Accelerator(mixed_precision="bf16", cpu=args.cpu, **plugins)
    shape = dict(accelerator.mesh.shape)
    accelerator.print(f"mesh: {shape}")

    pp = max(shape.get("pp", 1), 1)
    cfg = LlamaConfig.tiny(num_hidden_layers=max(2 * pp, 2), use_flash_attention=False)
    module = PipelinedLlamaForCausalLM(
        cfg, device=accelerator.device, num_microbatches=max(pp, 2),
        generator=torch.Generator(device=accelerator.device).manual_seed(0))
    pipe = prepare_pipeline(accelerator.prepare(module), accelerator=accelerator)

    # Any batch size: 5 is not a multiple of the microbatch count; the
    # inputs are padded and the outputs cut back.
    ids = (torch.arange(5 * 32, device=accelerator.device).reshape(5, 32) % cfg.vocab_size)
    logits = pipe(ids)
    accelerator.print(f"first call: logits {tuple(logits.shape)}")

    t0 = time.perf_counter()
    logits = pipe(ids)
    logits[0, 0, 0].item()  # waits for the device
    accelerator.print(f"steady-state forward: {1000 * (time.perf_counter() - t0):.1f} ms")
    accelerator.print("pipeline inference example: OK")


if __name__ == "__main__":
    main()
