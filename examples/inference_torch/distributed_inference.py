"""Prompt-parallel distributed inference on the PyTorch/CUDA port
(counterpart of examples/inference/distributed_inference.py).

Each process takes its share of the prompt list with
``split_between_processes``, generates with the KV-cached ``generate``,
and one ``gather_object`` collects the ragged results in rank order.

    python -m accelerate_tpu_torch.commands.accelerate_cli launch --num_processes 2 \
        --use_cpu_emulation examples/inference_torch/distributed_inference.py
    python examples/inference_torch/distributed_inference.py     # one process, on the card

On the card by default (one process a card); ``--cpu`` on the CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import Accelerator, generate
from accelerate_tpu_torch.models.phi import PhiConfig, PhiForCausalLM
from accelerate_tpu_torch.utils.operations import gather_object

PROMPTS = [[5, 17, 3], [29, 11, 7], [2, 41, 19], [23, 13, 31], [9, 25, 6]]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args()
    accelerator = Accelerator(cpu=args.cpu)
    cfg = PhiConfig.tiny(use_flash_attention=False)
    model = PhiForCausalLM(cfg, device=accelerator.device,
                           generator=torch.Generator(device=accelerator.device).manual_seed(0))

    completions = []
    with accelerator.split_between_processes(PROMPTS) as my_prompts:
        for prompt in my_prompts:
            ids = torch.tensor([prompt], device=accelerator.device)
            completions.append(generate(model, ids, max_new_tokens=6)[0].tolist())

    all_completions = gather_object(completions)
    if accelerator.is_main_process:
        if len(all_completions) != len(PROMPTS):
            raise RuntimeError(f"gathered {len(all_completions)} completions for "
                               f"{len(PROMPTS)} prompts")
        for prompt, full in zip(PROMPTS, all_completions):
            print(f"  {prompt} -> {full}")
        print("distributed inference example: OK")


if __name__ == "__main__":
    main()
