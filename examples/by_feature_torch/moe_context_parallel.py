"""Expert and context parallelism on the PyTorch/CUDA port (counterpart of
examples/by_feature/moe_context_parallel.py).

Trains a sparse-MoE Mixtral over a dp x ep mesh (experts split over
``ep``, tokens dispatched to their experts' processes by all-to-alls),
then runs a long sequence through a dense Llama over a dp x cp mesh with
exact ring attention: each process holds its chunk of the sequence and
the K/V chunks travel round the ring. A world of 4 on the CPU:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch --num_processes 4 \
        --use_cpu_emulation examples/by_feature_torch/moe_context_parallel.py

With one process both axes are 1. On the card by default (one process a
card); ``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, MeshConfig, make_global_batch
from accelerate_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
    mixtral_lm_loss,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils import ExpertParallelPlugin, set_seed
from example_lib_torch import common_parser


def fresh_state():
    """A new accelerator state; the process and its process group stay."""
    AcceleratorState._reset_state()
    GradientState._reset_state()


def train_moe(args):
    fresh_state()
    n_dev = PartialState(cpu=args.cpu).num_processes
    ep = min(args.ep, n_dev)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu,
                              mesh_config=MeshConfig(dp=n_dev // ep, ep=ep),
                              ep_plugin=ExpertParallelPlugin(ep_size=ep))
    cfg = MixtralConfig.tiny_moe(num_experts=max(ep, 2), use_flash_attention=False)
    gen = torch.Generator(device=accelerator.device).manual_seed(args.seed)
    module = MixtralForCausalLM(cfg, device=accelerator.device, generator=gen)
    model, optimizer = accelerator.prepare(
        module, torch.optim.AdamW(module.parameters(), lr=args.lr, weight_decay=1e-4))
    step = accelerator.compile_train_step(mixtral_lm_loss(model, cfg), max_grad_norm=1.0)

    rng = np.random.default_rng(args.seed)
    with accelerator.mesh:
        losses = []
        for _ in range(args.steps):
            ids = rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
            batch = make_global_batch({"input_ids": ids}, accelerator, mesh=accelerator.mesh)
            losses.append(step(batch)["loss"].item())
    accelerator.print(f"MoE over {dict(accelerator.mesh.shape)}: loss {losses[0]:.4f} -> "
                      f"{losses[-1]:.4f}")


def run_long_context(args):
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    fresh_state()
    n_dev = PartialState(cpu=args.cpu).num_processes
    cp = min(args.cp, n_dev)
    accelerator = Accelerator(cpu=args.cpu, mesh_config=MeshConfig(dp=n_dev // cp, cp=cp))
    cfg = LlamaConfig.tiny(max_position_embeddings=4096, use_flash_attention=False,
                           attention_backend="ring")
    gen = torch.Generator(device=accelerator.device).manual_seed(args.seed)
    module = LlamaForCausalLM(cfg, device=accelerator.device, generator=gen)
    model = accelerator.prepare(module)

    seq_len = 1024 * cp  # scales with the mesh: each process holds 1024 tokens
    batch = max(2, n_dev // cp)  # the batch splits over dp
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq_len)).astype(np.int32)
    mesh = accelerator.mesh
    x = make_global_batch({"x": ids}, accelerator, mesh=mesh)["x"]
    chunk = seq_len // cp  # this process's part of every row
    x = x[:, mesh.coords["cp"] * chunk:(mesh.coords["cp"] + 1) * chunk]
    with mesh, torch.no_grad():
        logits = model(x)
    accelerator.print(f"ring attention over cp={cp}: seq {seq_len} -> logits "
                      f"{tuple(logits.shape)} on each process ({batch} x {seq_len} in all)")


def training_function(args):
    set_seed(args.seed)
    train_moe(args)
    run_long_context(args)


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--ep", type=int, default=2)
    parser.add_argument("--cp", type=int, default=2)
    parser.add_argument("--steps", type=int, default=6)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
