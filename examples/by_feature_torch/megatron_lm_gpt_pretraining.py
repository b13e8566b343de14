"""3D-parallel causal-LM pretraining on the PyTorch/CUDA port (counterpart
of examples/by_feature/megatron_lm_gpt_pretraining.py).

``MegatronLMPlugin``'s tp and pp degrees become the mesh's ``tp`` and ``pp``
axes over the process group (Megatron-style column and row projections,
GPipe over the stacked layers when pp > 1); the rest of the world is
``dp``. No Megatron engine runs: one ``compile_train_step``. A world of
4 at tp 2 x pp 2 on the CPU:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch --num_processes 4 \
        --use_cpu_emulation examples/by_feature_torch/megatron_lm_gpt_pretraining.py --tp 2 --pp 2

On the card by default (one process a card); ``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, MeshConfig, make_global_batch
from accelerate_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    PipelinedLlamaForCausalLM,
    causal_lm_loss,
)
from accelerate_tpu_torch.state import PartialState
from accelerate_tpu_torch.utils import MegatronLMPlugin, set_seed
from example_lib_torch import common_parser


def training_function(args):
    set_seed(args.seed)
    plugin = MegatronLMPlugin(tp_degree=args.tp, pp_degree=args.pp, num_micro_batches=2,
                              sequence_parallelism=args.tp > 1)
    n_dev = PartialState(cpu=args.cpu).num_processes
    dp = max(n_dev // (args.tp * args.pp), 1)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu,
                              mesh_config=MeshConfig(dp=dp, tp=args.tp, pp=args.pp),
                              megatron_lm_plugin=plugin)
    cfg = LlamaConfig.tiny(num_hidden_layers=max(2 * args.pp, 2), use_flash_attention=False)
    gen = torch.Generator(device=accelerator.device).manual_seed(args.seed)
    if args.pp > 1:
        module = PipelinedLlamaForCausalLM(cfg, device=accelerator.device, generator=gen,
                                           num_microbatches=2)
    else:
        module = LlamaForCausalLM(cfg, device=accelerator.device, generator=gen)
    model, optimizer = accelerator.prepare(
        module, torch.optim.AdamW(module.parameters(), lr=args.lr, weight_decay=1e-4))
    step = accelerator.compile_train_step(causal_lm_loss(model), max_grad_norm=1.0)

    rng = np.random.default_rng(args.seed)
    batch_size = max(4, 2 * dp)
    with accelerator.mesh:
        losses = []
        for _ in range(args.steps):
            ids = rng.integers(0, cfg.vocab_size, (batch_size, args.seq_len)).astype(np.int32)
            batch = make_global_batch({"input_ids": ids}, accelerator, mesh=accelerator.mesh)
            losses.append(step(batch)["loss"].item())
    accelerator.print(f"mesh {dict(accelerator.mesh.shape)}: loss {losses[0]:.4f} -> "
                      f"{losses[-1]:.4f} over {args.steps} steps")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--tp", type=int, default=2)
    parser.add_argument("--pp", type=int, default=1)
    parser.add_argument("--seq_len", type=int, default=32)
    parser.add_argument("--steps", type=int, default=8)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
