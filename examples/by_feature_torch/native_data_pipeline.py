"""The native data pipeline for LM pretraining on the PyTorch/CUDA port
(counterpart of examples/by_feature/native_data_pipeline.py).

``TokenBinDataLoader`` reads ``seq_len`` windows straight from a flat
token binary with a threaded pread ring (``native/``, C++ built at first
use), ``prefetch_depth`` batches ahead of the step; its position
round-trips through ``state_dict``. The script times the bare pipeline,
resumes a loader, then trains a tiny Llama from the binary. On the card by
default; ``--cpu`` on the CPU.
"""

import os
import sys
import tempfile
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, make_global_batch
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, causal_lm_loss
from accelerate_tpu_torch.native.io import TokenBinDataLoader
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import common_parser


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    cfg = LlamaConfig.tiny(use_flash_attention=False)

    # A flat token binary, the on-disk format of tokenized pretraining
    # shards; small on purpose: it shows the path, not IO at scale.
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, cfg.vocab_size, 1 << 14).astype(np.int32)
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        tokens.tofile(f)
        bin_path = f.name
    try:
        _run(args, accelerator, cfg, tokens, bin_path)
    finally:
        os.unlink(bin_path)


def _run(args, accelerator, cfg, tokens, bin_path):
    loader = TokenBinDataLoader(bin_path, seq_len=args.seq_len, batch_size=args.batch_size,
                                num_processes=accelerator.num_processes,
                                process_index=accelerator.process_index, prefetch_depth=4,
                                seed=args.seed)

    # The bare pipeline (pread ring, no compute); a tiny file reads at
    # memory speed.
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    dt = time.perf_counter() - t0
    mb = len(tokens) * tokens.itemsize / 2**20
    accelerator.print(f"native ring: {n_batches} batches / {mb:.1f} MiB in {dt:.3f}s "
                      f"({mb / max(dt, 1e-9):.0f} MiB/s)")

    # The position round-trips through state_dict like every loader's.
    it = iter(loader)
    next(it), next(it)
    saved = loader.state_dict()
    it.close()  # release the prefetch ring (threads, fd, buffers) now
    resumed = TokenBinDataLoader(bin_path, seq_len=args.seq_len, batch_size=args.batch_size,
                                 num_processes=accelerator.num_processes,
                                 process_index=accelerator.process_index, seed=args.seed)
    resumed.load_state_dict(saved)
    accelerator.print(f"resume state: {saved}")

    # Train from the loader ({"input_ids": [B, S]} int32 batches).
    gen = torch.Generator(device=accelerator.device).manual_seed(args.seed)
    module = LlamaForCausalLM(cfg, device=accelerator.device, generator=gen)
    model, optimizer = accelerator.prepare(
        module, torch.optim.AdamW(module.parameters(), lr=args.lr, weight_decay=1e-4))
    step = accelerator.compile_train_step(causal_lm_loss(model), max_grad_norm=1.0)
    losses = []
    for epoch in range(args.epochs):
        for batch in loader:
            if len(losses) >= args.steps:
                break
            losses.append(step(make_global_batch(batch, accelerator))["loss"].item())
    accelerator.print(f"trained {len(losses)} steps from the token binary: "
                      f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--steps", type=int, default=16)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
