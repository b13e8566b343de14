"""Sequence packing on the PyTorch/CUDA port: train on variable-length
documents without padding waste (counterpart of examples/by_feature/sequence_packing.py).

``pack_sequences`` bins documents into fixed-length rows (best-fit
decreasing); ``segment_ids`` keep attention inside each document and
``positions`` restart the rotary positions at each document's start, so
the packed forward equals the documents' forwards run alone, at a fraction
of the padded token count. The train step takes the packed batch as it is
(``causal_lm_loss`` passes the packed keys on). On the card by default;
``--cpu`` on the CPU.
"""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import numpy as np
import torch

from accelerate_tpu_torch import Accelerator, make_global_batch, pack_sequences
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, causal_lm_loss
from accelerate_tpu_torch.utils import set_seed
from example_lib_torch import common_parser


def training_function(args):
    set_seed(args.seed)
    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    cfg = LlamaConfig.tiny(use_flash_attention=False)
    gen = torch.Generator(device=accelerator.device).manual_seed(args.seed)
    module = LlamaForCausalLM(cfg, device=accelerator.device, generator=gen)
    model, optimizer = accelerator.prepare(
        module, torch.optim.AdamW(module.parameters(), lr=args.lr, weight_decay=1e-4))
    step = accelerator.compile_train_step(causal_lm_loss(model), max_grad_norm=1.0)

    rng = np.random.default_rng(args.seed)
    # A synthetic corpus of ragged documents.
    docs = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in rng.integers(4, args.seq_len, size=256)]
    packed = pack_sequences(docs, seq_len=args.seq_len)
    total_tokens = sum(len(d) for d in docs)
    rows = packed["input_ids"].shape[0]
    fill = total_tokens / (rows * args.seq_len)
    accelerator.print(
        f"packed {len(docs)} docs ({total_tokens} tokens) into {rows} rows "
        f"of {args.seq_len} — {fill:.0%} fill vs "
        f"{total_tokens / (len(docs) * args.seq_len):.0%} if padded per-doc")

    n_dev = accelerator.num_processes
    pad_rows = -(-rows // n_dev) * n_dev - rows  # a row count every process divides
    batch = {k: np.concatenate(
        [v, np.full((pad_rows, v.shape[1]), -100 if k == "labels" else 0, v.dtype)])
        for k, v in packed.items()}
    batch = make_global_batch(batch, accelerator, mesh=accelerator.mesh)
    for epoch in range(args.epochs):
        accelerator.print(f"epoch {epoch}: loss {step(batch)['loss'].item():.4f}")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--seq_len", type=int, default=64)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
