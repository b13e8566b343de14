"""Fine-tune a HuggingFace checkpoint on the PyTorch/CUDA port and export it
back to HF format (counterpart of examples/by_feature/hf_checkpoint_finetune.py).

``load_hf_checkpoint`` reads an HF checkpoint directory (config.json and
safetensors, HF tensor names) into the port's state dict, the
``Accelerator`` loop fine-tunes it, and ``export_hf_state_dict`` writes
the result back under HF names, loadable by transformers. Without
``--checkpoint_dir`` the script first writes a tiny Llama checkpoint in
HF's on-disk format; the load path is the same. On the card by default;
``--cpu`` on the CPU.
"""

import json
import sys
import tempfile
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[2])]

import numpy as np
import torch
from safetensors.torch import save_file

from accelerate_tpu_torch import Accelerator, NumpyDataLoader
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, causal_lm_loss
from accelerate_tpu_torch.utils import set_seed
from accelerate_tpu_torch.utils.hf_interop import (
    detect_family,
    export_hf_state_dict,
    load_hf_checkpoint,
    model_from_config,
)
from example_lib_torch import common_parser


def synthesize_hf_checkpoint(path: Path, seed: int) -> Path:
    """A tiny Llama checkpoint in HF's on-disk format."""
    cfg = LlamaConfig.tiny(use_flash_attention=False)
    model = LlamaForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    save_file({k: v.contiguous() for k, v in export_hf_state_dict(model, "llama").items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": False,
    }))
    return path


def training_function(args):
    set_seed(args.seed)
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir is None:
        ckpt_dir = synthesize_hf_checkpoint(Path(tempfile.mkdtemp()), args.seed)

    with open(Path(ckpt_dir) / "config.json") as f:
        hf_config = json.load(f)
    family = detect_family(hf_config)
    if family not in ("llama", "mistral", "gpt2"):
        raise SystemExit(f"this example fine-tunes causal-LM families (llama/mistral/gpt2); "
                         f"the checkpoint is {family!r}")
    config, state_dict = load_hf_checkpoint(str(ckpt_dir), family)
    config.use_flash_attention = False

    accelerator = Accelerator(mixed_precision=args.mixed_precision, cpu=args.cpu)
    module = model_from_config(config, family, device=accelerator.device)
    module.load_state_dict(state_dict)
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, config.vocab_size, size=(128, 32)).astype(np.int32)
    loader = NumpyDataLoader([{"input_ids": row} for row in tokens], batch_size=args.batch_size,
                             drop_last=True)
    model, optimizer, loader = accelerator.prepare(
        module, torch.optim.AdamW(module.parameters(), lr=args.lr, weight_decay=1e-4), loader)
    step = accelerator.compile_train_step(causal_lm_loss(model), max_grad_norm=1.0)
    for epoch in range(args.epochs):
        losses = [step(b)["loss"] for b in loader]
        accelerator.print(f"epoch {epoch}: loss {torch.stack(losses).mean().item():.4f}")

    # Back to HF names: loadable by transformers.LlamaForCausalLM.
    out_dir = Path(args.output_dir or tempfile.mkdtemp())
    out_dir.mkdir(parents=True, exist_ok=True)
    sd = export_hf_state_dict(accelerator.get_state_dict(model), family)
    save_file({k: v.detach().cpu().contiguous() for k, v in sd.items()},
              str(out_dir / "model.safetensors"))
    # The config comes along, so transformers' from_pretrained(out_dir) works.
    (out_dir / "config.json").write_text(json.dumps(hf_config))
    accelerator.print(f"exported fine-tuned weights (HF names) to {out_dir}")


def main():
    parser = common_parser(__doc__)
    parser.add_argument("--checkpoint_dir", default=None,
                        help="HF checkpoint dir (default: synthesize a tiny one)")
    parser.add_argument("--output_dir", default=None)
    training_function(parser.parse_args())


if __name__ == "__main__":
    main()
