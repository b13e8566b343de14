"""Speculative decoding, both kinds, on the PyTorch/CUDA port (counterpart
of examples/inference/speculative_decoding.py).

Prompt lookup drafts the continuation of the latest earlier occurrence of
the last n-gram; assisted decoding asks a small model of the same
vocabulary. Either way the target checks the whole draft in one cached
forward, so the output equals plain greedy decoding, reached in fewer and
wider steps. Shown on the resident model (``prompt_lookup_generate``,
``assisted_generate``) and on weights streamed from disk
(``StreamedModel.generate`` with both drafters), each checked exact. On
the card by default; ``--cpu`` on the CPU.
"""

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

import torch

from accelerate_tpu_torch import (
    assisted_generate,
    generate,
    load_checkpoint_and_dispatch,
    prompt_lookup_generate,
    save_model,
)
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.utils import resolve_device, set_seed


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = parser.parse_args()
    device = resolve_device("cpu" if args.cpu else None)
    set_seed(0)
    cfg = LlamaConfig.tiny(use_flash_attention=False)
    model = LlamaForCausalLM(cfg, device=device,
                             generator=torch.Generator(device=device).manual_seed(0))

    # A self-repeating prompt: what prompt lookup speeds up (code, quotes,
    # retrieved contexts).
    ids = torch.tensor([[7, 11, 13]], device=device).repeat(1, 4)

    ref = generate(model, ids, max_new_tokens=24, cache_dtype=torch.float32)
    spec = prompt_lookup_generate(model, ids, max_new_tokens=24, num_draft=5,
                                  cache_dtype=torch.float32)
    if not torch.equal(ref, spec):
        raise RuntimeError("speculation must be greedy-exact")
    print(f"resident model: speculative output == greedy output "
          f"({spec.shape[1] - ids.shape[1]} tokens)")

    # Draft-model speculation: a smaller model of the same vocabulary
    # proposes the chunks (here a 1-layer sibling; in practice a distilled
    # draft).
    draft = LlamaForCausalLM(dataclasses.replace(cfg, num_hidden_layers=1), device=device,
                             generator=torch.Generator(device=device).manual_seed(7))
    spec = assisted_generate(model, draft, ids, max_new_tokens=24, num_draft=5,
                             cache_dtype=torch.float32)
    if not torch.equal(ref, spec):
        raise RuntimeError("assisted decoding must be target-exact")
    print("resident model: assisted (draft-model) output == greedy output")

    # Streamed weights: they stream once per accepted run, not per token,
    # which pays where weight traffic is most of a token's time (host or
    # disk tiers).
    with tempfile.TemporaryDirectory() as d:
        save_model(None, model, d)
        streamed = load_checkpoint_and_dispatch(model, d, device_map={"": "disk"},
                                                dtype=torch.float32, execution_device=device)
        plain = streamed.generate(ids, max_new_tokens=14)
        spec = streamed.generate(ids, max_new_tokens=14, prompt_lookup_num_tokens=4)
        assisted = streamed.generate(ids, max_new_tokens=14, assistant_model=draft,
                                     num_draft=4)
        streamed.close()
    if not (torch.equal(plain, spec) and torch.equal(plain, assisted)):
        raise RuntimeError("the streamed drafters must equal the streamed greedy output")
    print("streamed model: both drafters == greedy output (disk tier)")
    print("speculative decoding example: OK")


if __name__ == "__main__":
    main()
