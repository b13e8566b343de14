"""``estimate-memory``: the port's table against the JAX command's.

Both commands run in this process on the same arguments and their printed
lines are compared one for one: parameters, bytes per dtype, gradients and
Adam, the per-chip shares under ``--fsdp``, ``--zero`` and ``--tp``, the
paged KV pool, the speculative columns and the LoRA lines. The port builds
its model on the meta device, the JAX command takes ``jax.eval_shape``; a
checkpoint's safetensors headers and a HF ``config.json`` (written here)
serve both. What differs by construction is named:

* ``LORA_NO_TARGET``, the message when no projection matches (the JAX
  package says "the params pytree", the port "the model");
* with a ``config.json``, the JAX command keeps the abstract tree and drops
  the model it built (``_abstract_from_path`` returns the tree alone), so
  its paged-pool and KV-per-chip lines say "n/a (no model config ...)" and
  ``--page-size`` exits 2. The port keeps the model and sizes them from
  its config; the rest of the table is the same.
"""

import contextlib
import io
import json

import numpy as np
import pytest

#: Every name of the JAX command's registry.
NAMES = ["llama3-8b", "llama-tiny", "qwen2-7b", "gemma2-9b", "gptj-6b", "mixtral-8x7b",
         "gpt-neox-20b", "opt-30b", "phi-2", "bert-base"]

#: The flag sets of ``tests/test_cli.py``'s estimate-memory cases, and every
#: other flag once.
FLAG_SETS = {
    "tiny": ["--dtypes", "float32", "bfloat16"],
    "lora_rank": ["--dtypes", "float32", "--lora-rank", "8"],
    "tp": ["--dtypes", "bfloat16", "--tp", "2", "--lora-rank", "8"],
    "tp_not_divisible": ["--dtypes", "bfloat16", "--tp", "3"],
    "zero": ["--dtypes", "float32", "--zero", "8"],
    "zero_bare": ["--dtypes", "float32", "--zero"],
    "zero_not_divisible": ["--dtypes", "float32", "--zero", "7"],
    "page_sizing": ["--dtypes", "bfloat16", "--page-size", "16", "--max-pages", "256",
                    "--seq-lens", "32", "128"],
    "spec_tokens": ["--dtypes", "bfloat16", "--page-size", "16", "--max-pages", "256",
                    "--seq-lens", "32", "128", "--spec-tokens", "4"],
    "everything": ["--fsdp", "4", "--zero", "8", "--tp", "2", "--lora-rank", "16",
                   "--page-size", "16", "--max-pages", "512", "--seq-lens", "100", "4096",
                   "--kv-dtype", "int8", "--weights-dtype", "int8", "--spec-tokens", "3",
                   "--draft-rank", "32"],
    "spec_without_pages": ["--spec-tokens", "2"],
}

LORA_NO_TARGET = ("matched nothing in the params pytree", "matched nothing in the model")


def run(package: str, argv: list) -> tuple:
    """``(return code, stdout lines)`` of ``package``'s command."""
    import importlib

    mod = importlib.import_module(f"{package}.commands.estimate")
    args = mod.estimate_command_parser().parse_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.estimate_command(args)
    return rc, out.getvalue().splitlines()


def assert_same_table(argv, monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_MESH_DP", "8")  # bare --zero: 8 replicas on both
    ref_rc, ref = run("accelerate_tpu", argv)
    rc, got = run("accelerate_tpu_torch", argv)
    ref = [line.replace(*LORA_NO_TARGET) for line in ref]
    assert rc == ref_rc
    assert got == ref
    return got


@pytest.mark.parametrize("name", NAMES)
def test_every_registry_name_prints_the_jax_table(name, monkeypatch):
    lines = assert_same_table([name, *FLAG_SETS["everything"]], monkeypatch)
    assert lines[0].startswith(f"Model: {name}")


@pytest.mark.parametrize("flags", sorted(FLAG_SETS), ids=str)
def test_the_cli_flag_sets_print_the_jax_table(flags, monkeypatch):
    lines = assert_same_table(["llama-tiny", *FLAG_SETS[flags]], monkeypatch)
    if flags == "tp":
        assert any("128 B/token/slot" in line for line in lines)
    if flags == "zero":
        assert any("106.50 KiB/replica" in line for line in lines)
        assert any("99.7% of elements sharded" in line for line in lines)


def _checkpoint_tensors():
    """A Llama-layout checkpoint of two layers, HF names, mixed dtypes."""
    import torch

    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    out = {}
    for i, (name, t) in enumerate(model.state_dict().items()):
        out[name] = t.to(torch.bfloat16 if i % 2 else torch.float32).contiguous()
    return out


@pytest.mark.parametrize("layout", ["file", "shards"])
def test_safetensors_headers_print_the_jax_table(layout, tmp_path, monkeypatch):
    from safetensors.torch import save_file

    tensors = _checkpoint_tensors()
    if layout == "file":
        path = tmp_path / "model.safetensors"
        save_file(tensors, str(path))
    else:
        names = sorted(tensors)
        save_file({k: tensors[k] for k in names[::2]}, str(tmp_path / "a.safetensors"))
        save_file({k: tensors[k] for k in names[1::2]}, str(tmp_path / "b.safetensors"))
        path = tmp_path
    lines = assert_same_table([str(path), "--zero", "4", "--fsdp", "2"], monkeypatch)
    n = sum(int(np.prod(t.shape)) for t in tensors.values())
    assert lines[0].endswith(f"({n / 1e9:.2f} B params)")
    # No config: the paged pool cannot be sized and no projection is found,
    # in either command.
    assert_same_table([str(path), "--page-size", "16"], monkeypatch)
    assert_same_table([str(path), "--lora-rank", "8", "--tp", "2"], monkeypatch)


def test_a_llama_config_json_prints_the_jax_table(tmp_path, monkeypatch):
    config = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
              "vocab_size": 1000, "hidden_size": 256, "intermediate_size": 688,
              "num_hidden_layers": 3, "num_attention_heads": 8, "num_key_value_heads": 4,
              "max_position_embeddings": 512, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
              "tie_word_embeddings": False, "hidden_act": "silu",
              "rope_scaling": {"rope_type": "yarn", "factor": 4.0}}
    (tmp_path / "config.json").write_text(json.dumps(config))
    flags = ["--fsdp", "4", "--zero", "8", "--lora-rank", "16", "--weights-dtype", "int8"]
    for target in (tmp_path, tmp_path / "config.json"):
        assert_same_table([str(target), *flags], monkeypatch)
    # The geometry from the config: 2 x 3 layers x 4 kv-heads x 32 head-dim.
    argv = [str(tmp_path), "--tp", "2", "--page-size", "16", "--kv-dtype", "int8"]
    ref_rc, ref = run("accelerate_tpu", argv)
    rc, got = run("accelerate_tpu_torch", argv)
    assert ref_rc == 2 and ref[-1].startswith("Paged KV pool: n/a")
    assert rc == 0 and got[:len(ref) - 2] == ref[:-2]
    assert "  bytes per token : 768 B" in got
    assert any("KV cache per chip (bf16)  : 768 B/token/slot" in line for line in got)


def test_unknown_names_exit_2_in_both(tmp_path, monkeypatch):
    lines = assert_same_table(["no-such-model"], monkeypatch)
    assert lines[0].startswith("Unknown model 'no-such-model'")
    assert run("accelerate_tpu_torch", [str(tmp_path / "missing.bin")])[0] == 2


def test_the_cli_registers_estimate_memory():
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli",
                          "estimate-memory", "llama-tiny", "--dtypes", "bfloat16"],
                         cwd=str(repo), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("Model: llama-tiny")
