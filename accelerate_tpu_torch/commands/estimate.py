"""`accelerate-tpu-torch estimate-memory`, the counterpart of
``accelerate_tpu/commands/estimate.py``.

The model is built on the meta device (``big_modeling.init_empty_weights``):
a built-in family by name, or the tree of shapes a local checkpoint's
safetensors headers give (``checkpointing.SafetensorsFile``), or an HF
``config.json``. Nothing is allocated on a device. The table is the JAX
command's, number for number: parameters, bytes per dtype
(``utils/modeling.py``'s ``calculate_maximum_sizes``), gradients and Adam
(f32 master + 2 moments), the per-chip shares under ``--fsdp``, ``--zero``
and ``--tp``, the paged KV pool and speculative columns, and the LoRA
lines. Splits are decided on each leaf's shape in the JAX layout
(``parallel/sharding.py``'s ``reference_path``/``ShardingRules``).
"""

from __future__ import annotations

import argparse
import math


def _model_registry():
    from ..models.bert import BertConfig, BertForSequenceClassification
    from ..models.gpt_neox import GPTNeoXConfig, GPTNeoXForCausalLM
    from ..models.gptj import GPTJConfig, GPTJForCausalLM
    from ..models.llama import LlamaConfig, LlamaForCausalLM
    from ..models.mixtral import MixtralConfig, MixtralForCausalLM
    from ..models.opt import OPTConfig, OPTForCausalLM
    from ..models.phi import PhiConfig, PhiForCausalLM

    def llama(name):
        return lambda: LlamaForCausalLM(getattr(LlamaConfig, name)())

    return {
        "llama3-8b": llama("llama3_8b"),
        "llama-tiny": llama("tiny"),
        "qwen2-7b": llama("qwen2_7b"),
        "gemma2-9b": llama("gemma2_9b"),
        # The reference's own big-model benchmark families.
        "gptj-6b": lambda: GPTJForCausalLM(GPTJConfig.gptj_6b()),
        "mixtral-8x7b": lambda: MixtralForCausalLM(MixtralConfig.mixtral_8x7b()),
        "gpt-neox-20b": lambda: GPTNeoXForCausalLM(GPTNeoXConfig.neox_20b()),
        "opt-30b": lambda: OPTForCausalLM(OPTConfig.opt_30b()),
        "phi-2": lambda: PhiForCausalLM(PhiConfig.phi_2()),
        "bert-base": lambda: BertForSequenceClassification(BertConfig.base()),
    }


def _on_meta(build):
    """``build()`` on the meta device: shapes and dtypes, no memory."""
    from ..big_modeling import init_empty_weights

    with init_empty_weights():
        return build()


def _leaves(tree) -> list:
    from ..utils.modeling import named_parameters

    return list(named_parameters(tree).values())


def _abstract_from_path(path: str):
    """``(tree, module)`` of a local checkpoint, no weights read: a
    ``.safetensors`` file or a directory of shards gives ``{name: meta
    tensor}`` from the headers (module None), a HF ``config.json``
    describing a supported family the model on the meta device (tree and
    module both). ``(None, None)`` for anything else."""
    import json
    import os
    from pathlib import Path

    import torch

    from ..checkpointing import SafetensorsFile

    def from_shards(paths):
        flat = {}
        for p in paths:
            f = SafetensorsFile(p)
            for key in f.keys():
                dtype, shape, _ = f.meta(key)
                flat[key] = torch.empty(shape, dtype=dtype, device="meta")
        return flat, None

    if os.path.isfile(path) and path.endswith(".safetensors"):
        return from_shards([path])
    if os.path.isdir(path):
        shards = sorted(os.path.join(path, f) for f in os.listdir(path)
                        if f.endswith(".safetensors"))
        if shards:
            return from_shards(shards)
        path = os.path.join(path, "config.json")
    if os.path.isfile(path) and path.endswith(".json"):
        from ..utils.hf_interop import config_from_hf, detect_family, model_from_config

        cfg_dict = json.loads(Path(path).read_text())
        # Fields that change values, never shapes: a size estimate must not
        # refuse a yarn-scaled or gelu llama variant.
        cfg_dict.pop("rope_scaling", None)
        cfg_dict.pop("hidden_act", None)
        family = detect_family(cfg_dict)
        module = model_from_config(config_from_hf(cfg_dict, family), family, device="meta")
        return module, module
    return None, None


def _default_replicas() -> int:
    """Bare ``--zero``: the launcher's mesh dp, else the card count (at
    least 1)."""
    import os

    import torch

    from ..utils.environment import env_var

    env_dp = os.environ.get(env_var("MESH_DP"))
    if env_dp and int(env_dp) > 0:
        return int(env_dp)
    return max(torch.cuda.device_count(), 1)


def _tp_param_split(abstract, tp: int):
    """(per_chip_elems, sharded_elems, total_elems) under the serving TP
    rules: a leaf divides by ``tp`` exactly when a Megatron column/row rule
    matches its path in the JAX layout AND the ruled dimension (of its
    shape in that layout) is divisible: the JAX command's predicate."""
    from ..parallel.sharding import ShardingRules, reference_path, reference_shape
    from ..utils.modeling import named_parameters

    rules = ShardingRules()
    module = abstract if hasattr(abstract, "get_submodule") else None
    counts = {"per_chip": 0, "sharded": 0, "total": 0}
    for name, leaf in named_parameters(abstract).items():
        shape = tuple(leaf.shape)
        path = name.replace(".", "/")
        if module is not None:
            path, shape = reference_path(module, name), reference_shape(module, name, shape)
        n = math.prod(shape)
        counts["total"] += n
        dim = rules.tp_dim_for(path)
        if dim is not None and shape and shape[dim % len(shape)] % tp == 0:
            counts["per_chip"] += n // tp
            counts["sharded"] += n
        else:
            counts["per_chip"] += n
    return counts["per_chip"], counts["sharded"], counts["total"]


def _zero_opt_split(abstract, n: int, min_size: int = 2**11):
    """(per_chip_elems, sharded_elems, total_elems, fallback_leaves) for the
    f32 Adam moments under ZeRO-``n``: a moment shards 1/n exactly when
    some dimension divides by ``n`` and the leaf holds at least
    ``min_size`` elements (the policy of ``zero_specs``); anything else
    replicates (the printed fallback count)."""
    per_chip = sharded = total = fallback = 0
    for leaf in _leaves(abstract):
        shape = tuple(leaf.shape)
        size = math.prod(shape)
        total += size
        divisible = any(d % n == 0 and d >= n for d in shape)
        if size >= min_size and divisible:
            per_chip += size // n
            sharded += size
        else:
            per_chip += size
            if size >= min_size:
                fallback += 1
    return per_chip, sharded, total, fallback


def _kv_geometry(module):
    """(layers, kv_heads, head_dim) from the module's config, or None when
    the abstract tree came from bare safetensors headers (no config)."""
    config = getattr(module, "config", None)
    if config is None:
        return None
    layers = getattr(config, "num_hidden_layers", None)
    heads = getattr(config, "num_attention_heads", None)
    if layers is None or heads is None:
        return None
    kv = getattr(config, "num_key_value_heads", None) or heads
    head_dim = getattr(config, "head_dim", None)
    if head_dim is None:
        hidden = getattr(config, "hidden_size", None)
        if hidden is None:
            return None
        head_dim = hidden // heads
    return int(layers), int(kv), int(head_dim)


def _fmt(nbytes: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if nbytes < 1024 or unit == "TiB":
            return f"{nbytes:.2f} {unit}" if unit != "B" else f"{int(nbytes)} B"
        nbytes /= 1024
    return f"{nbytes:.2f} TiB"


def estimate_command(args) -> int:
    import torch

    from ..utils.modeling import calculate_maximum_sizes, compute_module_sizes

    registry = _model_registry()
    module = None
    if args.model_name in registry:
        module = _on_meta(registry[args.model_name])
        abstract = module
    else:
        try:
            abstract, module = _abstract_from_path(args.model_name)
        except ValueError as e:
            import sys

            print(str(e), file=sys.stderr)
            return 2
        if abstract is None:
            print(
                f"Unknown model {args.model_name!r}. Pass a built-in name "
                f"({', '.join(sorted(registry))}), a .safetensors file/directory, "
                "or a llama-style config.json."
            )
            return 2
    n_params = sum(t.numel() for t in _leaves(abstract))

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": "int8", "int4": "int4"}
    selected = [d for d in args.dtypes if d in dtypes]
    # --zero N: per-chip fp32 Adam-moment share under ZeRO optimizer-state
    # sharding. N=0 ("--zero" bare) is dp-aware: the launcher's mesh dp if
    # set, else the device count.
    zero = getattr(args, "zero", None)
    if zero == 0:
        zero = _default_replicas()
    zero_split = _zero_opt_split(abstract, zero) if zero and zero > 1 else None
    print(f"Model: {args.model_name}  ({n_params / 1e9:.2f} B params)")
    header = f"{'dtype':>9} | {'largest layer':>14} | {'total size':>11} | {'training (Adam)':>16}"
    if args.fsdp > 1:
        header += f" | per-chip (fsdp={args.fsdp})"
    if zero_split is not None:
        header += f" | opt state/chip (zero={zero})"
    print(header)
    print("-" * len(header))
    for name in selected:
        dt = dtypes[name]
        # [._] + optional dotted prefix covers both the port's naming
        # (model.layers.0) and flax naming (layers_0).
        total, (largest, _) = calculate_maximum_sizes(
            abstract, no_split=[r"(.*\.)?layers[._]\d+", r"(.*\.)?h[._]\d+"], dtype=dt)
        # Training: bf16/fp32 params + same-dtype grads + fp32 master + 2 fp32
        # Adam moments (optax adamw); reference uses 4x fp32 params heuristic
        # (commands/estimate.py table).
        param_f32 = compute_module_sizes(abstract, dtype=torch.float32)[""]
        training = total * 2 + param_f32 * 3 if name in ("float32", "bfloat16") else float("nan")
        row = f"{name:>9} | {_fmt(largest):>14} | {_fmt(total):>11} | "
        row += f"{_fmt(training):>16}" if training == training else f"{'n/a (inference)':>16}"
        if args.fsdp > 1 and training == training:
            row += f" | {_fmt(training / args.fsdp):>14}"
        if zero_split is not None and training == training:
            # 2 fp32 moments on the per-chip element count (non-divisible
            # leaves replicated, matching infer_opt_state_shardings).
            row += f" | {_fmt(zero_split[0] * 4 * 2):>14}"
        print(row)
    if zero_split is not None:
        per_chip_e, sharded_e, total_e, n_fallback = zero_split
        print(f"ZeRO-{zero} optimizer state: {_fmt(total_e * 4 * 2)} fp32 moments "
              f"-> {_fmt(per_chip_e * 4 * 2)}/replica "
              f"({100.0 * sharded_e / max(total_e, 1):.1f}% of elements sharded)")
        if n_fallback:
            print(f"  {n_fallback} leaves have no dimension divisible by "
                  f"{zero}: REPLICATED (per-chip share above includes them "
                  f"in full)")
    if args.weights_dtype is not None:
        print(f"Serving weights ({args.weights_dtype}): the "
              f"{args.weights_dtype} row above is what the engine stores "
              "under weights_dtype='int8' (per-channel scales, dequantized "
              "on the fly); LoRA adapters ride full precision on top, so "
              "adapter math stays exact.")
    if args.lora_rank is not None:
        from ..adapters.lora import LoRAConfig, count_lora_params

        config = LoRAConfig(rank=args.lora_rank)
        try:
            if module is None:
                # Bare safetensors headers hold no projection modules (the
                # JAX command finds no flax kernel among HF names either).
                raise ValueError(f"target_modules {tuple(config.target_modules)!r} matched "
                                 "nothing in the model")
            n_lora, ckpt_bytes = count_lora_params(abstract, config)
        except ValueError as e:
            # e.g. a model family with no matching target modules.
            print(f"\nLoRA rank {args.lora_rank}: {e}")
            return 2
        print(f"\nLoRA rank {args.lora_rank} "
              f"(targets: q/k/v/o + gate/up/down projections):")
        print(f"  trainable params : {n_lora:,} "
              f"({100.0 * n_lora / max(n_params, 1):.3f}% of base)")
        print(f"  adapter checkpoint (fp32): {_fmt(ckpt_bytes)}")
        # Optimizer state only covers the trainable low-rank factors —
        # the base stays frozen, so Adam costs 2 fp32 moments on n_lora.
        print(f"  Adam moments (fp32)      : {_fmt(ckpt_bytes * 2)}")
    if args.spec_tokens is not None and args.page_size is None:
        print("--spec-tokens needs --page-size (speculative decoding "
              "requires the paged engine)")
        return 2
    if args.page_size is not None:
        geom = _kv_geometry(module)
        if geom is None:
            print("\nPaged KV pool: n/a (no model config — pass a built-in "
                  "name or config.json)")
            return 2
        layers, kv_heads, head_dim = geom
        kv_int8 = args.kv_dtype == "int8"
        itemsize = 1 if kv_int8 else 2
        per_tok = 2 * layers * kv_heads * head_dim * itemsize  # k+v
        # Quantized pages carry one f32 scale per pool leaf (k and v per
        # layer = 2*layers leaves) per page — mirrors the engine's
        # _page_bytes accounting exactly.
        scale_bytes = 2 * layers * 4 if kv_int8 else 0
        page_bytes = per_tok * args.page_size + scale_bytes
        fp_page_bytes = 2 * layers * kv_heads * head_dim * 2 * args.page_size
        # Per-chip share under --tp: pool leaves shard on kv-heads (or
        # head_dim) exactly like the dense cache, so the divisor matches
        # the KV-cache-per-chip line above.
        div = 1
        if args.tp > 1:
            div = (args.tp if kv_heads % args.tp == 0
                   else args.tp if head_dim % args.tp == 0 else 1)
        kv_label = ("int8 + per-page scales" if kv_int8 else "bf16")
        print(f"\nPaged KV pool (page_size={args.page_size} tokens, "
              f"{kv_label}, 2 x {layers} layers x {kv_heads} kv-heads x "
              f"{head_dim} head-dim):")
        print(f"  bytes per token : {_fmt(per_tok)}")
        print(f"  bytes per page  : {_fmt(page_bytes)}"
              + (f"  ({_fmt(page_bytes / div)}/chip at tp={args.tp})"
                 if args.tp > 1 else ""))
        if kv_int8:
            print(f"  vs full precision: {_fmt(fp_page_bytes)}/page -> "
                  f"{fp_page_bytes / page_bytes:.2f}x more pages "
                  "at equal pool bytes")
        if args.max_pages is not None:
            pool = args.max_pages * page_bytes
            print(f"  pool ({args.max_pages} pages): {_fmt(pool)}"
                  + (f"  ({_fmt(pool / div)}/chip at tp={args.tp})"
                     if args.tp > 1 else ""))
        print("  pages per request at sequence length "
              "(ceil(len / page_size) — dense reserves the max_len row):")
        for s in args.seq_lens:
            pages = -(-s // args.page_size)
            print(f"    {s:>7} tokens: {pages:>6} pages = {_fmt(pages * page_bytes)}"
                  + (f"  ({_fmt(pages * page_bytes / div)}/chip)"
                     if args.tp > 1 else ""))
        if args.max_pages is not None:
            print("  concurrent requests the pool fits at those lengths: "
                  + ", ".join(
                      f"{s}tok x {args.max_pages // max(1, -(-s // args.page_size))}"
                      for s in args.seq_lens))
        if args.spec_tokens is not None:
            K = args.spec_tokens
            print(f"\nSpeculative decoding (--spec-tokens {K}):")
            # Mirrors ServingEngine._spec_page_factor: draft KV pages come
            # from the SAME pool via a second page-table column, so a
            # draft-speculating request covers twice the pages and the
            # admission/router math charges 2x.
            print("  draft KV pages : same pool, second page-table column "
                  "-> 2x pages per request"
                  + (f" ({kv_label} pages)" if kv_int8 else "") + ":")
            for s in args.seq_lens:
                pages = 2 * -(-s // args.page_size)
                print(f"    {s:>7} tokens: {pages:>6} pages"
                      + (f" = {_fmt(pages * page_bytes)}" if kv_int8 else "")
                      + (f"  (pool fits {args.max_pages // pages} "
                         "concurrent)" if args.max_pages else ""))
            vocab = getattr(getattr(module, "config", None),
                            "vocab_size", None)
            if vocab:
                print("  verify activation delta: the verify forward "
                      f"widens [1, 1] -> [1, {K + 1}]: logits "
                      f"{_fmt(vocab * 2)} -> {_fmt((K + 1) * vocab * 2)}"
                      "/slot (bf16)")
            if args.draft_rank is not None:
                # Rank proxy for a small draft: kv-heads x head-dim
                # collapsed to --draft-rank per layer, k+v. The draft
                # pool quantizes alongside the base pool, scales and all.
                d_per_tok = 2 * layers * args.draft_rank * itemsize
                d_page = d_per_tok * args.page_size + scale_bytes
                d_label = "int8" if kv_int8 else "bf16"
                print(f"  draft KV (rank-{args.draft_rank} proxy, 2 x "
                      f"{layers} layers x {args.draft_rank} x {d_label}): "
                      f"{_fmt(d_per_tok)}/token, {_fmt(d_page)}/page"
                      + (f", pool +{_fmt(args.max_pages * d_page)}"
                         if args.max_pages is not None else ""))
    if args.tp > 1:
        per_chip, sharded, total_elems = _tp_param_split(abstract, args.tp)
        print(f"\nTensor-parallel slice (tp={args.tp}, Megatron "
              "column/row layout — the mesh-sliced serving engine's split):")
        print(f"  params per chip (bfloat16): {_fmt(per_chip * 2)}  "
              f"({100.0 * sharded / max(total_elems, 1):.1f}% of weights "
              f"sharded, rest replicated)")
        print(f"  params per chip (float32) : {_fmt(per_chip * 4)}")
        # Grads + fp32 master + 2 Adam moments shard exactly like their
        # params (same PartitionSpecs), so per-chip training state is the
        # table's formula applied to the per-chip element count.
        print(f"  training (Adam) per chip  : {_fmt(per_chip * 2 * 2 + per_chip * 4 * 3)}")
        geom = _kv_geometry(module)
        if geom is not None:
            layers, kv_heads, head_dim = geom
            # The engine shards the KV heads axis when divisible, else the
            # head_dim axis, else the cache replicates (SliceExec.heads_axis).
            div = (args.tp if kv_heads % args.tp == 0
                   else args.tp if head_dim % args.tp == 0 else 1)
            per_tok = 2 * layers * kv_heads * head_dim * 2  # k+v, bf16
            note = "" if div == args.tp else "  (heads not divisible: REPLICATED)"
            print(f"  KV cache per chip (bf16)  : {_fmt(per_tok / div)}/token/slot"
                  f"  [2 x {layers} layers x {kv_heads} kv-heads x "
                  f"{head_dim} head-dim]{note}")
        else:
            print("  KV cache per chip         : n/a (no model config — pass "
                  "a built-in name or config.json)")
        if args.lora_rank is not None:
            from ..adapters.lora import LoRAConfig, _shapes, target_paths
            from ..parallel.sharding import ShardingRules, reference_path

            rules = ShardingRules()
            shapes = _shapes(abstract)
            bank_pc = bank_total = 0
            for dotted in target_paths(abstract, LoRAConfig(rank=args.lora_rank)):
                d_in, d_out = shapes[dotted]
                a_n, b_n = int(d_in) * args.lora_rank, args.lora_rank * int(d_out)
                tp_dim = rules.tp_dim_for(reference_path(abstract, dotted + ".weight"))
                if tp_dim == -1 and d_out % args.tp == 0:      # column: shard b
                    pc = a_n + b_n // args.tp
                elif tp_dim == -2 and d_in % args.tp == 0:     # row: shard a
                    pc = a_n // args.tp + b_n
                else:
                    pc = a_n + b_n
                bank_pc += pc
                bank_total += a_n + b_n
            print(f"  adapter bank row per chip (rank {args.lora_rank}, fp32): "
                  f"{_fmt(bank_pc * 4)}  (x max_adapters rows; "
                  f"{_fmt(bank_total * 4)} unsharded)")
    return 0


def estimate_command_parser(subparsers=None):
    description = "Estimate the device memory a model family needs for inference or training"
    if subparsers is not None:
        parser = subparsers.add_parser("estimate-memory", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch estimate-memory",
                                         description=description)
    parser.add_argument(
        "model_name",
        help="Built-in model name (e.g. llama3-8b), a .safetensors checkpoint "
             "file/directory, or a llama-style config.json",
    )
    parser.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16", "int8", "int4"])
    parser.add_argument("--fsdp", type=int, default=1,
                        help="Also print the per-chip share under this FSDP axis size")
    parser.add_argument("--zero", type=int, nargs="?", const=0, default=None,
                        help="Per-chip fp32 Adam-moment column under ZeRO "
                             "optimizer-state sharding across this many "
                             "replicas; bare --zero uses the launcher mesh "
                             "dp (ACCELERATE_TPU_MESH_DP) or the card "
                             "count. Leaves with no divisible dimension "
                             "replicate (reported).")
    parser.add_argument("--lora-rank", type=int, default=None,
                        help="Also print the LoRA trainable-parameter count and "
                             "adapter checkpoint size at this rank")
    parser.add_argument("--tp", type=int, default=1,
                        help="Also print per-chip params / KV-cache / adapter-bank "
                             "sizes for a mesh-sliced serving replica of this "
                             "tensor-parallel width")
    parser.add_argument("--page-size", type=int, default=None,
                        help="Also print paged-KV pool sizing at this many "
                             "tokens per page (bytes/page, pages-per-request "
                             "at --seq-lens, per-chip share under --tp)")
    parser.add_argument("--max-pages", type=int, default=None,
                        help="With --page-size: total pool bytes and how many "
                             "concurrent requests the pool fits at --seq-lens")
    parser.add_argument("--seq-lens", type=int, nargs="+",
                        default=[128, 512, 2048, 8192],
                        help="Sequence lengths for the pages-per-request table")
    parser.add_argument("--kv-dtype", default=None, choices=["int8"],
                        help="With --page-size: size the paged pool for "
                             "quantized KV pages (int8 + one f32 scale per "
                             "pool leaf per page) instead of bf16, and show "
                             "the pages-at-equal-HBM gain; matches "
                             "'serve --kv-dtype'")
    parser.add_argument("--weights-dtype", default=None, choices=["int8"],
                        help="Serving weight quantization to note alongside "
                             "the dtype table (the int8 column is the "
                             "per-channel quantized base; LoRA adapters "
                             "stay full precision); matches "
                             "'serve --weights-dtype'")
    parser.add_argument("--spec-tokens", type=int, default=None,
                        help="With --page-size: speculative-decoding "
                             "columns — draft KV pages (2x per request, "
                             "same pool) and the [1, K+1] verify "
                             "activation delta at K proposed tokens/step")
    parser.add_argument("--draft-rank", type=int, default=None,
                        help="With --spec-tokens: draft KV bytes per "
                             "token/page for a small draft model, "
                             "approximated as kv-heads x head-dim "
                             "collapsed to this rank per layer")
    if subparsers is not None:
        parser.set_defaults(func=estimate_command)
    return parser
