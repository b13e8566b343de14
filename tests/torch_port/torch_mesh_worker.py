"""The body of the port's mesh tests, run in each process of a gloo world by
``accelerate-tpu-torch launch --use_cpu_emulation`` with mesh flags:

    python -m accelerate_tpu_torch.commands.accelerate_cli launch \
        --use_cpu_emulation --num_processes N --tp 2 ... torch_mesh_worker.py MODE OUT_DIR [ARG]

MODE is ``llama`` (the tiny stacked Llama of ``OUT_DIR/llama_in.npz`` for
6 fused AdamW steps under the plugins of the JSON ``ARG``; each rank's
losses, grad norms, parameter and Adam-moment chunks), ``resume`` (the
run of ``llama`` stopped after 3 steps, saved, and resumed under this
world through ``load_state(via_host=True)``), ``attn`` (ring and Ulysses
attention cases of ``OUT_DIR/attn_in.npz`` on this process's chunks:
outputs and the three gradients) or ``pipeline`` (``pipeline_apply``
cases of ``OUT_DIR/pipe_in.npz``, and ``PipelinedInferencer`` over the
tiny stacked Llama) or ``t5`` (the tiny T5 of ``OUT_DIR/t5_in.npz`` trained
under the tensor-parallel plugin). Results go to ``OUT_DIR/<mode>_<rank>.npz``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from accelerate_tpu_torch import (
    Accelerator,
    ContextParallelPlugin,
    FullyShardedDataParallelPlugin,
    PartialState,
    PipelineParallelPlugin,
    TensorParallelPlugin,
)


def rows_of(acc, array):
    """This process's data shard of a global batch's rows."""
    mesh = acc.mesh
    n, i = mesh.data_shards(), mesh.data_index()
    k = array.shape[0] // n
    return array[i * k:(i + 1) * k]


def llama_accelerator(cfg: dict) -> Accelerator:
    plugins = {}
    if cfg.get("fsdp"):
        plugins["fsdp_plugin"] = FullyShardedDataParallelPlugin(
            sharding_strategy=cfg["fsdp"], zero_sharding=cfg.get("zero", False),
            activation_checkpointing=cfg.get("remat", False), min_weight_size_to_shard=1024)
    if cfg.get("tp", 1) > 1:
        plugins["tp_plugin"] = TensorParallelPlugin(tp_size=cfg["tp"])
    if cfg.get("pp", 1) > 1:
        plugins["pp_plugin"] = PipelineParallelPlugin(pp_size=cfg["pp"],
                                                      num_microbatches=cfg.get("M", 1))
    if cfg.get("cp", 1) > 1:
        plugins["cp_plugin"] = ContextParallelPlugin(cp_size=cfg["cp"],
                                                     ring_inner_chunk=cfg.get("inner", 1024))
    return Accelerator(cpu=True, **plugins)


def llama_setup(out: Path, cfg: dict):
    from accelerate_tpu_torch import LlamaConfig, PipelinedLlamaForCausalLM, fused_causal_lm_loss

    acc = llama_accelerator(cfg)
    inputs = np.load(out / "llama_in.npz")
    config = LlamaConfig.tiny(attention_backend=cfg.get("backend", "auto"),
                              remat=cfg.get("model_remat", False))
    model = PipelinedLlamaForCausalLM(config, device="cpu")
    model.load_state_dict({k[len("param."):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith("param.")})
    model, opt = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                      weight_decay=1e-4))
    step = acc.compile_train_step(fused_causal_lm_loss(model), max_grad_norm=cfg.get("clip", 1.0))

    def batch(s):
        return {"input_ids": torch.from_numpy(rows_of(acc, inputs["input_ids"][s])).long(),
                "labels": torch.from_numpy(rows_of(acc, inputs["labels"][s])).long()}

    return acc, model, opt, step, batch, inputs["input_ids"].shape[0]


def chunks(model, opt) -> dict:
    """Each parameter's and Adam moment's chunk, and the splits (``{axis:
    dim}``) of both, by the parameter's name."""
    result = {f"param.{n}": p.detach().numpy() for n, p in model.module.named_parameters()}
    names = {id(p): n for n, p in model.module.named_parameters()}
    names.update({id(view): names[id(p)] for p, view, *_ in opt._views})
    layout = model.layout
    splits = {"param": {n: layout.splits[n] if layout is not None else {} for n in
                        (names[id(p)] for p in model.module.parameters())}, "moment": {}}
    for p, (split, _) in zip(opt._params(), opt.param_splits()):
        state = opt.optimizer.state.get(p, {})
        if "exp_avg" in state:
            result[f"mu.{names[id(p)]}"] = state["exp_avg"].numpy()
            result[f"nu.{names[id(p)]}"] = state["exp_avg_sq"].numpy()
            splits["moment"][names[id(p)]] = split
    result["splits"] = np.asarray(json.dumps(splits))
    return result


def run_llama(out: Path, arg: str):
    cfg = json.loads(arg)
    acc, model, opt, step, batch, steps = llama_setup(out, cfg)
    history = []
    for s in range(steps):
        m = step(batch(s))
        history.append([m["loss"].item(), m["grad_norm"].item()])
        if cfg.get("save_at") == s + 1:
            acc.save_state(str(out / cfg["save"]))
            result = {f"whole.{k}": v.numpy().copy()
                      for k, v in acc.get_state_dict(model).items()}
    result = {**(result if cfg.get("save_at") else {}), **chunks(model, opt)}
    result["history"] = np.asarray(history)
    result["specs"] = np.asarray(json.dumps({n: str(s) for n, s in model.layout.specs.items()})
                                 if model.layout is not None else "{}")
    result["coords"] = np.asarray(json.dumps(acc.mesh.coords))
    result["distributed_type"] = np.asarray(str(acc.distributed_type))
    return result


def run_resume(out: Path, arg: str):
    cfg = json.loads(arg)
    acc, model, opt, step, batch, steps = llama_setup(out, cfg)
    acc.load_state(str(out / cfg["load"]), via_host=True)
    history = [[m["loss"].item(), m["grad_norm"].item()]
               for m in (step(batch(s)) for s in range(cfg["from"], steps))]
    return {"history": np.asarray(history)}


def run_attn(out: Path, arg: str):
    from accelerate_tpu_torch.models.llama import multi_head_attention
    from accelerate_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention
    from accelerate_tpu_torch.state import AcceleratorState

    state = AcceleratorState(cpu=True)
    mesh = state.mesh
    cases = json.loads(arg)
    inputs = np.load(out / "attn_in.npz")
    result = {}
    dp, cp, tp = (mesh.group(ax) for ax in ("dp", "cp", "tp"))
    for name, case in cases.items():
        local = []
        for key in ("q", "k", "v", "do"):
            x = inputs[f"{name}.{key}"]
            b, s, h = x.shape[0] // dp.size, x.shape[1] // cp.size, x.shape[2] // tp.size
            local.append(torch.from_numpy(np.ascontiguousarray(
                x[dp.index * b:(dp.index + 1) * b, cp.index * s:(cp.index + 1) * s,
                  tp.index * h:(tp.index + 1) * h])).requires_grad_(key != "do"))
        q, k, v, do = local
        if case["fn"] == "window":
            # A window narrower than the sequence needs it whole: "auto"
            # gathers the chunks, attends, and keeps this process's.
            o = multi_head_attention(q, k, v, causal=case["causal"],
                                     sliding_window=case["window"])
        else:
            fn = ring_attention if case["fn"] == "ring" else ulysses_attention
            kwargs = {"inner_chunk": case["inner"]} if case.get("inner") else {}
            o = fn(q, k, v, causal=case["causal"], **kwargs)
        (o * do).sum().backward()
        for key, t in (("o", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            result[f"{name}.{key}"] = t.detach().numpy()
    return result


def run_pipeline(out: Path, arg: str):
    from accelerate_tpu_torch import LlamaConfig, PipelinedLlamaForCausalLM, prepare_pipeline
    from accelerate_tpu_torch.parallel.pipeline import pipeline_apply
    from accelerate_tpu_torch.state import AcceleratorState

    cases = json.loads(arg)
    state = AcceleratorState(cpu=True, pp_plugin=PipelineParallelPlugin(pp_size=2))
    pp = state.mesh.group("pp")
    inputs = np.load(out / "pipe_in.npz") if cases else None
    result = {}

    def block_fn(p, h, extras):
        h = torch.tanh(h @ p["w"] + p["b"])
        return h if extras is None else h + extras

    for name, case in cases.items():
        L = inputs["w"].shape[0] // pp.size
        params = {key: torch.from_numpy(inputs[key][pp.index * L:(pp.index + 1) * L].copy())
                  .requires_grad_() for key in ("w", "b")}
        x = torch.from_numpy(inputs["x"].copy()).requires_grad_()
        extras = torch.from_numpy(inputs["extras"]) if case.get("extras") else None
        y = pipeline_apply(block_fn, params, x, extras, num_microbatches=case["M"],
                           remat=case.get("remat", False))
        (y * torch.from_numpy(inputs["dy"])).sum().backward()
        result.update({f"{name}.y": y.detach().numpy(), f"{name}.dx": x.grad.numpy(),
                       f"{name}.dw": params["w"].grad.numpy(),
                       f"{name}.db": params["b"].grad.numpy()})
    if cases:
        try:
            pipeline_apply(block_fn, params, torch.zeros(4, 8), num_microbatches=3)
        except ValueError as exc:
            result["error.batch"] = np.asarray(str(exc))

    # Pipelined inference over the tiny stacked Llama, split over pp.
    acc = Accelerator(cpu=True)
    llama = np.load(out / "llama_in.npz")
    model = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu", num_microbatches=2)
    model.load_state_dict({k[len("param."):]: torch.from_numpy(llama[k])
                           for k in llama.files if k.startswith("param.")})
    model = acc.prepare(model)
    infer = prepare_pipeline(model, accelerator=acc)
    ids = torch.from_numpy(llama["input_ids"][0, :3]).long()  # 3 rows: padded to 4
    result["infer.logits"] = infer(ids).numpy()
    result["infer.microbatches"] = np.asarray(infer.num_microbatches)
    return result


def run_t5(out: Path, arg: str):
    """The tiny T5 of ``OUT_DIR/t5_in.npz`` for its steps of fused AdamW on
    ``seq2seq_lm_loss`` under the tensor-parallel plugin: losses, grad
    norms and the layout's specs."""
    from accelerate_tpu_torch import T5Config, T5ForConditionalGeneration, seq2seq_lm_loss

    cfg = json.loads(arg)
    acc = Accelerator(cpu=True, tp_plugin=TensorParallelPlugin(tp_size=cfg["tp"]))
    inputs = np.load(out / "t5_in.npz")
    model = T5ForConditionalGeneration(T5Config.tiny(dropout_rate=0.0), device="cpu")
    model.load_state_dict({k[len("param."):]: torch.from_numpy(inputs[k])
                           for k in inputs.files if k.startswith("param.")})
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=cfg["lr"],
                                                    weight_decay=1e-4))
    step = acc.compile_train_step(seq2seq_lm_loss(model), max_grad_norm=1.0)
    history = []
    for s in range(inputs["input_ids"].shape[0]):
        m = step({k: torch.from_numpy(rows_of(acc, inputs[k][s])).long()
                  for k in ("input_ids", "labels")})
        history.append([m["loss"].item(), m["grad_norm"].item()])
    return {"history": np.asarray(history),
            "specs": np.asarray(json.dumps({n: str(s) for n, s in model.layout.specs.items()})),
            "distributed_type": np.asarray(str(acc.distributed_type))}


def main():
    mode, out = sys.argv[1], Path(sys.argv[2])
    arg = sys.argv[3] if len(sys.argv) > 3 else "{}"
    state = PartialState()
    result = {"llama": run_llama, "resume": run_resume, "attn": run_attn,
              "pipeline": run_pipeline, "t5": run_t5}[mode](out, arg)
    result["world"] = np.asarray(state.num_processes)
    np.savez(out / f"{mode}_{state.process_index}.npz", **result)
    print(f"{mode} ok on rank {state.process_index}", flush=True)


if __name__ == "__main__":
    main()
