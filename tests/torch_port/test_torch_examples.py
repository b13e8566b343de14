"""The port's example scripts: the two headline examples
(``examples/nlp_example_torch.py``, ``cv_example_torch.py``), the 19
``examples/by_feature_torch/`` scripts and the 3
``examples/inference_torch/`` ones, each run end to end on the CPU with the
arguments ``tests/test_examples.py`` gives the JAX scripts and held to
what its run shows: it learns (the headline examples to the JAX thresholds,
eval_acc >= 0.8 within 5 epochs and acc >= 0.9 after one), checkpointing
resumes from epoch 1, tracking writes ``train_loss`` as JSONL, early
stopping stops, the folds, the trace directory, and so on. Without
``--cpu`` a script fails where there is no card.

The scripts run in three processes for the whole module, each shared by
every test that reads it (and by the suite's workers, through a file under
the session's temporary root): ``torch_examples_runner.py single`` runs the
single-process scripts one after another; the port's ``launch`` runs
``megatron_lm_gpt_pretraining`` (tp 2 x pp 2), ``moe_context_parallel``
(ep 2, then cp 2) and ``pipeline_inference`` (pp 2 x tp 2) in one gloo
world of 4, and ``distributed_inference`` in a world of 2.

Beside them, the parities that are cheap: ``SyntheticMRPC``, the
DeepSpeed config ``deepspeed_with_config_support`` writes and the rows
``sequence_packing`` packs equal the JAX skeleton's bit for bit, and
``ScheduleFreeAdamW`` follows ``optax.contrib.schedule_free_adamw``.
"""

import fcntl
import importlib.util
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_examples_runner import EXAMPLES, NO_CARD, SINGLE, WORLD
from torch_mesh_common import REPO, launch

RUNNER = REPO / "tests" / "torch_port" / "torch_examples_runner.py"


def shared(tmp_path_factory, name: str, run) -> tuple:
    """``run(out_dir)``'s results, computed once for the whole session:
    the first worker to ask runs it under a lock, the others read its file.
    Returns ``(results by case, out_dir)``."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by the session's workers
    out, done = root / f"examples_{name}", root / f"examples_{name}.json"
    with open(root / f"examples_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            done.write_text(json.dumps(run(out)))
    return json.loads(done.read_text()), out


def parse(text: str) -> dict:
    """The runner's JSON lines by case; a world's by case and rank."""
    results = {}
    for line in text.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            results.setdefault(r["case"], {})[str(r["rank"])] = r
    return results


def run_single(out):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    res = subprocess.run([sys.executable, str(RUNNER), "single", str(out)], capture_output=True,
                         text=True, timeout=400, cwd=str(REPO), env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return parse(res.stdout)


def run_world(n: int, flags: list, cases: list):
    def run(out):
        launch("--num_processes", str(n), *flags, str(RUNNER), "world", str(out), *cases)
        return parse("\n".join((out / f"rank_{r}.jsonl").read_text() for r in range(n)))

    return run


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    return shared(tmp_path_factory, "single", run_single)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return shared(tmp_path_factory, "world4", run_world(
        4, ["--pp", "2", "--tp", "2"],
        ["megatron_lm_gpt_pretraining", "moe_context_parallel", "pipeline_inference"]))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return shared(tmp_path_factory, "world2", run_world(2, [], ["distributed_inference"]))


def ran(results: dict, case: str) -> str:
    """The case's standard output on rank 0, after checking that it ran
    without error on every rank."""
    ranks = results[case]
    for rank, r in ranks.items():
        assert r["error"] is None, f"{case} failed on rank {rank}:\n{r['error'][-3000:]}"
    return ranks["0"]["stdout"]


def losses_of(text: str, pattern=r"loss (\d+\.\d+)") -> list:
    values = [float(x) for x in re.findall(pattern, text)]
    assert values and all(math.isfinite(v) for v in values), text[-2000:]
    return values


def check_trained(text, out):
    losses_of(text)
    assert re.search(r"epoch 0: loss \d+\.\d+ (eval-avg )?acc \d\.\d+", text), text


def check_checkpointing(text, out):
    assert "epoch 1: loss" in text and "(state saved)" in text, text
    assert (out / "ckpt" / "checkpoints").is_dir()


def check_checkpointing_resumed(text, out):
    assert "resumed from epoch 1" in text and "epoch 2: loss" in text, text
    # automatic naming: one save a run, the resumed run's numbered on
    kept = sorted(p.name for p in (out / "ckpt" / "checkpoints").iterdir())
    assert kept == ["checkpoint_0", "checkpoint_1"], kept


def check_early_stopping(text, out):
    assert "early stop at epoch 1 (no improvement)" in text, text
    assert "epoch 2" not in text


def check_multi_process_metrics(text, out):
    assert "over exactly 100 samples" in text, text


def check_profiler(text, out):
    assert f"profiled 6 steps, trace in {out / 'trace'}" in text, text
    traces = list((out / "trace").glob("*.json"))
    assert traces and '"traceEvents"' in traces[0].read_text()[:4096]


def check_tracking(text, out):
    check_trained(text, out)
    metrics = list((out / "track").rglob("*.jsonl"))
    assert metrics, f"no jsonl metrics under {out / 'track'}"
    lines = [json.loads(line) for line in metrics[0].read_text().splitlines()]
    assert lines[0] == {"_type": "config", "config": {"lr": 3e-4, "batch_size": 16}}
    assert "train_loss" in lines[1] and lines[1]["step"] == 1
    assert "eval_accuracy" in lines[-1]


def check_fsdp(text, out):
    check_trained(text, out)
    assert "(offload=on)" in text, text


def check_cross_validation(text, out):
    assert "fold 0 done" in text and "fold 1 done" in text, text
    assert re.search(r"ensemble accuracy over 2 folds: \d\.\d+", text), text


def check_ddp_comm_hook(text, out):
    drift = float(re.search(r"max per-step loss drift: (\d+\.\d+)", text).group(1))
    assert drift < 0.1 and "bf16 reductions:" in text, text


def check_deepspeed(text, out):
    check_trained(text, out)
    assert "translated ZeRO config: sharding=SHARD_GRAD_OP offload=True" in text, text
    assert "lr 1.00e-03" in text  # the WarmupLR of the config, past its 5 warmup steps


def check_native(text, out):
    assert "resume state: {'epoch': 0, 'skip_batches': 2}" in text, text
    assert "native ring: 16 batches" in text, text
    first, last = (float(x) for x in re.search(
        r"trained 16 steps from the token binary: loss (\d+\.\d+) -> (\d+\.\d+)", text).groups())
    assert last < first, text


def check_hf(text, out):
    losses_of(text)
    from safetensors import safe_open

    assert f"exported fine-tuned weights (HF names) to {out / 'hf'}" in text, text
    with safe_open(str(out / "hf" / "model.safetensors"), "np") as f:
        assert "model.layers.0.self_attn.q_proj.weight" in f.keys()
    assert json.loads((out / "hf" / "config.json").read_text())["model_type"] == "llama"


def check_packing(text, out):
    assert re.search(r"packed 256 docs \(\d+ tokens\) into \d+ rows of 32", text), text
    losses_of(text)


def check_speculative(text, out):
    assert "streamed model: both drafters == greedy output" in text, text
    assert "speculative decoding example: OK" in text


CHECKS = {
    "gradient_accumulation": check_trained,
    "automatic_gradient_accumulation": check_trained,
    "checkpointing": check_checkpointing,
    "checkpointing_resumed": check_checkpointing_resumed,
    "early_stopping": check_early_stopping,
    "local_sgd": check_trained,
    "memory": check_trained,
    "multi_process_metrics": check_multi_process_metrics,
    "profiler": check_profiler,
    "tracking": check_tracking,
    "fsdp_with_peak_mem_tracking": check_fsdp,
    "cross_validation": check_cross_validation,
    "ddp_comm_hook": check_ddp_comm_hook,
    "schedule_free": check_trained,
    "deepspeed_with_config_support": check_deepspeed,
    "native_data_pipeline": check_native,
    "hf_checkpoint_finetune": check_hf,
    "sequence_packing": check_packing,
    "speculative_decoding": check_speculative,
}


@pytest.mark.parametrize("case", list(CHECKS))
def test_example_runs_and_shows_its_feature(single, case):
    results, out = single
    CHECKS[case](ran(results, case), out)


def test_nlp_example_learns_on_the_cpu(single):
    text = ran(single[0], "nlp_example")
    accs = [float(a) for a in re.findall(r"eval_acc (\d\.\d+) \(100 samples\)", text)]
    assert len(accs) == 5, text[-2000:]
    assert max(accs) >= 0.8, f"eval accuracy never reached 0.8: {accs}"


def test_cv_example_learns_on_the_cpu(single):
    text = ran(single[0], "cv_example")
    accs = [float(a) for a in re.findall(r"acc (\d\.\d+)", text)]
    assert accs and max(accs) >= 0.9, text[-1500:]


@pytest.mark.parametrize("script", list(NO_CARD))
def test_examples_need_the_card_unless_asked_for_the_cpu(single, script):
    result = single[0][script]["0"]
    assert result["error"] is not None
    assert "no CUDA device is available" in result["error"], result["error"][-1500:]


def test_megatron_lm_gpt_pretraining_on_tp2_x_pp2(world4):
    text = ran(world4[0], "megatron_lm_gpt_pretraining")
    assert "mesh {'pp': 2, 'dp': 1, 'fsdp': 1, 'ep': 1, 'cp': 1, 'tp': 2}" in text, text
    first, last = (float(x) for x in re.search(r"loss (\d+\.\d+) -> (\d+\.\d+) over 4 steps",
                                               text).groups())
    assert last < first, text


def test_moe_context_parallel_on_ep2_then_cp2(world4):
    text = ran(world4[0], "moe_context_parallel")
    assert "MoE over {'pp': 1, 'dp': 2, 'fsdp': 1, 'ep': 2, 'cp': 1, 'tp': 1}" in text, text
    losses_of(text)
    # each process holds its 1024 of the 2048 tokens of its one row
    assert "ring attention over cp=2: seq 2048 -> logits (1, 1024, 256)" in text, text


def test_pipeline_inference_over_pp2_x_tp2(world4):
    text = ran(world4[0], "pipeline_inference")
    assert "'pp': 2" in text and "'tp': 2" in text, text
    assert "first call: logits (5, 32, 256)" in text
    assert "pipeline inference example: OK" in text


def test_distributed_inference_on_two_processes(world2):
    text = ran(world2[0], "distributed_inference")
    assert len(world2[0]["distributed_inference"]) == 2
    assert text.count(" -> ") == 5 and "distributed inference example: OK" in text, text


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def skeletons():
    sys.path.insert(0, str(EXAMPLES))
    try:
        return (_load(EXAMPLES / "example_lib.py", "_jax_example_lib"),
                _load(EXAMPLES / "example_lib_torch.py", "_torch_example_lib"))
    finally:
        sys.path.remove(str(EXAMPLES))


@pytest.mark.parametrize("n,seed", [(256, 0), (64, 1), (100, 9)])
def test_synthetic_mrpc_equals_the_jax_skeletons(skeletons, n, seed):
    ref, ours = (lib.SyntheticMRPC(n, seed=seed) for lib in skeletons)
    for i in (0, 1, n // 2, n - 1):
        for key, value in ref[i].items():
            np.testing.assert_array_equal(ours[i][key], value, err_msg=key)
            assert np.asarray(ours[i][key]).dtype == np.asarray(value).dtype


def test_deepspeed_config_written_equals_the_jax_scripts():
    sys.path.insert(0, str(EXAMPLES))
    try:
        ref = _load(EXAMPLES / "by_feature" / "deepspeed_with_config_support.py", "_jax_ds")
        ours = _load(EXAMPLES / "by_feature_torch" / "deepspeed_with_config_support.py",
                     "_torch_ds")
    finally:
        sys.path.remove(str(EXAMPLES))
    assert json.dumps(ours.DEFAULT_DS_CONFIG) == json.dumps(ref.DEFAULT_DS_CONFIG)


def test_sequence_packing_rows_equal_the_jax_packer():
    """The corpus ``sequence_packing.py`` draws at its defaults (seed 42,
    --seq_len 32 as tested), packed by both packages."""
    from accelerate_tpu.data_loader import pack_sequences as jax_pack

    from accelerate_tpu_torch import pack_sequences

    for seq_len in (32, 64):
        rng = np.random.default_rng(42)
        docs = [rng.integers(0, 256, size=int(n)).astype(np.int32)
                for n in rng.integers(4, seq_len, size=256)]
        ref, ours = jax_pack(docs, seq_len=seq_len), pack_sequences(docs, seq_len=seq_len)
        assert set(ours) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(ref[key]),
                                          err_msg=key)


def test_schedule_free_adamw_follows_optax(skeletons):
    """20 updates on the same f32 gradients, with warmup, weight decay and
    a learning rate that moves the parameters: the training point and the
    evaluation point (``schedule_free_eval_params``) within 1e-6 of optax's
    after every update, and the training point back after the swap."""
    import jax.numpy as jnp
    import optax

    lib = skeletons[1]
    rng = np.random.default_rng(0)
    start = {"w": rng.normal(size=(4, 3)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in start.items()}
             for _ in range(20)]
    tx = optax.contrib.schedule_free_adamw(learning_rate=3e-2, warmup_steps=8,
                                           weight_decay=1e-2)
    params = {k: jnp.asarray(v) for k, v in start.items()}
    state = tx.init(params)
    ours = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in start.items()}
    opt = lib.ScheduleFreeAdamW(ours.values(), lr=3e-2, warmup_steps=8, weight_decay=1e-2)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in ours.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        evaluated = optax.contrib.schedule_free_eval_params(state, params)
        before = {k: p.detach().clone() for k, p in ours.items()}
        with lib.schedule_free_eval_params(opt):
            for k in start:
                np.testing.assert_allclose(ours[k].detach().numpy(), evaluated[k], rtol=0,
                                           atol=1e-6)
        for k in start:
            np.testing.assert_allclose(ours[k].detach().numpy(), params[k], rtol=0, atol=1e-6)
            assert torch.equal(ours[k].detach(), before[k])


def test_every_port_script_is_run_here():
    scripts = {s for s, _ in (*SINGLE.values(), *WORLD.values())}
    on_disk = {str(p.relative_to(EXAMPLES)) for d in ("by_feature_torch", "inference_torch")
               for p in (EXAMPLES / d).glob("*.py")}
    assert on_disk == scripts - {"nlp_example_torch.py", "cv_example_torch.py"}
    assert len(on_disk) == 22
