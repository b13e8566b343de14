"""Several processes: the port's process groups over gloo on the CPU,
started through its own ``launch``, ``debug_launcher``, and held against
the JAX package.

* the omnibus and the collectives scripts at 2 processes (the JAX
  package's ``tests/test_multiprocess.py`` checks, the same printed lines);
* two launches with ``--num_machines 2 --machine_rank R`` forming one world;
* ``debug_launcher`` at 2;
* ``--max_restarts``: a world whose rank 1 fails once is stopped and
  started again; restarts exhausted give the script's exit code;
* parity: the regression MLP on 2 processes x batch 8 against the JAX
  package's one process x batch 16, parameters within 1e-5 after 8 steps;
  the tiny Llama's fused step (fp32, AdamW, clip 1.0) on 2 processes whose
  packed rows carry different numbers of -100 labels against the JAX
  step on the global batch, losses and grad norms within 1e-5 relative for
  3 steps, the ranks' masters identical;
* the dispatcher, ``IterableDatasetShard``, ``LocalSGD`` (against the
  JAX package's), ``check_trigger``, generator synchronisation and the
  fp16 skip (one process's overflow skips every process's update) across
  2 processes;
* the gradient reduction's buckets, in place and flattened, against the
  sum of both processes' inputs.

Every child runs under its own timeout (at most 120 s), in a session of
its own that is killed whole on a timeout.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
WORKER = Path(__file__).resolve().parent / "torch_mp_worker.py"
TIMEOUT = 120


def run(cmd, timeout=TIMEOUT, env_extra=None):
    """``cmd`` in a session of its own; on a timeout the whole session (the
    launcher and its children) is killed and the test fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(env_extra or {})
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"timed out after {timeout} s:\n{out[-3000:]}\n{err[-3000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def launch(*args, **kwargs):
    return run([sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "launch",
                *args], **kwargs)


def tail(res) -> str:
    return res.stdout[-3000:] + res.stderr[-3000:]


def test_omnibus_two_processes():
    res = launch("--use_cpu_emulation", "--num_processes", "2", "--module",
                 "accelerate_tpu_torch.test_utils.scripts.test_script")
    assert res.returncode == 0, tail(res)
    assert res.stdout.count("All omnibus checks passed.") == 2
    assert "2 process(es)" in res.stdout
    for check in ("state ok", "rng determinism ok", "split_between_processes ok",
                  "dataloader sharding ok", "gather_for_metrics ok (exact epoch reconstruction)",
                  "uneven tail ok", "training parity ok", "gradient accumulation ok"):
        assert res.stdout.count(check) == 2, check


def test_ops_two_processes():
    res = launch("--use_cpu_emulation", "--num_processes", "2", "--module",
                 "accelerate_tpu_torch.test_utils.scripts.test_ops_multiprocess")
    assert res.returncode == 0, tail(res)
    assert "All multi-process ops checks passed" in res.stdout
    for check in ("gather ok", "gather(global array) ok", "gather_object ok", "broadcast ok",
                  "reduce ok", "pad_across_processes ok", "broadcast_object_list ok",
                  "split_between_processes ok", "checkpoint round-trip ok",
                  "debug shape sanitizer ok"):
        assert f"[p0] {check}" in res.stdout and f"[p1] {check}" in res.stdout, check


def test_two_machines_form_one_world():
    """Two ``launch --num_machines 2 --machine_rank R`` runs, as two
    machines start, join one world."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    results = {}

    def machine(rank):
        results[rank] = launch(
            "--num_machines", "2", "--machine_rank", str(rank), "--main_process_ip",
            "127.0.0.1", "--main_process_port", str(port), "--use_cpu_emulation", "--module",
            "accelerate_tpu_torch.test_utils.scripts.test_ops_multiprocess")

    threads = [threading.Thread(target=machine, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for rank, res in results.items():
        assert res.returncode == 0, f"rank {rank}: {tail(res)}"
        assert f"rank {rank} of 2 on cpu over gloo" in res.stdout
    assert "All multi-process ops checks passed" in results[0].stdout


def test_debug_launcher_two_processes():
    code = ("from accelerate_tpu_torch import debug_launcher\n"
            "from accelerate_tpu_torch.test_utils.scripts.test_ops_multiprocess import main\n"
            "debug_launcher(main, num_processes=2)\n")
    res = run([sys.executable, "-c", code])
    assert res.returncode == 0, tail(res)
    assert "All multi-process ops checks passed" in res.stdout
    assert "[p1] checkpoint round-trip ok" in res.stdout


CRASH_ONCE = """
import os, sys
from accelerate_tpu_torch import PartialState
state = PartialState()
if state.process_index == 1 and os.environ["ACCELERATE_TPU_RESTART_COUNT"] == "0":
    sys.exit(3)
state.wait_for_everyone()  # rank 0 waits here for a rank that is gone
print(f"rank {state.process_index} recovered on restart "
      f"{os.environ['ACCELERATE_TPU_RESTART_COUNT']}", flush=True)
"""


def test_max_restarts_recovers(tmp_path):
    """Rank 1 fails on the first attempt: the launcher stops rank 0 (left
    in a barrier) and starts the world again."""
    script = tmp_path / "crash_once.py"
    script.write_text(CRASH_ONCE)
    res = launch("--max_restarts", "2", "--restart_backoff", "0.1", "--use_cpu_emulation",
                 "--num_processes", "2", str(script))
    assert res.returncode == 0, tail(res)
    assert "rank 0 recovered on restart 1" in res.stdout
    assert "rank 1 recovered on restart 1" in res.stdout
    assert "; restart 1/2 in" in res.stderr


def test_restarts_exhausted_propagates_failure(tmp_path):
    script = tmp_path / "always_crash.py"
    script.write_text("import sys; sys.exit(9)\n")
    res = launch("--max_restarts", "1", "--restart_backoff", "0.1", "--use_cpu_emulation",
                 str(script))
    assert res.returncode == 9
    assert "restart 1/1" in res.stderr


def test_mlp_on_two_processes_matches_jax_on_one(tmp_path):
    """2 gloo processes x batch 8 against the JAX package's one process x
    batch 16, same weights and data, 8 SGD steps: parameters within 1e-5."""
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model, NumpyDataLoader as JaxNumpyDataLoader
    from accelerate_tpu.test_utils.training import RegressionData as JaxRegressionData
    from accelerate_tpu.test_utils.training import mlp_apply as jax_mlp_apply
    from accelerate_tpu.test_utils.training import mse_loss as jax_mse_loss
    from accelerate_tpu_torch.test_utils.training import init_mlp

    res = launch("--use_cpu_emulation", "--num_processes", "2", str(WORKER), "mlp",
                 str(tmp_path))
    assert res.returncode == 0, tail(res)

    acc = JaxAccelerator()
    params = {k: jnp.asarray(v) for k, v in init_mlp(0).items()}
    model, opt, loader = acc.prepare(Model(jax_mlp_apply, params), optax.sgd(0.05),
                                     JaxNumpyDataLoader(JaxRegressionData(64), batch_size=16))
    steps = 0
    while steps < 8:
        for batch in loader:
            acc.backward(jax_mse_loss, batch)
            opt.step()
            opt.zero_grad()
            steps += 1
            if steps == 8:
                break
    ranks = [np.load(tmp_path / f"mlp_{r}.npz") for r in range(2)]
    for name, value in model.params.items():
        np.testing.assert_allclose(ranks[0][name], np.asarray(value), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name], err_msg=name)


def test_tiny_llama_with_uneven_label_masks_follows_the_jax_global_batch(tmp_path):
    """Each rank's two packed rows carry a different number of -100 labels
    (12 of 32 kept on rank 0, 30 of 32 on rank 1). The port divides each
    rank's sum by the global label count and sums the gradients, so it
    follows the JAX step on the global batch: losses and grad norms within
    1e-5 relative for 3 steps (fp32, AdamW, clip 1.0); both ranks' masters
    identical. The mean of the ranks' first-step losses misses the global
    loss by far more than the tolerance, so averaging would fail here.
    Before the steps, ``backward`` returns the global loss on both ranks,
    and an evaluation on uneven inputs (``join_uneven_inputs(
    even_batches=False)``: 3 batches on rank 0, 2 on rank 1, the loss
    called alone, gathered once) gives the JAX loss of every row, within
    1e-5 relative."""
    import jax
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import Model
    from accelerate_tpu.data_loader import make_global_batch as jax_make_global_batch
    from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
    from accelerate_tpu.models.llama import fused_causal_lm_loss as jax_fused_causal_lm_loss
    from accelerate_tpu_torch import LlamaConfig, state_dict_from_flax

    rng = np.random.default_rng(0)
    module = JaxPipelined(JaxLlamaConfig.tiny())
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(0)))
    ids = rng.integers(0, 256, (3, 4, 16)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2).astype(np.int32)
    labels[:, :, -1] = -100
    labels[:, 0:2, 6:16] = -100   # rank 0: rows 0-1 keep 6 labels each
    labels[:, 2, 15] = -100       # rank 1: rows 2-3 keep 15 each
    eval_ids = np.concatenate([ids[0], ids[1, :1]])  # 5 rows: 3 batches on rank 0, 2 on rank 1
    eval_labels = np.concatenate([labels[0], labels[1, :1]])
    state = state_dict_from_flax(params, LlamaConfig.tiny())
    np.savez(tmp_path / "llama_in.npz", input_ids=ids, labels=labels, eval_ids=eval_ids,
             eval_labels=eval_labels, **{f"param.{k}": v.numpy() for k, v in state.items()})

    res = launch("--use_cpu_emulation", "--num_processes", "2", str(WORKER), "llama",
                 str(tmp_path))
    assert res.returncode == 0, tail(res)

    acc = JaxAccelerator()
    model, _ = acc.prepare(Model(module, params), optax.adamw(1e-4))
    step = acc.compile_train_step(jax_fused_causal_lm_loss(module), max_grad_norm=1.0)
    reference = []
    for s in range(3):
        m = step(jax_make_global_batch({"input_ids": ids[s], "labels": labels[s]}, acc.mesh))
        reference.append([float(m["loss"]), float(m["grad_norm"])])
    ranks = [np.load(tmp_path / f"llama_{r}.npz") for r in range(2)]
    np.testing.assert_allclose(ranks[0]["history"], np.asarray(reference), rtol=1e-5)
    loss_fn = jax_fused_causal_lm_loss(module)
    # backward() returns the global batch's loss on every rank.
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["backward_loss"], reference[0][0], rtol=1e-5)
    # The uneven evaluation: each rank's own losses, gathered once, are the
    # JAX package's loss of each row.
    rows = [float(loss_fn(params, {"input_ids": eval_ids[i:i + 1], "labels": eval_labels[i:i + 1]}))
            for i in range(5)]
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["evaluated"][:, 0], np.arange(5))
        np.testing.assert_allclose(ranks[r]["evaluated"][:, 1], rows, rtol=1e-5)
    halves = [float(loss_fn(params, {"input_ids": ids[0, r:r + 2], "labels": labels[0, r:r + 2]}))
              for r in (0, 2)]
    assert abs(sum(halves) / 2 - reference[0][0]) > 100 * 1e-5 * reference[0][0], halves
    for name in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name], err_msg=name)
    expected = state_dict_from_flax(jax.device_get(model.params), LlamaConfig.tiny())
    for name, tensor in expected.items():
        np.testing.assert_allclose(ranks[0][f"param.{name}"], tensor.numpy(), atol=5e-5,
                                   rtol=0, err_msg=name)


def test_dispatcher_iterable_shard_local_sgd_trigger_and_fp16_skip_across_processes(tmp_path):
    """The worker's own checks, then ``LocalSGD`` (AdamW, a batch of its
    own on each process, averaged after step 2 and on leaving) against the
    JAX package's: each process's parameters after each of 3 steps and
    its Adam moments before and after leaving equal the JAX replicas' on
    the same batches within 1e-5 of each array's largest entry; every
    average is the processes' mean (not their sum, not one process's
    copy)."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import LocalSGD as JaxLocalSGD
    from accelerate_tpu import MeshConfig, Model
    from accelerate_tpu.test_utils.training import mlp_apply as jax_mlp_apply
    from accelerate_tpu.test_utils.training import mse_loss as jax_mse_loss
    from accelerate_tpu_torch.test_utils.training import RegressionData, init_mlp

    res = launch("--use_cpu_emulation", "--num_processes", "2", str(WORKER), "extras",
                 str(tmp_path))
    assert res.returncode == 0, tail(res)
    assert "extras ok on rank 0" in res.stdout and "extras ok on rank 1" in res.stdout
    ranks = [np.load(tmp_path / f"extras_{r}.npz") for r in range(2)]
    np.testing.assert_array_equal(ranks[0]["fp16_w1"], ranks[1]["fp16_w1"])

    # The JAX package's replicas lie on the mesh's dp axis: 8 of them, the
    # first four on process 0's batch and the last four on process 1's, so
    # replica 0 follows process 0, replica 4 process 1, and the mean of the
    # eight is the mean of the two processes.
    acc = JaxAccelerator(mesh_config=MeshConfig(dp=8))
    params = {k: jnp.asarray(v) for k, v in init_mlp(0).items()}
    # Betas whose powers f32 holds exactly: optax computes Adam's bias
    # correction 1 - b2**t in f32, which at b2 = 0.999 is 1.3e-5 off.
    model, opt = acc.prepare(Model(jax_mlp_apply, params),
                             optax.adamw(0.05, b1=0.5, b2=0.75, weight_decay=1e-4))
    per = [{k: np.stack([row[k] for row in RegressionData(16, seed=10 + r)]) for k in ("x", "y")}
           for r in range(2)]
    batch = {k: np.concatenate([per[0][k]] * 4 + [per[1][k]] * 4) for k in ("x", "y")}
    replicas = ((0, 0), (1, 4))

    def close(actual, expected, what):
        """Within 1e-5 of the array's largest entry (the two packages round
        differently, and an entry near zero has no relative precision)."""
        expected = np.asarray(expected)
        np.testing.assert_allclose(actual, expected, rtol=0,
                                   atol=1e-5 * np.abs(expected).max(), err_msg=what)

    with JaxLocalSGD(acc, model, opt, jax_mse_loss, local_sgd_steps=2) as local:
        for s in range(3):
            local.step(batch)
            stacked = jax.device_get(local._stacked_params)
            for (r, replica), name in ((rr, n) for rr in replicas for n in params):
                close(ranks[r][f"lsgd.step{s}.{name}"], stacked[name][replica],
                      f"rank {r} step {s} {name}")
        adam = jax.device_get(local._stacked_opt[0])
        for (r, replica), name in ((rr, n) for rr in replicas for n in params):
            close(ranks[r][f"lsgd.local.exp_avg.{name}"], adam.mu[name][replica], f"mu {name}")
            close(ranks[r][f"lsgd.local.exp_avg_sq.{name}"], adam.nu[name][replica],
                  f"nu {name}")
    adam, final = jax.device_get(opt.opt_state[0]), jax.device_get(model.params)
    for r in range(2):
        for name in params:
            close(ranks[r][f"lsgd.exit.{name}"], final[name], f"rank {r} exit {name}")
            close(ranks[r][f"lsgd.exit.exp_avg.{name}"], adam.mu[name], f"exit mu {name}")
            close(ranks[r][f"lsgd.exit.exp_avg_sq.{name}"], adam.nu[name], f"exit nu {name}")

    # Apart between averages, equal after each, and the average the mean.
    for s in (0, 2):
        assert not np.allclose(ranks[0][f"lsgd.step{s}.w1"], ranks[1][f"lsgd.step{s}.w1"])
    for key in [f"lsgd.step1.{n}" for n in params] + [f"lsgd.exit.{n}" for n in params]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
    for name in params:
        for before, after in ((f"lsgd.step2.{name}", f"lsgd.exit.{name}"),
                              (f"lsgd.local.exp_avg.{name}", f"lsgd.exit.exp_avg.{name}"),
                              (f"lsgd.local.exp_avg_sq.{name}", f"lsgd.exit.exp_avg_sq.{name}")):
            np.testing.assert_allclose(ranks[0][after], (ranks[0][before] + ranks[1][before]) / 2,
                                       rtol=1e-6, atol=0, err_msg=after)


def test_gradient_buckets_reduced_in_place_or_flattened_sum_across_processes(tmp_path):
    """The gradient reduction on 2 processes, held in each against the sum
    of both processes' seeded inputs times the scale: buckets of one
    tensor (reduced where they lie), of several (flattened and copied
    back), a non-contiguous view, the loss riding or alone; exact in f32,
    within 2e-2 in bf16."""
    res = launch("--use_cpu_emulation", "--num_processes", "2", str(WORKER), "reduce",
                 str(tmp_path))
    assert res.returncode == 0, tail(res)
    assert "reduce ok on rank 0" in res.stdout and "reduce ok on rank 1" in res.stdout
