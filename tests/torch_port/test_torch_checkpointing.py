"""Checkpoints: ``save_state``/``load_state`` and the model files.

* A round trip restores every prepared object, and a run resumed from a
  checkpoint continues bit-identically (losses, grad norms, learning rates
  and parameters ``torch.equal``) to the run that was never interrupted:
  packed sequences through a shuffled, prefetched loader, accumulation 2,
  AdamW and a scheduler.
* Automatic naming with ``total_limit`` rotation, custom objects, RNG
  states, and the background (``blocking=False``) write.
* The safetensors files the port writes read back with the ``safetensors``
  package, the package's files read back with the port, and a
  ``model.safetensors`` written by the JAX package's ``save_model`` loads
  into the port's Llama and gives the JAX logits (fp32; 1e-5, the
  tolerance of ``test_torch_llama.py``).
"""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM
from accelerate_tpu_torch import (
    Accelerator,
    LlamaConfig,
    LlamaForCausalLM,
    LRScheduler,
    NumpyDataLoader,
    PipelinedLlamaForCausalLM,
    ProjectConfiguration,
    fused_causal_lm_loss,
    load_safetensors_model,
    pack_sequences,
    state_dict_from_flax,
)
from accelerate_tpu_torch import checkpointing
from accelerate_tpu_torch.state import AcceleratorState, GradientState


def reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def packed_rows(seed=0):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, size=int(rng.integers(4, 40))) for _ in range(60)]
    packed = pack_sequences(docs, seq_len=32)
    return [{k: v[i] for k, v in packed.items()} for i in range(len(packed["input_ids"]))]


def schedule(count):
    return 1e-3 * min(1.0, (count + 1) / 3)


def build(**acc_kwargs):
    """A fresh tiny Llama run: accelerator, prepared model, optimizer,
    shuffled loader and scheduler."""
    reset_port_state()
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2, **acc_kwargs)
    module = PipelinedLlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    model, opt, loader, sched = acc.prepare(
        module, torch.optim.AdamW(module.parameters(), lr=schedule(0), weight_decay=1e-4),
        NumpyDataLoader(packed_rows(), batch_size=2, shuffle=True, seed=4), LRScheduler(schedule))
    return acc, model, opt, loader, sched


def train(acc, model, opt, loader, sched, updates, save=None):
    """``updates`` optimizer steps through ``loader``; per update the mean
    loss, the grad norm and the learning rate after it. ``save(acc)`` runs
    inside the loop after the last update, where a training script saves."""
    loss_fn, out, losses = fused_causal_lm_loss(model), [], []
    for batch in loader:
        with acc.accumulate(model):
            losses.append(acc.backward(loss_fn, batch))
            if acc.sync_gradients:
                gnorm = acc.clip_grad_norm_(max_norm=1.0)
            opt.step()
            sched.step()
            opt.zero_grad()
        if acc.sync_gradients:
            out.append((sum(losses) / len(losses), gnorm, opt.param_groups[0]["lr"]))
            losses = []
            if len(out) == updates:
                if save is not None:
                    save(acc)
                break
    return out


def params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("blocking", [True, False], ids=["blocking", "background"])
def test_resume_is_bit_identical(tmp_path, blocking):
    run = build()
    straight = train(*run, updates=6)
    final = params_of(run[1])

    run = build()
    first = train(*run, updates=3,
                  save=lambda acc: acc.save_state(str(tmp_path / "ckpt"), blocking=blocking))
    run[0].wait_for_checkpoint()
    run[0].free_memory()

    acc, model, opt, loader, sched = build()
    acc.load_state(str(tmp_path / "ckpt"))
    assert (loader.iteration, loader.skip_batches) == (0, 6)  # epoch 0, 6 microbatches in
    loader = acc.skip_first_batches(loader, 6)
    resumed = first + train(acc, model, opt, loader, sched, updates=3)
    assert len(resumed) == len(straight) == 6
    for (loss, gnorm, lr), (ref_loss, ref_gnorm, ref_lr) in zip(resumed, straight):
        assert torch.equal(loss, ref_loss) and torch.equal(gnorm, ref_gnorm) and lr == ref_lr
    for name, tensor in params_of(model).items():
        assert torch.equal(tensor, final[name]), name
    assert opt.steps_applied == 6 and sched.scheduler.count == 6


def test_round_trip_restores_every_object(tmp_path):
    acc, model, opt, loader, sched = build()
    saved = []

    def save(acc):
        assert acc.save_state(str(tmp_path)) == str(tmp_path)
        saved.extend([params_of(model), opt.optimizer.state_dict(), sched.state_dict(),
                      loader.state_dict()])

    train(acc, model, opt, loader, sched, updates=2, save=save)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["model.safetensors", "optimizer.safetensors", "optimizer_meta_0.json",
                     "random_states_0.json", "sampler_0.json", "scheduler.json", "world.json"]
    assert saved[3] == {"epoch": 0, "batches_consumed": 4}

    acc2, model2, opt2, loader2, sched2 = build()
    acc2.load_state(str(tmp_path))
    for name, tensor in params_of(model2).items():
        assert torch.equal(tensor, saved[0][name]), name
    state = opt2.optimizer.state_dict()
    assert state["param_groups"] == json.loads(json.dumps(saved[1]["param_groups"]))
    for pid, entries in saved[1]["state"].items():
        for key, value in entries.items():
            assert torch.equal(state["state"][pid][key], value), (pid, key)
    # The loaded moments are the optimizer's own, not the file's or another's.
    ptrs = {v.data_ptr() for e in opt.optimizer.state.values() for v in e.values()}
    assert not ptrs & {v.data_ptr() for e in opt2.optimizer.state.values() for v in e.values()}
    assert sched2.state_dict() == saved[2]
    assert (loader2.iteration, loader2.skip_batches) == (0, 4)
    assert opt2.steps_applied == opt.steps_applied == 2


def test_fp16_loss_scale_round_trips(tmp_path):
    reset_port_state()
    acc = Accelerator(cpu=True, mixed_precision="fp16")
    module = torch.nn.Linear(3, 1)
    model, opt = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.1))
    opt.loss_scale = opt.loss_scale._replace(scale=torch.tensor(512.0),
                                             growth_tracker=torch.tensor(7, dtype=torch.int32))
    acc.save_state(str(tmp_path))
    reset_port_state()
    acc2 = Accelerator(cpu=True, mixed_precision="fp16")
    _, opt2 = acc2.prepare(torch.nn.Linear(3, 1), torch.optim.SGD(module.parameters(), lr=0.1))
    acc2.load_state(str(tmp_path))
    assert opt2.loss_scale.scale.item() == 512.0 and opt2.loss_scale.growth_tracker.item() == 7


def test_automatic_naming_rotates_past_total_limit(tmp_path):
    config = ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True,
                                  total_limit=2)
    acc, model, opt, loader, sched = build(project_config=config)
    for _ in range(4):
        acc.save_state()
    base = tmp_path / "checkpoints"
    assert sorted(p.name for p in base.iterdir()) == ["checkpoint_2", "checkpoint_3"]
    with torch.no_grad():
        next(model.parameters()).add_(1.0)
    assert acc.load_state().endswith("checkpoint_3")
    assert config.iteration == 4
    acc.save_state()
    assert sorted(p.name for p in base.iterdir()) == ["checkpoint_3", "checkpoint_4"]
    plain, *_ = build()
    with pytest.raises(ValueError, match="project_dir"):
        plain.save_state()


class Counter:
    def __init__(self, n=0, payload=None):
        self.n, self.payload = n, payload

    def state_dict(self):
        return {"n": self.n} if self.payload is None else {"n": self.n, "p": self.payload}

    def load_state_dict(self, sd):
        self.n, self.payload = sd["n"], sd.get("p")


def test_custom_objects_and_rng_states(tmp_path):
    acc, *_ = build()
    json_obj, pickled = Counter(3), Counter(5, payload={1, 2})  # a set is no JSON
    acc.register_for_checkpointing(json_obj, pickled)
    with pytest.raises(ValueError, match="state_dict"):
        acc.register_for_checkpointing(object())
    random.seed(1)
    np.random.seed(2)
    torch.manual_seed(3)
    acc.generator.manual_seed(4)
    acc.save_state(str(tmp_path))
    assert (tmp_path / "custom_checkpoint_0.json").exists()
    assert (tmp_path / "custom_checkpoint_1.pkl").exists()

    def draw():
        return (random.random(), float(np.random.rand()), torch.rand(2).tolist(),
                torch.rand(2, generator=acc.generator).tolist())

    expected = draw()
    json_obj.n, pickled.n, pickled.payload = 0, 0, None
    acc.load_state(str(tmp_path))
    assert draw() == expected
    assert (json_obj.n, pickled.n, pickled.payload) == (3, 5, {1, 2})


def test_background_save_snapshots_and_reports_its_error(tmp_path, monkeypatch):
    acc, model, opt, loader, sched = build()
    before = params_of(model)
    acc.save_state(str(tmp_path / "a"), blocking=False)
    with torch.no_grad():  # the next update changes nothing already saved
        for p in model.parameters():
            p.add_(1.0)
    acc.wait_for_checkpoint()
    saved = checkpointing.load_safetensors(tmp_path / "a" / "model.safetensors")
    for name, tensor in before.items():
        assert torch.equal(saved[name], tensor), name

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(checkpointing, "save_safetensors", broken)
    acc.save_state(str(tmp_path / "b"), blocking=False)
    with pytest.raises(RuntimeError, match="checkpoint write") as info:
        acc.wait_for_checkpoint()
    assert isinstance(info.value.__cause__, OSError)
    acc.wait_for_checkpoint()  # drained: nothing left to raise


def test_safetensors_files_cross_with_the_package(tmp_path):
    tensors = {"f32": torch.randn(3, 4), "bf16": torch.randn(5).to(torch.bfloat16),
               "f16": torch.randn(2, 2).half(), "i64": torch.arange(6).reshape(2, 3),
               "i32": torch.arange(4, dtype=torch.int32), "u8": torch.arange(3, dtype=torch.uint8),
               "b": torch.tensor([True, False]), "scalar": torch.tensor(2.5),
               "empty": torch.zeros(0, 3)}
    checkpointing.save_safetensors(tensors, tmp_path / "ours.safetensors", {"format": "pt"})
    theirs = torch_load_file(str(tmp_path / "ours.safetensors"))
    torch_save_file(tensors, str(tmp_path / "theirs.safetensors"))
    ours = checkpointing.load_safetensors(tmp_path / "theirs.safetensors")
    for name, t in tensors.items():
        for got in (theirs[name], ours[name]):
            assert got.dtype == t.dtype and torch.equal(got, t), name
    numpy_view = np_load_file(str(tmp_path / "ours.safetensors"))
    np.testing.assert_array_equal(numpy_view["f32"], tensors["f32"].numpy())


@pytest.mark.parametrize("max_shard_size", ["10GB", "20KB"], ids=["one-file", "sharded"])
def test_save_model_reads_back(tmp_path, max_shard_size):
    acc, model, *_ = build()
    acc.save_model(model, str(tmp_path), max_shard_size=max_shard_size)
    files = sorted(p.name for p in tmp_path.iterdir())
    state = model.state_dict()
    if max_shard_size == "10GB":
        assert files == ["model.safetensors"]
        flat = np_load_file(str(tmp_path / "model.safetensors"))
    else:
        assert "model.safetensors.index.json" in files and len(files) > 2
        index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
        assert set(index["weight_map"]) == set(state)
        flat = {}
        for name in set(index["weight_map"].values()):
            flat.update(np_load_file(str(tmp_path / name)))
    assert set(flat) == set(state)
    for name, tensor in state.items():
        np.testing.assert_array_equal(flat[name], tensor.numpy())
    nested = load_safetensors_model(str(tmp_path))
    assert torch.equal(nested["model"]["norm"]["scale"], state["model.norm.scale"])


def test_jax_model_file_loads_into_the_port(tmp_path):
    cfg = JaxLlamaConfig.tiny()
    module = JaxLlamaForCausalLM(cfg)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(0)))
    JaxAccelerator().save_model(Model(module, params), str(tmp_path))
    ids = rng.integers(0, 256, (2, 12)).astype(np.int32)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(ids)))

    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    port.load_state_dict(state_dict_from_flax(load_safetensors_model(str(tmp_path)),
                                              LlamaConfig.tiny()))
    with torch.no_grad():
        logits = port(torch.from_numpy(ids).long())
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-5, rtol=1e-5)
