"""State singletons, seeding, operations, tracking, logging and memory
helpers of the port, against the JAX package's where both have them.

* ``PartialState``/``AcceleratorState``/``GradientState`` share state as
  the JAX package's do, refuse a second precision and several processes;
  with no precision given, both packages read
  ``ACCELERATE_TPU_MIXED_PRECISION`` and refuse an unknown value.
* ``JSONLTracker`` writes the JAX package's records (equal but for the
  wall-clock ``time``).
* ``find_executable_batch_size`` halves on ``torch.OutOfMemoryError``, as
  the JAX package halves on its out-of-memory errors, and re-raises
  anything else.
"""

import json
import logging
import random

import numpy as np
import pytest
import torch

from accelerate_tpu import tracking as jax_tracking
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.utils import memory as jax_memory
from accelerate_tpu.utils.profiling import PipelineStats as JaxPipelineStats
from accelerate_tpu_torch import Accelerator, GradientAccumulationPlugin, set_seed
from accelerate_tpu_torch import tracking
from accelerate_tpu_torch.logging import get_logger
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils import memory, operations
from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration, ProjectConfiguration
from accelerate_tpu_torch.utils.profiling import PipelineStats


def test_singletons_share_their_state():
    acc = Accelerator(cpu=True, mixed_precision="bf16", gradient_accumulation_steps=4)
    assert PartialState().device == torch.device("cpu") and PartialState() is not PartialState()
    assert AcceleratorState().mixed_precision == "bf16" and AcceleratorState().num_processes == 1
    assert GradientState().num_steps == 4 and acc.gradient_accumulation_steps == 4
    acc.gradient_accumulation_steps = 2
    assert GradientState().num_steps == 2
    assert acc.is_main_process and acc.is_local_main_process and acc.is_last_process
    assert not acc.use_distributed and acc.distributed_type == "NO"
    # Another precision in the same process is refused, as in the JAX package.
    with pytest.raises(ValueError, match="already initialized"):
        Accelerator(cpu=True, mixed_precision="fp16")
    with pytest.raises(ValueError, match="mixed_precision must be one of"):
        AcceleratorState._reset_state()
        AcceleratorState(mixed_precision="int3")
    GradientState(GradientAccumulationPlugin(num_steps=5, sync_each_batch=True))
    assert GradientState().num_steps == 5 and GradientState().sync_each_batch


def test_mixed_precision_comes_from_the_environment(monkeypatch):
    """A launched script asks for its precision through the environment:
    both packages resolve it when the argument is None; an argument wins."""
    monkeypatch.setenv("ACCELERATE_TPU_MIXED_PRECISION", "bf16")
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    assert JaxAcceleratorState().mixed_precision == "bf16"
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    assert AcceleratorState(cpu=True).mixed_precision == "bf16"
    AcceleratorState._reset_state()
    acc = Accelerator(cpu=True)
    assert acc.mixed_precision == "bf16" and acc.policy.compute_dtype == torch.bfloat16
    AcceleratorState._reset_state()
    assert AcceleratorState(mixed_precision="no", cpu=True).mixed_precision == "no"


def test_an_unknown_precision_in_the_environment_is_refused(monkeypatch):
    monkeypatch.setenv("ACCELERATE_TPU_MIXED_PRECISION", "int3")
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    with pytest.raises(ValueError, match="mixed_precision must be one of"):
        JaxAcceleratorState()
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    with pytest.raises(ValueError, match="mixed_precision must be one of"):
        AcceleratorState(cpu=True)
    assert AcceleratorState._shared_state == {}  # a failed construction leaves no state


def test_another_device_in_the_same_process_is_refused():
    """The device is the process's: a second accelerator asking for another
    one raises instead of running where the first one put the state."""
    Accelerator(cpu=True)
    with pytest.raises(ValueError, match="cannot re-init with cpu=False"):
        Accelerator()
    with pytest.raises(ValueError, match="cannot re-init with cpu=False"):
        AcceleratorState(cpu=False)
    assert Accelerator(cpu=True).device == torch.device("cpu")
    assert AcceleratorState().device == torch.device("cpu")  # None takes what is there
    AcceleratorState._reset_state()
    with pytest.raises(ValueError, match="cannot re-init with cpu=False"):
        Accelerator()  # the process state alone already holds the CPU
    assert not AcceleratorState._shared_state


def test_several_processes_are_not_ported(monkeypatch):
    """A world the environment names but gives no rendezvous for raises
    (there is no quiet fall-back to one process), and so does one on the
    card without a card; a failed construction leaves nothing."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="no rendezvous"):
        PartialState(cpu=True)
    assert not PartialState._shared_state
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PartialState()
    assert not PartialState._shared_state


def test_decorators_and_process_helpers(capsys):
    state = PartialState(cpu=True)
    assert state.on_main_process(lambda: 3)() == 3
    assert state.on_process(lambda: 4, process_index=0)() == 4
    assert state.on_process(lambda: 5, process_index=1)() is None
    with state.split_between_processes([1, 2, 3]) as part:
        assert part == [1, 2, 3]
    with state.main_process_first():
        state.print("hello")
    assert "hello" in capsys.readouterr().out


def test_set_seed_seeds_python_numpy_and_torch():
    draws = []
    for _ in range(2):
        assert set_seed(11) == 11
        draws.append((random.random(), float(np.random.rand()), torch.rand(3).tolist()))
    assert draws[0] == draws[1]


def test_operations_on_one_process():
    batch = {"a": torch.arange(4), "b": [np.ones(2, np.float32), "label"]}
    moved = operations.send_to_device(batch, "cpu", skip_keys="b")
    assert moved["b"] is batch["b"] and torch.equal(moved["a"], batch["a"])
    assert operations.send_to_device(batch, "cpu")["b"][0].dtype == torch.float32
    assert operations.gather(batch) is batch
    assert operations.gather_object([1, 2]) == [1, 2] and operations.gather_object(3) == [3]
    assert torch.equal(operations.reduce(torch.tensor([2.0]), "mean", scale=3.0),
                       torch.tensor([6.0]))
    with pytest.raises(ValueError, match="reduction"):
        operations.reduce(torch.tensor(1.0), "max")
    assert operations.pad_across_processes(batch) is batch
    cat = operations.concatenate([{"x": torch.zeros(2, 3)}, {"x": torch.ones(1, 3)}])
    assert cat["x"].shape == (3, 3)
    with pytest.raises(TypeError, match="cannot handle"):
        operations.recursively_apply(lambda t: t, {"s": "text"}, error_on_other_type=True)


def test_accelerator_helpers():
    acc = Accelerator(cpu=True)
    module = torch.nn.Linear(2, 1)
    model = acc.prepare(module)
    assert acc.unwrap_model(model) is module
    assert set(acc.get_state_dict(model)) == {"weight", "bias"}
    assert not acc.check_trigger()
    acc.set_trigger()
    assert acc.check_trigger() and not acc.check_trigger()
    with acc.accumulate():
        pass
    with acc.no_sync():
        assert not acc.sync_gradients
    assert acc.sync_gradients
    acc.gradient_accumulation_steps = 3
    assert [acc.accumulate().__enter__() or acc.sync_gradients for _ in range(6)] == \
        [False, True, False, False, True, False]  # the counter continues from above
    assert acc.free_memory(model) == [None] and not acc._models
    with pytest.raises(ValueError, match="prefetch_size"):
        DataLoaderConfiguration(prefetch_size=0)
    assert ProjectConfiguration(project_dir="p").logging_dir == "p"


def test_jsonl_tracker_writes_the_jax_records(tmp_path):
    values = {"loss": 1.5, "lr": np.float32(0.25), "tag": object}
    records = []
    for module, sub in ((tracking, "port"), (jax_tracking, "jax")):
        tracker = module.JSONLTracker("run/a", logging_dir=str(tmp_path / sub))
        tracker.store_init_configuration({"lr": 0.1, "layers": 2})
        tracker.log(values, step=3)
        tracker.finish()
        lines = [json.loads(line) for line in open(tracker.path)]
        for line in lines:
            line.pop("time", None)
        records.append(lines)
    assert records[0] == records[1]
    assert records[0][1]["lr"] == 0.25 and records[0][1]["tag"] == str(object)


def test_trackers_through_the_accelerator(tmp_path):
    acc = Accelerator(cpu=True, project_dir=str(tmp_path))
    acc.init_trackers("exp", config={"seed": 0})
    acc.pipeline_stats.record_wait(4.0)
    acc.pipeline_stats.record_stage(1.0)
    acc.log({"loss": 2.0}, step=1, include_input_pipeline=True)
    tracker = acc.get_tracker("jsonl")
    acc.end_training()
    lines = [json.loads(line) for line in open(tracker.path)]
    assert lines[0] == {"_type": "config", "config": {"seed": 0}}
    assert lines[1]["loss"] == 2.0 and lines[1]["input_pipeline/data_wait_ms"] == 4.0
    with pytest.raises(ValueError, match="not an available tracker"):
        acc.get_tracker("wandb")
    assert tracking.filter_trackers("wandb", str(tmp_path)) == []  # no wandb package here
    with pytest.raises(ValueError, match="Unknown tracker"):
        tracking.filter_trackers("nope", str(tmp_path))
    custom = tracking.JSONLTracker("c", str(tmp_path))
    assert tracking.filter_trackers([custom, "all"], None) == [custom]  # jsonl needs a dir


def test_pipeline_stats_match_jax():
    ours, ref = PipelineStats(), JaxPipelineStats()
    for stats in (ours, ref):
        for ms in (3.0, 1.0, 2.0):
            stats.record_wait(ms)
            stats.record_stage(ms / 2)
        stats.record_depth(2)
        stats.record_depth(1)
    assert ours.summary() == ref.summary()


def test_logger_logs_on_the_main_process(caplog):
    PartialState(cpu=True)
    logger = get_logger("atpu-test")
    with caplog.at_level(logging.INFO, logger="atpu-test"):
        logger.info("once", main_process_only=True)
        logger.info("every", main_process_only=False, in_order=True)
    assert [r.message for r in caplog.records] == ["once", "every"]


def test_find_executable_batch_size_halves_on_oom_only():
    tried = []

    @memory.find_executable_batch_size(starting_batch_size=64)
    def step(batch_size, scale):
        tried.append(batch_size)
        if batch_size > 8:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return batch_size * scale

    assert step(2) == 16 and tried == [64, 32, 16, 8]
    # The JAX package tries the same sizes on its out-of-memory errors.
    ref_tried = []

    @jax_memory.find_executable_batch_size(starting_batch_size=64)
    def ref_step(batch_size):
        ref_tried.append(batch_size)
        if batch_size > 8:
            raise MemoryError("RESOURCE_EXHAUSTED")
        return batch_size

    ref_step()
    assert ref_tried == tried

    @memory.find_executable_batch_size(starting_batch_size=64)
    def other(batch_size):
        tried.append(batch_size)
        raise RuntimeError("not a memory error")

    tried.clear()
    with pytest.raises(RuntimeError, match="not a memory error"):
        other()
    assert tried == [64]  # no retry

    @memory.find_executable_batch_size(starting_batch_size=4, reduce_batch_size_fn=lambda b: b)
    def stuck(batch_size):
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(RuntimeError, match="strictly decrease"):
        stuck()
    with pytest.raises(TypeError, match="supplies"):
        step(16, 2)


def test_release_memory_drops_references():
    a, b = memory.release_memory(torch.zeros(2), torch.ones(2))
    assert a is None and b is None
