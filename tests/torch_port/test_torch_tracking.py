"""The six third-party trackers and the tracker selection against the JAX
package's (``accelerate_tpu/tracking.py``).

Neither package depends on W&B, MLflow, Comet ML, Aim, ClearML or DVCLive,
and the tests need none of them installed. Each test installs one fake module per
library into ``sys.modules``: every attribute of it is a recorder, so a
call anywhere below it (``wandb.init(...).log(...)``, ``from clearml import
Task; Task.init(...).get_logger().report_scalar(...)``) is appended, with
its arguments, to one list. The JAX tracker and the port's run the same
sequence, and their two lists must be equal.
"""

import sys
import types

import numpy as np
import pytest

import accelerate_tpu.tracking as jax_tracking
import accelerate_tpu_torch.tracking as tracking
from accelerate_tpu.utils.dataclasses import LoggerType as JaxLoggerType
from accelerate_tpu_torch.utils.dataclasses import LoggerType

LIBRARIES = ("wandb", "mlflow", "comet_ml", "aim", "clearml", "dvclive")
CLASSES = {"wandb": "WandBTracker", "mlflow": "MLflowTracker", "comet_ml": "CometMLTracker",
           "aim": "AimTracker", "clearml": "ClearMLTracker", "dvclive": "DVCLiveTracker"}


class Recorder:
    """A path below a fake library: calling it records ``(path, args,
    kwargs)`` and returns the recorder of the call's result; setting an
    attribute or an item records it too."""

    def __init__(self, calls, path):
        object.__setattr__(self, "_calls", calls)
        object.__setattr__(self, "_path", path)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return Recorder(self._calls, f"{self._path}.{name}")

    def __call__(self, *args, **kwargs):
        self._calls.append((self._path, args, kwargs))
        return Recorder(self._calls, f"{self._path}()")

    def __setattr__(self, name, value):
        self._calls.append((f"{self._path}.{name} =", (value,), {}))

    def __setitem__(self, key, value):
        self._calls.append((f"{self._path}[{key!r}] =", (value,), {}))

    def __eq__(self, other):
        return isinstance(other, Recorder) and other._path == self._path

    def __hash__(self):
        return hash(self._path)

    def __repr__(self):
        return f"<{self._path}>"


def install_fakes(monkeypatch, available=LIBRARIES) -> list:
    """Fake modules of the six libraries in ``sys.modules``, and both
    packages' availability probes answering True for ``available`` (and
    for "jsonl" and "tensorboard"). Returns the shared call list."""
    calls = []
    for name in LIBRARIES:
        module = types.ModuleType(name)
        module.__getattr__ = lambda attr, name=name: Recorder(calls, f"{name}.{attr}")
        monkeypatch.setitem(sys.modules, name, module)
    for module in (tracking, jax_tracking):
        for name in module._AVAILABILITY:
            monkeypatch.setitem(module._AVAILABILITY, name,
                                (lambda ok: (lambda: ok))(name in available
                                                          or name in ("jsonl", "tensorboard")))
    return calls


def drive(module, library: str, logging_dir: str):
    """Construct, store a configuration of 150 keys, log with and without
    a step and with int, float and non-scalar values, finish."""
    cls = getattr(module, CLASSES[library])
    args = ("proj", logging_dir) if cls.requires_logging_directory else ("proj",)
    tracker = cls(*args)
    tracker.store_init_configuration({f"k{i}": i for i in range(150)} | {"name": "tiny"})
    tracker.log({"loss": 1.5, "step_count": 3, "lr/group0": 0.25})
    tracker.log({"loss": 1.25, "tokens": [1, 2], "note": "warm", "acc": np.float32(0.5)},
                step=7)
    tracker.log({"loss": 1.0}, step=0)
    unwrapped = tracker.tracker
    tracker.finish()
    return unwrapped


@pytest.mark.parametrize("library", LIBRARIES)
def test_each_tracker_makes_the_jax_trackers_calls(library, monkeypatch, tmp_path):
    calls = install_fakes(monkeypatch)
    jax_tracker = drive(jax_tracking, library, str(tmp_path))
    jax_calls = list(calls)
    calls.clear()
    port_tracker = drive(tracking, library, str(tmp_path))
    assert calls == jax_calls
    assert port_tracker == jax_tracker  # the same library object, unwrapped
    assert len(calls) >= 6 and calls[0][0].startswith(library)
    if library == "mlflow":  # log_params in chunks of 100 keys; only int/float metrics
        params = [c for c in calls if c[0] == "mlflow.log_params"]
        assert [len(c[1][0]) for c in params] == [100, 51]
        assert [c[1][0] for c in calls if c[0] == "mlflow.log_metrics"][1] == {"loss": 1.25}
    if library == "clearml":
        reports = [c[2] for c in calls if c[0].endswith("report_scalar")]
        assert reports[2] == dict(title="lr", series="group0", value=0.25, iteration=0)
        assert {r["title"] for r in reports} == {"loss", "step_count", "lr"}
    if library == "dvclive":
        names = [c[0] for c in calls]
        assert names.count("dvclive.Live().next_step") == 3
        assert ("dvclive.Live().step =", (7,), {}) in calls


@pytest.mark.parametrize("library", LIBRARIES)
def test_trackers_do_nothing_off_the_main_process(library, monkeypatch, tmp_path):
    calls = install_fakes(monkeypatch)
    monkeypatch.setattr(tracking, "is_main_process", lambda: False)
    monkeypatch.setattr(jax_tracking, "PartialState",
                        lambda: types.SimpleNamespace(is_main_process=False))
    for module in (jax_tracking, tracking):
        cls = getattr(module, CLASSES[library])
        tracker = cls(*(("proj", str(tmp_path)) if cls.requires_logging_directory
                        else ("proj",)))
        tracker.store_init_configuration({"lr": 0.1})
        tracker.log({"loss": 1.0}, step=1)
        tracker.finish()
    assert calls == []


def _instance(module):
    class Custom(module.GeneralTracker):
        name = "custom"
        requires_logging_directory = False
        tracker = None

    return Custom()


#: ``(log_with, logging_dir given, available packages)``; "INST" is a
#: GeneralTracker of the package under test.
SELECTION = {
    "none": (None, True, ()),
    "one name": ("jsonl", True, ()),
    "names": (["tensorboard", "jsonl"], True, ()),
    "duplicate names": (["jsonl", "jsonl"], True, ()),
    "all": ("all", True, ("wandb", "aim")),
    "LoggerType.ALL": ("ALL_ENUM", True, ("wandb", "mlflow")),
    "all without a directory": (["all"], False, ("wandb", "aim")),
    "all beside an unknown name": (["all", "nope"], True, ()),
    "instance alone": ("INST", False, ()),
    "instance and a name": (["INST", "jsonl"], True, ()),
    "named, package missing": (["wandb", "jsonl"], True, ()),
    "named, package present": (["jsonl", "wandb"], True, ("wandb",)),
    "needs a directory, none given": (["jsonl", "aim", "wandb"], False, ("aim", "wandb")),
    "directory given": (["aim", "dvclive"], True, ("aim", "dvclive")),
}


def _spec(enum, value, inst):
    if value == "ALL_ENUM":
        return enum.ALL
    if isinstance(value, list):
        return [inst if v == "INST" else v for v in value]
    return inst if value == "INST" else value


def _names(trackers):
    return [t if isinstance(t, str) else type(t).__name__ for t in trackers]


@pytest.mark.parametrize("case", SELECTION)
def test_filter_trackers_matches_jax(case, monkeypatch, tmp_path):
    value, with_dir, available = SELECTION[case]
    install_fakes(monkeypatch, available)
    logging_dir = str(tmp_path) if with_dir else None
    got = {}
    for module, enum in ((jax_tracking, JaxLoggerType), (tracking, LoggerType)):
        spec = _spec(enum, value, _instance(module))
        got[module] = _names(module.filter_trackers(spec, logging_dir))
    assert got[tracking] == got[jax_tracking]
    if case == "named, package missing":
        assert got[tracking] == ["jsonl"]  # the port no longer builds (and fails on) wandb
    if case == "needs a directory, none given":
        assert got[tracking] == ["wandb"]


@pytest.mark.parametrize("value", ["nope", ["jsonl", "nope"], ["INST", "nope"]])
def test_an_unknown_name_raises_in_both(value, monkeypatch, tmp_path):
    install_fakes(monkeypatch)
    for module, enum in ((jax_tracking, JaxLoggerType), (tracking, LoggerType)):
        with pytest.raises(ValueError, match="Unknown tracker"):
            module.filter_trackers(_spec(enum, value, _instance(module)), str(tmp_path))


def test_an_instance_beside_all_is_kept_where_jax_drops_it(monkeypatch, tmp_path):
    """The one difference from the JAX selection, on purpose (ROADMAP.md C):
    with "all" in the list the JAX function names every tracker and loses
    the caller's instances."""
    install_fakes(monkeypatch, ())
    jax_got = jax_tracking.filter_trackers([_instance(jax_tracking), "all"],
                                           str(tmp_path))
    inst = _instance(tracking)
    got = tracking.filter_trackers([inst, "all"], str(tmp_path))
    assert jax_got == ["tensorboard", "jsonl"]
    assert got == [inst, "tensorboard", "jsonl"]


def test_resolve_trackers_splits_the_arguments_as_jax_does(monkeypatch, tmp_path):
    """A tracker that needs a directory gets ``(project, logging_dir)``;
    W&B's ``__init__(run_name, **kwargs)`` and MLflow's get the project
    alone (the port passed two positionals to every tracker, a TypeError for
    W&B); ``init_kwargs`` go to their tracker."""
    calls = install_fakes(monkeypatch)
    log_with = ["wandb", "aim", "mlflow", "dvclive"]
    init_kwargs = {"wandb": {"entity": "team"}, "aim": {"experiment": "e1"}}
    records = []
    for module in (jax_tracking, tracking):
        calls.clear()
        trackers = module.resolve_trackers(log_with, "proj", str(tmp_path), config={"lr": 0.1},
                                           init_kwargs=init_kwargs)
        assert [t.name for t in trackers] == log_with
        records.append(list(calls))
    assert records[0] == records[1]
    assert ("wandb.init", (), {"project": "proj", "entity": "team"}) in records[1]
    assert ("aim.Run", (), {"repo": str(tmp_path), "experiment": "e1"}) in records[1]
    assert ("mlflow.create_experiment", ("proj",), {}) in records[1]


def test_accelerator_drives_two_trackers_as_jax_does(monkeypatch, tmp_path):
    """``Accelerator(log_with=...)`` -> ``init_trackers`` -> ``log`` ->
    ``get_tracker(unwrap=True)`` -> ``end_training`` with W&B and ClearML
    at once, in both packages."""
    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
    from accelerate_tpu_torch import Accelerator

    calls = install_fakes(monkeypatch)
    records, unwrapped = [], []
    for make in (lambda: JaxAccelerator(log_with=["wandb", "clearml"],
                                        project_dir=str(tmp_path)),
                 lambda: Accelerator(cpu=True, log_with=["wandb", "clearml"],
                                     project_dir=str(tmp_path))):
        JaxAcceleratorState._reset_state()
        calls.clear()
        acc = make()
        acc.init_trackers("proj", config={"lr": 0.1, "layers": 2})
        acc.log({"train/loss": 2.0, "epoch": 1}, step=3)
        acc.log({"train/loss": 1.5}, step=4, log_kwargs={"wandb": {"commit": True}})
        unwrapped.append(acc.get_tracker("wandb", unwrap=True))
        assert acc.get_tracker("clearml").name == "clearml"
        acc.end_training()
        records.append(list(calls))
    assert records[0] == records[1]
    assert unwrapped[0] == unwrapped[1] == Recorder(calls, "wandb.init()")
    assert [c[0] for c in records[1]][-2:] == ["wandb.init().finish", "clearml.Task.init().close"]
    assert ("wandb.init().log", ({"train/loss": 1.5},), {"step": 4, "commit": True}) in records[1]
