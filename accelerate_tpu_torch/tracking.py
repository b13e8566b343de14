"""Experiment trackers.

Counterpart of ``accelerate_tpu/tracking.py``: ``GeneralTracker``
(``:48``), ``JSONLTracker`` (``:79``, one JSON object per line, the
default), ``TensorBoardTracker`` (``:129``, on
``torch.utils.tensorboard``, which needs the ``tensorboard`` package),
the six trackers over third-party services (``WandBTracker``,
``MLflowTracker``, ``CometMLTracker``, ``AimTracker``, ``ClearMLTracker``,
``DVCLiveTracker``, ``:174-386``: the same calls on each library, which is
imported only when a tracker is made, so the port depends on none of them),
``filter_trackers``/``resolve_trackers`` (``:462-519``) and
``with_input_pipeline_metrics`` (``:413``).
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import time
from typing import Optional

from .logging import get_logger
from .state import is_main_process
from .utils.dataclasses import LoggerType
from .utils.imports import (
    is_aim_available,
    is_clearml_available,
    is_comet_ml_available,
    is_dvclive_available,
    is_mlflow_available,
    is_wandb_available,
)

logger = get_logger(__name__)


def on_main_process(function):
    """Run a tracker method only on the main process."""

    @functools.wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if getattr(self, "main_process_only", True) and not is_main_process():
            return None
        return function(self, *args, **kwargs)

    return execute_on_main_process


class GeneralTracker:
    """Tracker base class. A subclass sets ``name`` and
    ``requires_logging_directory``, has a ``tracker`` attribute (the raw
    run object) and implements ``store_init_configuration`` and ``log``."""

    main_process_only = True

    def __init__(self, _blank: bool = False):
        if not _blank:
            missing = [f"`{attr}`" for attr in ("name", "requires_logging_directory")
                       if not hasattr(self, attr)]
            if "tracker" not in dir(self):
                missing.append("`tracker`")
            if missing:
                raise NotImplementedError(
                    "The implementation for this tracker class is missing the following "
                    f"required attributes: {', '.join(missing)}")

    def store_init_configuration(self, values: dict):
        """Record the run's configuration."""

    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        """Record scalar metrics at ``step``."""

    def finish(self):
        """Flush and close the run."""


class JSONLTracker(GeneralTracker):
    """One JSON object a call in ``<logging_dir>/<run_name>.metrics.jsonl``:
    ``{"_type": "config", "config": ...}`` once, then ``{"_type":
    "metrics", "step": ..., "time": ..., <values>}``."""

    name = "jsonl"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__()
        self.run_name = run_name
        os.makedirs(logging_dir, exist_ok=True)
        self.path = os.path.join(logging_dir, f"{run_name.replace('/', '_')}.metrics.jsonl")
        self._fh = open(self.path, "a")

    @property
    def tracker(self):
        return self._fh

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._write({"_type": "config", "config": values})

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self._write({"_type": "metrics", "step": step, "time": time.time(), **values})

    def _write(self, obj):
        def clean(v):
            try:
                json.dumps(v)
                return v
            except TypeError:
                return float(v) if hasattr(v, "__float__") else str(v)

        self._fh.write(json.dumps({k: clean(v) for k, v in obj.items()}) + "\n")
        self._fh.flush()

    @on_main_process
    def finish(self):
        self._fh.close()

    def __del__(self):  # pragma: no cover - depends on when the GC runs
        fh = getattr(self, "_fh", None)
        if fh is not None and not fh.closed:
            fh.close()


def _summary_writer_module():
    """``torch.utils.tensorboard``, imported when a tracker is made: it
    needs the ``tensorboard`` package, which the port does not depend on."""
    try:
        return importlib.import_module("torch.utils.tensorboard")
    except ImportError as exc:
        raise ImportError(
            "the tensorboard tracker needs the `tensorboard` package (for "
            "torch.utils.tensorboard), which is not installed; use the 'jsonl' tracker "
            "or install tensorboard") from exc


def _tensorboard_available() -> bool:
    return importlib.util.find_spec("tensorboard") is not None


class TensorBoardTracker(GeneralTracker):
    """Event files under ``<logging_dir>/<run_name>`` through
    ``SummaryWriter``: the configuration as hparams, numbers as scalars,
    strings as text and dicts as scalar groups."""

    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        super().__init__()
        tensorboard = _summary_writer_module()
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        self.writer = tensorboard.SummaryWriter(self.logging_dir, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.add_hparams(
            {k: v for k, v in values.items() if isinstance(v, (int, float, str, bool))},
            metric_dict={})
        self.writer.flush()

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, global_step=step, **kwargs)
            elif isinstance(v, str):
                self.writer.add_text(k, v, global_step=step, **kwargs)
            elif isinstance(v, dict):
                self.writer.add_scalars(k, v, global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def finish(self):
        self.writer.close()


class WandBTracker(GeneralTracker):
    """A Weights & Biases run (``wandb.init(project=run_name, ...)``)."""

    name = "wandb"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import wandb

        self.run_name = run_name
        self.run = wandb.init(project=self.run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.run.finish()


class MLflowTracker(GeneralTracker):
    """An MLflow run, in a new experiment named ``experiment_name`` when
    one is given. The configuration goes to ``log_params`` 100 keys a call;
    only ``int`` and ``float`` values are logged as metrics (a tensor or a
    numpy scalar is dropped, as in the JAX package)."""

    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, experiment_name: str = None, logging_dir: str = None, run_id=None,
                 tags=None, nested_run=False, run_name=None, description=None):
        super().__init__()
        import mlflow

        exp_id = mlflow.create_experiment(experiment_name) if experiment_name else None
        self.active_run = mlflow.start_run(
            run_id=run_id, experiment_id=exp_id, run_name=run_name, nested=nested_run,
            tags=tags, description=description)

    @property
    def tracker(self):
        return self.active_run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        items = list(values.items())
        for i in range(0, len(items), 100):
            mlflow.log_params(dict(items[i:i + 100]))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import mlflow

        mlflow.log_metrics({k: v for k, v in values.items() if isinstance(v, (int, float))},
                           step=step)

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


class CometMLTracker(GeneralTracker):
    """A Comet ML ``Experiment(project_name=run_name, ...)``."""

    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        from comet_ml import Experiment

        self.run_name = run_name
        self.writer = Experiment(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.writer.set_step(step)
        self.writer.log_others(values)

    @on_main_process
    def finish(self):
        self.writer.end()


class AimTracker(GeneralTracker):
    """An Aim ``Run`` whose repository is the logging directory."""

    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__()
        from aim import Run

        self.writer = Run(repo=logging_dir, **kwargs)
        self.writer.name = run_name

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.writer.close()


class ClearMLTracker(GeneralTracker):
    """A ClearML ``Task``. A metric ``"title/series"`` is reported under
    that title and series (a name without "/" is both), at iteration
    ``step`` or 0; only ``int`` and ``float`` values are reported, as in the
    JAX package."""

    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str = None, **kwargs):
        super().__init__()
        from clearml import Task

        self.task = Task.init(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.task.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            if isinstance(v, (int, float)):
                title, _, series = k.partition("/")
                clearml_logger.report_scalar(title=title, series=series or title, value=v,
                                             iteration=step or 0)

    @on_main_process
    def finish(self):
        self.task.close()


class DVCLiveTracker(GeneralTracker):
    """A DVCLive ``Live`` (or the caller's ``live``); each ``log`` sets the
    step when one is given, logs every value, then moves to the next
    step."""

    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name=None, live=None, **kwargs):
        super().__init__()
        from dvclive import Live

        self.live = live if live is not None else Live(**kwargs)

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            self.live.log_metric(k, v)
        self.live.next_step()

    @on_main_process
    def finish(self):
        self.live.end()


LOGGER_TYPE_TO_CLASS = {
    "aim": AimTracker,
    "comet_ml": CometMLTracker,
    "mlflow": MLflowTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "clearml": ClearMLTracker,
    "dvclive": DVCLiveTracker,
    "jsonl": JSONLTracker,
}
#: Whether a tracker's package is importable: "all" starts only these, and
#: a tracker named alone whose package is missing is skipped.
_AVAILABILITY = {
    "tensorboard": _tensorboard_available,
    "wandb": is_wandb_available,
    "comet_ml": is_comet_ml_available,
    "aim": is_aim_available,
    "mlflow": is_mlflow_available,
    "clearml": is_clearml_available,
    "dvclive": is_dvclive_available,
    "jsonl": lambda: True,
}


def with_input_pipeline_metrics(values: dict, pipeline_stats,
                                prefix: str = "input_pipeline/") -> dict:
    """``values`` with the input pipeline's summary (``data_wait_ms``,
    ``stage_ms``, ``queue_depth``...) under ``prefix``; the caller's keys
    win."""
    if pipeline_stats is None:
        return values
    merged = {f"{prefix}{k}": v for k, v in pipeline_stats.summary().items()}
    merged.update(values)
    return merged


def with_serving_metrics(values: dict, serving_stats, prefix: str = "serving/") -> dict:
    """``values`` with a serving engine's summary (``ttft_ms``,
    ``queue_wait_ms``, ``decode_tokens_per_sec``, ``slot_occupancy``, the
    prefill and prefix-cache keys: ``serving.metrics.ServingStats``) under
    ``prefix``; the caller's keys win."""
    if serving_stats is None:
        return values
    merged = {f"{prefix}{k}": v for k, v in serving_stats.summary().items()}
    merged.update(values)
    return merged


def with_gateway_metrics(values: dict, gateway_stats, prefix: str = "gateway/") -> dict:
    """``values`` with the HTTP gateway's counters (``http_requests``,
    ``http_429``, ``streams``, ``tokens_streamed``...:
    ``serving.metrics.GatewayStats``) under ``prefix``; the caller's keys
    win."""
    if gateway_stats is None:
        return values
    merged = {f"{prefix}{k}": v for k, v in gateway_stats.summary().items()}
    merged.update(values)
    return merged


def with_fleet_metrics(values: dict, replica_set, prefix: str = "fleet/") -> dict:
    """``values`` with a replica set's fleet view
    (``ReplicaSet.fleet_metrics()``: every replica's serving counters folded
    together, and the router's health and failover counters) under
    ``prefix``; the caller's own keys win."""
    if replica_set is None:
        return values
    merged = {f"{prefix}{k}": v for k, v in replica_set.fleet_metrics().items()}
    merged.update(values)
    return merged


def filter_trackers(log_with, logging_dir: Optional[str] = None) -> list:
    """Tracker names and instances to start from ``log_with`` (a name, a
    ``GeneralTracker``, "all", or a list of them): the instances first,
    then each named tracker whose package is importable and, if it needs
    one, has a ``logging_dir``. "all" names every tracker. Unlike the JAX
    function, an instance beside "all" is kept (ROADMAP.md C)."""
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    trackers = [item for item in log_with if isinstance(item, GeneralTracker)]
    if "all" in [str(x) for x in log_with] or LoggerType.ALL in log_with:
        names = list(LOGGER_TYPE_TO_CLASS)
    else:
        names = [str(item) for item in log_with if not isinstance(item, GeneralTracker)]
        for name in names:
            if name not in LOGGER_TYPE_TO_CLASS:
                raise ValueError(f"Unknown tracker {name!r}; choose from "
                                 f"{list(LOGGER_TYPE_TO_CLASS)} or pass a GeneralTracker "
                                 "instance.")
    for name in names:
        if not _AVAILABILITY[name]():
            logger.debug(f"Tracker {name} not available; skipping.")
        elif LOGGER_TYPE_TO_CLASS[name].requires_logging_directory and logging_dir is None:
            logger.warning(f"Tracker {name} requires a logging_dir; skipping.")
        else:
            trackers.append(name)
    return trackers


def resolve_trackers(log_with, project_name: str, logging_dir: Optional[str], config=None,
                     init_kwargs: Optional[dict] = None) -> list:
    """Start the trackers of ``log_with`` (default: JSONL) and store the
    run's ``config`` in each. A tracker that needs a directory gets
    ``(project_name, logging_dir)``, any other ``(project_name)``; each
    gets its ``init_kwargs[name]``."""
    init_kwargs = init_kwargs or {}
    trackers = []
    for item in filter_trackers(["jsonl"] if log_with is None else log_with, logging_dir):
        if isinstance(item, GeneralTracker):
            trackers.append(item)
            continue
        cls = LOGGER_TYPE_TO_CLASS[item]
        args = (project_name, logging_dir or ".") if cls.requires_logging_directory \
            else (project_name,)
        trackers.append(cls(*args, **init_kwargs.get(item, {})))
    if config is not None:
        for tracker in trackers:
            tracker.store_init_configuration(config)
    return trackers
