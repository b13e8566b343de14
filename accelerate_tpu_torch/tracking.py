"""Experiment trackers.

Counterpart of ``accelerate_tpu/tracking.py``: ``GeneralTracker``
(``:48``), ``JSONLTracker`` (``:79``, one JSON object per line, the
default), ``TensorBoardTracker`` (``:129``, on
``torch.utils.tensorboard``, which needs the ``tensorboard`` package),
``filter_trackers``/``resolve_trackers`` and
``with_input_pipeline_metrics`` (``:413``). The six other trackers of the
JAX package (W&B, Comet ML, Aim, MLflow, ClearML, DVCLive, ``:174-386``)
need packages the port does not depend on; asking for one by name raises
``NotImplementedError``.
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

logger = get_logger(__name__)

#: Trackers of the JAX package over packages the port does not depend on.
NOT_PORTED = ("aim", "comet_ml", "mlflow", "wandb", "clearml", "dvclive")


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


LOGGER_TYPE_TO_CLASS = {"jsonl": JSONLTracker, "tensorboard": TensorBoardTracker}
#: Whether a tracker's package is importable; "all" starts only these.
_AVAILABILITY = {"jsonl": lambda: True, "tensorboard": _tensorboard_available}


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


def filter_trackers(log_with, logging_dir: Optional[str] = None) -> list:
    """Tracker names and instances to start from ``log_with`` (a name, a
    ``GeneralTracker``, "all", or a list of them)."""
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    trackers, names = [], []
    for item in log_with:
        if isinstance(item, GeneralTracker):
            trackers.append(item)
        elif str(item) == "all":
            names.extend(n for n, available in _AVAILABILITY.items() if available())
        elif str(item) in NOT_PORTED:
            raise NotImplementedError(
                f"the {item} tracker needs a package accelerate_tpu_torch does not depend on; "
                "use 'jsonl' or 'tensorboard', or pass a GeneralTracker")
        elif str(item) in LOGGER_TYPE_TO_CLASS:
            names.append(str(item))
        else:
            raise ValueError(f"Unknown tracker {item!r}; choose from "
                             f"{list(LOGGER_TYPE_TO_CLASS)} or pass a GeneralTracker instance.")
    for name in dict.fromkeys(names):
        if LOGGER_TYPE_TO_CLASS[name].requires_logging_directory and logging_dir is None:
            logger.warning(f"Tracker {name} requires a logging_dir; skipping.")
            continue
        trackers.append(name)
    return trackers


def resolve_trackers(log_with, project_name: str, logging_dir: Optional[str], config=None,
                     init_kwargs: Optional[dict] = None) -> list:
    """Start the trackers of ``log_with`` (default: JSONL) and store the
    run's ``config`` in each."""
    init_kwargs = init_kwargs or {}
    trackers = []
    for item in filter_trackers(["jsonl"] if log_with is None else log_with, logging_dir):
        if isinstance(item, GeneralTracker):
            trackers.append(item)
            continue
        cls = LOGGER_TYPE_TO_CLASS[item]
        trackers.append(cls(project_name, logging_dir or ".", **init_kwargs.get(item, {})))
    if config is not None:
        for tracker in trackers:
            tracker.store_init_configuration(config)
    return trackers
