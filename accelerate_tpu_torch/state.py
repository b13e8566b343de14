"""Process, accelerator and gradient-accumulation state, as singletons.

Counterpart of ``accelerate_tpu/state.py``: ``PartialState`` (``:89``),
``AcceleratorState`` (``:354``) and ``GradientState`` (``:499``), each a
Borg (every instance shares one ``__dict__``), so any module can read the
same state. This is one process on one device: ``WORLD_SIZE`` above 1
raises (process groups over ``torch.distributed`` are ROADMAP.md, A8).
Tests reset the singletons between cases with ``_reset_state``.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from functools import partial, wraps
from typing import Any, Callable, Optional

from .utils.constants import env_var
from .utils.dataclasses import GradientAccumulationPlugin
from .utils.device import resolve_device

PRECISIONS = ("no", "fp32", "bf16", "fp16", "fp8")


def is_main_process() -> bool:
    """Whether this process is the main one, without building the state
    (loggers and trackers ask before any device is chosen): the index of
    the constructed state, else that of the one process there is."""
    return PartialState._shared_state.get("process_index", 0) == 0


class PartialState:
    """The process's view of its world: one process, one device (``cuda``
    unless ``cpu=True``; raises without a card otherwise)."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise NotImplementedError(
                f"WORLD_SIZE={world}: several processes are not ported to accelerate_tpu_torch "
                "yet (ROADMAP.md, A8)")
        device = resolve_device("cpu" if cpu else None)
        # Set in one update, after everything that can raise: a failed
        # construction leaves the singleton empty.
        self._shared_state.update(
            _cpu=cpu, device=device, backend=device.type, num_processes=1, process_index=0,
            local_process_index=0, num_devices=1, distributed_type="NO", debug=False)

    def __repr__(self):
        return (f"Distributed environment: {self.distributed_type}  Backend: {self.backend}\n"
                f"Num processes: {self.num_processes}\nProcess index: {self.process_index}\n"
                f"Device: {self.device}\n")

    @staticmethod
    def _reset_state():
        PartialState._shared_state.clear()

    @property
    def initialized(self) -> bool:
        return self._shared_state != {}

    @property
    def use_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self):
        """Barrier across processes: nothing to wait for on one."""

    @contextmanager
    def main_process_first(self):
        yield

    @contextmanager
    def local_main_process_first(self):
        yield

    def on_main_process(self, function: Callable = None):
        """Decorator: run only on the main process."""
        if function is None:
            return partial(self.on_main_process)

        @wraps(function)
        def run(*args, **kwargs):
            return function(*args, **kwargs) if self.is_main_process else None

        return run

    def on_local_main_process(self, function: Callable = None):
        """Decorator: run only on each machine's main process."""
        if function is None:
            return partial(self.on_local_main_process)

        @wraps(function)
        def run(*args, **kwargs):
            return function(*args, **kwargs) if self.is_local_main_process else None

        return run

    def on_process(self, function: Callable = None, process_index: Optional[int] = None):
        """Decorator: run only on process ``process_index`` (default 0)."""
        if function is None:
            return partial(self.on_process, process_index=process_index)
        index = 0 if process_index is None else process_index

        @wraps(function)
        def run(*args, **kwargs):
            return function(*args, **kwargs) if self.process_index == index else None

        return run

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's share of ``inputs``: all of it on one process."""
        yield inputs

    def print(self, *args, **kwargs):
        if self.is_main_process:
            print(*args, **kwargs)


class AcceleratorState:
    """``PartialState`` plus the mixed-precision mode. Constructing it again
    with another mode raises, as in the JAX package, and so does asking
    for another device (``cpu``): the device is the process's. ``None``
    (the default of both) takes what is there; a first ``None`` mode reads
    ``ACCELERATE_TPU_MIXED_PRECISION`` (the launcher sets it), else "no"."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: Optional[bool] = None,
                 **kwargs):
        self.__dict__ = self._shared_state
        process = PartialState._shared_state
        if cpu is not None and process and bool(cpu) != process["_cpu"]:
            raise ValueError(
                f"the process's state is already initialized on {process['device']} "
                f"(cpu={process['_cpu']}); cannot re-init with cpu={bool(cpu)}. Call "
                "AcceleratorState._reset_state(reset_partial_state=True) first (tests) or "
                "construct once.")
        if self.initialized:
            if mixed_precision is not None and str(mixed_precision) != self.mixed_precision:
                raise ValueError(
                    "AcceleratorState already initialized with mixed_precision="
                    f"{self.mixed_precision!r}; cannot re-init with {mixed_precision!r}. "
                    "Call AcceleratorState._reset_state() first (tests) or construct once.")
            return
        if mixed_precision is None:
            mixed_precision = os.environ.get(env_var("MIXED_PRECISION"), "no")
        mixed_precision = str(mixed_precision).lower()
        if mixed_precision not in PRECISIONS:
            raise ValueError(f"mixed_precision must be one of {PRECISIONS}, got {mixed_precision}")
        partial_state = PartialState(bool(cpu), **kwargs)
        self._shared_state.update(_partial=partial_state, mixed_precision=mixed_precision)

    def __getattr__(self, name):
        # Process-level attributes come from PartialState.
        if name.startswith("__") or name == "_partial":
            raise AttributeError(name)
        return getattr(PartialState(), name)

    @property
    def initialized(self) -> bool:
        return self._shared_state != {}

    @staticmethod
    def _reset_state(reset_partial_state: bool = False):
        AcceleratorState._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()


class GradientState:
    """Gradient accumulation's channel between the accelerator, the
    optimizers, the schedulers and the loaders: whether this microbatch
    syncs (``sync_gradients``), the window (``num_steps``), and the active
    loader's ``end_of_dataloader`` and ``remainder``."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references = [None]
            self.plugin_kwargs = (gradient_accumulation_plugin.to_kwargs()
                                  if gradient_accumulation_plugin is not None else {})
        if (gradient_accumulation_plugin is not None
                and self.plugin_kwargs != gradient_accumulation_plugin.to_kwargs()):
            self.plugin_kwargs = gradient_accumulation_plugin.to_kwargs()

    @property
    def num_steps(self) -> int:
        return self.plugin_kwargs.get("num_steps", 1)

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin_kwargs.get("adjust_scheduler", True)

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def sync_each_batch(self) -> bool:
        return self.plugin_kwargs.get("sync_each_batch", False)

    @property
    def initialized(self) -> bool:
        return GradientState._shared_state != {}

    @property
    def end_of_dataloader(self) -> bool:
        return self.in_dataloader and self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        return self.active_dataloader.remainder if self.in_dataloader else -1

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    def __repr__(self):
        return (f"Sync Gradients: {self.sync_gradients}\n"
                f"At end of current dataloader: {self.end_of_dataloader}\n"
                f"Extra samples added: {self.remainder}\n"
                f"Gradient accumulation plugin: {self.plugin_kwargs}\n")

    def _set_sync_gradients(self, sync_gradients: bool):
        self.sync_gradients = sync_gradients

    def _add_dataloader(self, dataloader):
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader):
        # A loader's generator closed after a reset finds no references.
        refs = self.__dict__.get("dataloader_references")
        if refs is None:
            return
        if dataloader in refs:
            refs.remove(dataloader)
        self.active_dataloader = refs[-1] if refs else None

    @staticmethod
    def _reset_state():
        GradientState._shared_state.clear()
