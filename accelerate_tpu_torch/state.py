"""Process, accelerator and gradient-accumulation state, as singletons.

Counterpart of ``accelerate_tpu/state.py``: ``PartialState`` (``:89``),
``AcceleratorState`` (``:354``) and ``GradientState`` (``:499``), each a
Borg (every instance shares one ``__dict__``), so any module can read the
same state. Tests reset the singletons between cases with ``_reset_state``.

The JAX package runs one process a host and joins hosts with
``jax.distributed``; torch runs one process a device and joins them in a
process group (``torch.distributed``). ``PartialState`` builds that group
when the environment describes a world: the launcher's
``ACCELERATE_TPU_COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``
(the names of the JAX launcher, ``commands/launch.py``), or torchrun's
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT``. The backend follows the device: NCCL on the card
(``cuda:<local rank>``), gloo on the CPU (``cpu=True`` or the launcher's
``--use_cpu_emulation``). A failed rendezvous raises; nothing falls back to
one process.
"""

from __future__ import annotations

import atexit
import os
from contextlib import contextmanager
from functools import partial, wraps
from typing import Any, Callable, Optional

import numpy as np
import torch

from .utils.dataclasses import DistributedInitKwargs, DistributedType, GradientAccumulationPlugin
from .utils.device import resolve_device
from .utils.environment import env_var, parse_flag_from_env

PRECISIONS = ("no", "fp32", "bf16", "fp16", "fp8")


def is_main_process() -> bool:
    """Whether this process is the main one, without building the state
    (loggers and trackers ask before any device is chosen): the index of
    the constructed state, else that of the one process there is."""
    return PartialState._shared_state.get("process_index", 0) == 0


def is_initialized() -> bool:
    """Whether a ``PartialState`` has been constructed."""
    return PartialState._shared_state != {}


def current_mesh(mesh=None):
    """The ambient device mesh, or None: an explicit ``mesh``, else the
    innermost ``with mesh:`` block's, else ``AcceleratorState().mesh``
    (reference ``accelerate_tpu/state.py:50-86``). Every mesh-aware layer
    (tensor parallelism, ring attention, the pipeline) resolves it here."""
    if mesh is not None:
        return mesh
    from .parallel.mesh import entered_mesh

    entered = entered_mesh()
    if entered is not None:
        return entered
    if AcceleratorState._shared_state:
        return AcceleratorState._shared_state.get("mesh")
    return None


def _world_from_env(init: DistributedInitKwargs) -> Optional[dict]:
    """The process group the environment (or ``init``) describes:
    ``{"address", "world", "rank", "local_rank"}``, or None for a lone
    process."""
    coordinator = init.coordinator_address or os.environ.get(env_var("COORDINATOR_ADDRESS"))
    if coordinator is not None:
        world = init.num_processes or os.environ.get(env_var("NUM_PROCESSES"))
        rank = init.process_id if init.process_id is not None else \
            os.environ.get(env_var("PROCESS_ID"))
        if world is None or rank is None:
            raise ValueError(f"a coordinator address ({coordinator}) needs the world size and "
                             f"this process's rank ({env_var('NUM_PROCESSES')}, "
                             f"{env_var('PROCESS_ID')})")
        local = os.environ.get(env_var("LOCAL_PROCESS_ID"), 0)
        return {"address": coordinator, "world": int(world), "rank": int(rank),
                "local_rank": int(local)}
    if "WORLD_SIZE" in os.environ:  # torchrun
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK") if k not in os.environ]
        if missing:
            raise ValueError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} without {missing}: no "
                             "rendezvous to join (launch with accelerate-tpu-torch launch or "
                             "torchrun)")
        return {"address": f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                "world": int(os.environ["WORLD_SIZE"]), "rank": int(os.environ["RANK"]),
                "local_rank": int(os.environ.get("LOCAL_RANK", 0))}
    return None


def _leave_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class PartialState:
    """The process's view of its world: its rank among ``num_processes``,
    its device (``cuda:<local rank>`` unless ``cpu=True``; raises without a
    card otherwise) and the process group's backend. ``init_kwargs`` (a
    ``DistributedInitKwargs``) overrides what the launcher's environment
    says."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        init = kwargs.pop("init_kwargs", None) or DistributedInitKwargs()
        cpu = bool(cpu) or parse_flag_from_env(env_var("USE_CPU"))
        world = _world_from_env(init)
        if world is None:
            device = resolve_device("cpu" if cpu else None)
            state = dict(backend=device.type, num_processes=1, process_index=0,
                         local_process_index=0, distributed_type=DistributedType.NO)
        else:
            state = self._init_process_group(world, init, cpu)
            device = state.pop("device")
        # Set in one update, after everything that can raise: a failed
        # construction leaves the singleton empty.
        self._shared_state.update(
            _cpu=cpu, device=device, num_devices=1, debug=parse_flag_from_env(env_var("DEBUG")),
            fork_launched=parse_flag_from_env(env_var("FORK_LAUNCHED")), **state)

    @staticmethod
    def _init_process_group(world: dict, init: DistributedInitKwargs, cpu: bool) -> dict:
        """Join the process group (gloo on the CPU, NCCL on the card, which
        is bound first, as NCCL needs)."""
        import torch.distributed as dist

        local = world["local_rank"]
        if init.local_device_ids:
            local = int(init.local_device_ids[0])
        device = resolve_device("cpu" if cpu else f"cuda:{local}")
        backend = "gloo" if device.type == "cpu" else "nccl"
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            options = {"device_id": device} if backend == "nccl" else {}
            dist.init_process_group(
                backend, init_method=f"tcp://{world['address']}", world_size=world["world"],
                rank=world["rank"], timeout=init.initialization_timeout, **options)
            # Leaving the group at exit: NCCL warns, and can hang, otherwise.
            atexit.register(_leave_process_group)
        return dict(device=device, backend=backend, num_processes=dist.get_world_size(),
                    process_index=dist.get_rank(), local_process_index=local,
                    distributed_type=DistributedType.MULTI_GPU if backend == "nccl"
                    else DistributedType.MULTI_CPU)

    def __repr__(self):
        return (f"Distributed environment: {self.distributed_type}  Backend: {self.backend}\n"
                f"Num processes: {self.num_processes}\nProcess index: {self.process_index}\n"
                f"Local process index: {self.local_process_index}\nDevice: {self.device}\n")

    @staticmethod
    def _reset_state():
        """Forget the state and leave the process group, if one was joined."""
        if PartialState._shared_state.get("distributed_type", DistributedType.NO) \
                != DistributedType.NO:
            _leave_process_group()
        PartialState._shared_state.clear()

    @property
    def initialized(self) -> bool:
        return self._shared_state != {}

    @property
    def use_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def process_group(self) -> bool:
        """Whether this process is in a process group (possibly of one)."""
        return self.distributed_type != DistributedType.NO

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self, tag: str = "accelerate_tpu_barrier"):
        """A barrier across the process group named ``tag``; nothing to
        wait for without one. The processes exchange the tag's hash (the
        exchange is the barrier), and a process at a barrier of another
        tag raises, as the JAX package's ``sync_global_devices`` does."""
        if self.process_group:
            import zlib

            import torch.distributed as dist

            device = self.device if self.backend == "nccl" else "cpu"
            mine = torch.tensor([zlib.crc32(tag.encode())], dtype=torch.int64, device=device)
            every = [torch.empty_like(mine) for _ in range(self.num_processes)]
            dist.all_gather(every, mine)
            if len({int(t.item()) for t in every}) > 1:
                raise RuntimeError(f"wait_for_everyone tag mismatch ({tag!r}): the processes "
                                   "are at different barriers")

    def _goes_first(self, first: bool, tag: str):
        if not first:
            self.wait_for_everyone(tag + "_pre")
        yield
        if first:
            self.wait_for_everyone(tag + "_pre")
        self.wait_for_everyone(tag + "_post")

    @contextmanager
    def main_process_first(self):
        """The main process runs the block before the others."""
        yield from self._goes_first(self.is_main_process, "main_first")

    @contextmanager
    def local_main_process_first(self):
        """Each machine's main process runs the block before its others."""
        yield from self._goes_first(self.is_local_main_process, "local_main_first")

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

    def on_last_process(self, function: Callable):
        """Decorator: run only on the last process."""
        return self.on_process(function, process_index=self.num_processes - 1)

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's contiguous share of a list, tuple, dict (each
        value split) or array/tensor: the first ``len % num_processes``
        processes take one more item. With ``apply_padding`` the shorter
        shares repeat the last item, so every process holds as many (what
        ``gather`` needs): a list's with the input's last item, an array's
        with the share's last row, as in the JAX package."""
        if self.num_processes == 1:
            yield inputs
            return
        length = len(inputs) if not isinstance(inputs, dict) else len(next(iter(inputs.values())))
        per, extras = divmod(length, self.num_processes)
        start = per * self.process_index + min(self.process_index, extras)
        end = start + per + (1 if self.process_index < extras else 0)
        target = per + 1 if apply_padding and extras > 0 else None

        def split(obj):
            if isinstance(obj, dict):
                return {k: split(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                part = obj[start:end]
                while target is not None and len(part) < target:
                    part = list(part) + [obj[-1]]
                return part
            if hasattr(obj, "shape"):
                part = obj[start:end]
                short = 0 if target is None else target - part.shape[0]
                if short > 0 and isinstance(obj, torch.Tensor):
                    part = torch.cat([part, part[-1:].expand(short, *obj.shape[1:])])
                elif short > 0:
                    part = np.concatenate([part, np.repeat(part[-1:], short, axis=0)])
                return part
            return obj

        yield split(inputs)

    def print(self, *args, **kwargs):
        if self.is_main_process:
            print(*args, **kwargs)

    def destroy_process_group(self):
        """Leave the process group (the state keeps its values)."""
        if self.process_group:
            _leave_process_group()

    def set_device(self):
        """Make this process's card the current one (NCCL's collectives on
        objects use it)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)


class AcceleratorState:
    """``PartialState`` plus the mixed-precision mode, the parallelism
    plugins and the mesh (reference ``accelerate_tpu/state.py:354-462``).
    Constructing it again with another mode raises, as in the JAX package,
    and so does asking for another device (``cpu``): the device is the
    process's. ``None`` (the default of both) takes what is there; a first
    ``None`` mode reads ``ACCELERATE_TPU_MIXED_PRECISION`` (the launcher
    sets it), else "no".

    A ``deepspeed_plugin`` is translated onto ``fsdp_plugin``
    (``DeepSpeedPlugin.to_fsdp_plugin``) unless one is given, and a
    ``megatron_lm_plugin`` onto the tp, pp and FSDP plugins it implies.
    ``mesh`` is ``mesh_config`` (default ``MeshConfig.from_env()``, the
    launcher's ``--dp/--fsdp/--tp/--cp/--pp/--ep``) over the process group:
    an FSDP plugin on a mesh that names neither ``fsdp`` nor ``dp`` shards
    over every process; an ``fsdp`` axis above 1 without a plugin implies
    the default one; a plugin's ``tp_size``/``cp_size``/``pp_size``/
    ``ep_size`` above 1 sets its axis (``ep_plugin``: an
    ``ExpertParallelPlugin``, MoE expert parallelism). ``distributed_type``
    is ``DEEPSPEED``, ``MEGATRON_LM``, ``FSDP``, ``TENSOR_PARALLEL`` or ``PIPELINE_PARALLEL`` after the
    governing plugin, else the process's."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: Optional[bool] = None,
                 mesh_config=None, fsdp_plugin=None, tp_plugin=None, cp_plugin=None,
                 pp_plugin=None, ep_plugin=None, deepspeed_plugin=None, megatron_lm_plugin=None,
                 **kwargs):
        self.__dict__ = self._shared_state
        process = PartialState._shared_state
        if cpu is not None:
            cpu = bool(cpu) or parse_flag_from_env(env_var("USE_CPU"))
        if cpu is not None and process and cpu != process["_cpu"]:
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
        if deepspeed_plugin is not None and fsdp_plugin is None:
            fsdp_plugin = deepspeed_plugin.to_fsdp_plugin()
        if megatron_lm_plugin is not None:
            mtp, mpp, mfsdp = megatron_lm_plugin.to_plugins()
            tp_plugin = tp_plugin or mtp
            pp_plugin = pp_plugin or mpp
            fsdp_plugin = fsdp_plugin or mfsdp
        import copy

        from .parallel.mesh import MeshConfig

        mesh_config = copy.copy(mesh_config) if mesh_config is not None else MeshConfig.from_env()
        if fsdp_plugin is not None and mesh_config.fsdp == 1 and mesh_config.dp == -1:
            mesh_config.fsdp, mesh_config.dp = -1, 1  # FSDP shards over every process
        if fsdp_plugin is None and mesh_config.fsdp not in (0, 1):
            from .utils.dataclasses import FullyShardedDataParallelPlugin

            fsdp_plugin = FullyShardedDataParallelPlugin()
        for plugin, axis, field in ((tp_plugin, "tp", "tp_size"), (cp_plugin, "cp", "cp_size"),
                                    (pp_plugin, "pp", "pp_size"), (ep_plugin, "ep", "ep_size")):
            if plugin is not None and getattr(plugin, field) > 1:
                setattr(mesh_config, axis, getattr(plugin, field))
        mesh = mesh_config.build()
        distributed_type = partial_state.distributed_type
        if deepspeed_plugin is not None:
            distributed_type = DistributedType.DEEPSPEED
        elif megatron_lm_plugin is not None:
            distributed_type = DistributedType.MEGATRON_LM
        elif fsdp_plugin is not None:
            distributed_type = DistributedType.FSDP
        elif mesh.shape["tp"] > 1:
            distributed_type = DistributedType.TENSOR_PARALLEL
        elif mesh.shape["pp"] > 1:
            distributed_type = DistributedType.PIPELINE_PARALLEL
        self._shared_state.update(_partial=partial_state, mixed_precision=mixed_precision,
                                  fsdp_plugin=fsdp_plugin, deepspeed_plugin=deepspeed_plugin,
                                  tp_plugin=tp_plugin, cp_plugin=cp_plugin, pp_plugin=pp_plugin,
                                  ep_plugin=ep_plugin, megatron_lm_plugin=megatron_lm_plugin,
                                  mesh_config=mesh_config, mesh=mesh,
                                  distributed_type=distributed_type)

    def __repr__(self):
        return PartialState().__repr__() + f"Mixed precision type: {self.mixed_precision}\n"

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
