"""The launch configuration file.

Counterpart of ``accelerate_tpu/commands/config/config_args.py``:
``ClusterConfig`` with the JAX package's fields (so either package reads
the other's file), ``load_config_from_file``, ``default_config_file`` and
``migrate_reference_config`` (a Hugging Face Accelerate config translated
to this schema). ``accelerate-tpu-torch launch`` merges its flags into the
file's values and hands them to the processes as ``ACCELERATE_TPU_*``
variables. The file is flat ``key: value`` YAML; it is read with PyYAML
where installed and with a flat reader otherwise, and written without it.
The mesh fields lay the processes out over a mesh (``parallel/mesh.py``):
``launch`` passes them on as ``ACCELERATE_TPU_MESH_*``; an ``fsdp`` axis
above 1 asks for FSDP over it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

default_config_dir = Path(
    os.environ.get("ACCELERATE_TPU_CONFIG_DIR",
                   Path.home() / ".cache" / "accelerate_tpu_torch"))


def default_config_file() -> Path:
    return default_config_dir / "default_config.yaml"


#: Keys only a Hugging Face Accelerate config has: a file holding one goes
#: through :func:`migrate_reference_config`.
_REFERENCE_MARKERS = frozenset({
    "distributed_type", "use_cpu", "downcast_bf16", "deepspeed_config", "fsdp_config",
    "megatron_lm_config", "dynamo_config", "fp8_config", "gpu_ids", "tpu_use_cluster",
    "main_training_function", "fp16",
})


def migrate_reference_config(data: dict) -> tuple:
    """A Hugging Face Accelerate config as ``(ours, dropped, notes)``: the
    keys this schema has, the ones it cannot take, and notes on what was
    translated. SageMaker configs raise."""
    ours: dict = {}
    dropped: dict = {}
    notes: list = []
    if str(data.get("compute_environment", "LOCAL_MACHINE")) == "AMAZON_SAGEMAKER":
        raise ValueError("SageMaker configs are not supported")
    dist = str(data.get("distributed_type", "NO"))
    copied = ("mixed_precision", "num_machines", "machine_rank", "main_process_ip",
              "main_process_port", "debug")
    for key in copied:
        if data.get(key) is not None:
            ours[key] = data[key]
    if "fp16" in data:
        ours["mixed_precision"] = "fp16" if data["fp16"] else "no"
        notes.append("legacy 'fp16' key -> mixed_precision")
    if str(ours.get("mixed_precision", "no")) == "fp8":
        ours["mixed_precision"] = "bf16"
        notes.append("mixed_precision fp8 -> bf16: the fp8 path is not ported (ROADMAP.md, A9)")
    if data.get("use_cpu"):
        ours["use_cpu_emulation"] = True
        notes.append("use_cpu -> use_cpu_emulation (processes on the CPU over gloo)")
    mega = data.get("megatron_lm_config") or {}
    if mega:
        tp = mega.get("megatron_lm_tp_degree", mega.get("tp_degree"))
        pp = mega.get("megatron_lm_pp_degree", mega.get("pp_degree"))
        if tp:
            ours["mesh_tp"] = int(tp)
        if pp:
            ours["mesh_pp"] = int(pp)
        notes.append("megatron_lm tp/pp degrees -> mesh_tp/mesh_pp")
    ds = data.get("deepspeed_config") or {}
    fsdp = data.get("fsdp_config") or {}
    if fsdp or dist == "FSDP" or int(ds.get("zero_stage") or 0) >= 1:
        ours["mesh_fsdp"] = -1
        ours["mesh_dp"] = 1
        notes.append("FSDP/ZeRO sharding -> mesh_fsdp: -1 (FSDP over every process; the "
                     "plugin's options come from the FSDP_* variables)")
    if data.get("num_processes") is not None:
        notes.append("num_processes dropped: pass --num_processes to launch")
    handled = set(copied) | {"fp16", "use_cpu", "compute_environment", "distributed_type",
                             "megatron_lm_config", "deepspeed_config", "fsdp_config"}
    for key, value in data.items():
        if key not in handled:
            dropped[key] = value
    return ours, dropped, notes


def _scalar(text: str):
    """One flat-YAML value: JSON where it parses (numbers, true/false,
    null, quoted strings), else the bare string."""
    text = text.strip()
    if text in ("~", ""):
        return None
    if text in ("True", "False"):
        return text == "True"
    try:
        return json.loads(text)
    except ValueError:
        return text.strip("'")


def _read_yaml(text: str) -> dict:
    try:
        import yaml
    except ImportError:
        out = {}
        for line in text.splitlines():
            line = line.split(" #")[0].rstrip()
            if not line or line.lstrip().startswith("#") or ":" not in line:
                continue
            key, _, value = line.partition(":")
            out[key.strip()] = _scalar(value)
        return out
    return yaml.safe_load(text) or {}


def load_config_from_file(config_file: Optional[str] = None) -> "ClusterConfig":
    """The configuration in ``config_file`` (YAML, or JSON by suffix), else
    in the default file, else the defaults. A Hugging Face Accelerate
    config is translated (:func:`migrate_reference_config`): its notes go
    to ``cfg.migration_notes``, keys this schema lacks to ``cfg.extra``."""
    path = Path(config_file) if config_file else default_config_file()
    if not path.exists():
        if config_file:
            raise FileNotFoundError(f"Config file {path} not found")
        return ClusterConfig()
    text = path.read_text()
    data = (json.loads(text) if path.suffix == ".json" else _read_yaml(text)) or {}
    notes: list = []
    if _REFERENCE_MARKERS & set(data):
        data, dropped, notes = migrate_reference_config(data)
        data = {**data, **dropped}
    known = {f.name for f in dataclasses.fields(ClusterConfig)}
    cfg = ClusterConfig(**{k: v for k, v in data.items() if k in known and k != "extra"})
    cfg.extra = {k: v for k, v in data.items() if k not in known}
    cfg.migration_notes = notes
    return cfg


@dataclass
class ClusterConfig:
    """Where and how ``launch`` runs a script: precision, debug checks,
    the machines (``num_machines``, this one's ``machine_rank``, the main
    machine's ``main_process_ip``/``main_process_port``), and
    ``use_cpu_emulation`` (processes on the CPU over gloo). The mesh and
    TPU fields are the JAX package's, kept so the files interchange."""

    compute_environment: str = "LOCAL_MACHINE"
    mixed_precision: str = "no"
    debug: bool = False
    mesh_dp: int = -1
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    mesh_cp: int = 1
    mesh_ep: int = 1
    mesh_pp: int = 1
    mesh_dcn_axis: str = "dp"
    num_machines: int = 1
    machine_rank: int = 0
    main_process_ip: Optional[str] = None
    main_process_port: int = 8476
    tpu_name: Optional[str] = None
    tpu_zone: Optional[str] = None
    use_cpu_emulation: bool = False
    emulated_device_count: int = 1
    extra: dict = field(default_factory=dict, repr=False)

    migration_notes = ()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("extra", None)
        return {k: v for k, v in d.items() if v is not None}

    def mesh_axes(self) -> dict:
        """The mesh axes that differ from ``MeshConfig``'s defaults (dp -1,
        the rest 1), by name; an axis of -1 other than dp makes dp 1."""
        sizes = {ax: getattr(self, f"mesh_{ax}") for ax in ("dp", "fsdp", "tp", "cp", "ep", "pp")}
        if sizes["dp"] in (None, -1) and any(v == -1 for ax, v in sizes.items() if ax != "dp"):
            sizes["dp"] = 1
        defaults = {"dp": -1}
        return {ax: int(v) for ax, v in sizes.items()
                if v not in (None, 0) and v != defaults.get(ax, 1)}

    def save(self, config_file: Optional[str] = None) -> Path:
        """Write the file (JSON by suffix, else flat YAML); returns its path."""
        path = Path(config_file) if config_file else default_config_file()
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.suffix == ".json":
            path.write_text(json.dumps(self.to_dict(), indent=2))
        else:
            path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                                    for k, v in sorted(self.to_dict().items())))
        return path

    def launch_env(self) -> dict:
        """The variables the launched processes read (``state.py``)."""
        from ...utils.environment import env_var

        env = {env_var("MIXED_PRECISION"): self.mixed_precision}
        for axis, value in self.mesh_axes().items():
            env[env_var(f"MESH_{axis.upper()}")] = str(value)
        if self.debug:
            env[env_var("DEBUG")] = "true"
        if self.use_cpu_emulation:
            env[env_var("USE_CPU")] = "true"
        return env
