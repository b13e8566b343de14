"""Whether an optional package, or a device, is there.

Counterpart of ``accelerate_tpu/utils/imports.py`` for the torch stack.
The JAX package's platform probes (TPU, Pallas) have CUDA counterparts
here: ``is_cuda_available``, ``is_gpu_available``, ``is_cpu_only``,
``is_multi_host`` (a process group of more than one process),
``is_nvcc_available`` and ``is_triton_available``. Package probes look the
package up without importing it.
"""

from __future__ import annotations

import importlib.metadata
import importlib.util
import os
import shutil
from functools import lru_cache


def _is_package_available(pkg_name: str, metadata_name: str | None = None) -> bool:
    exists = importlib.util.find_spec(pkg_name) is not None
    if exists and metadata_name is not None:
        try:
            importlib.metadata.metadata(metadata_name)
        except importlib.metadata.PackageNotFoundError:
            return False
    return exists


@lru_cache(maxsize=None)
def is_torch_available() -> bool:
    return _is_package_available("torch")


@lru_cache(maxsize=None)
def is_safetensors_available() -> bool:
    return _is_package_available("safetensors")


@lru_cache(maxsize=None)
def is_transformers_available() -> bool:
    return _is_package_available("transformers")


@lru_cache(maxsize=None)
def is_datasets_available() -> bool:
    return _is_package_available("datasets")


@lru_cache(maxsize=None)
def is_einops_available() -> bool:
    return _is_package_available("einops")


@lru_cache(maxsize=None)
def is_pandas_available() -> bool:
    return _is_package_available("pandas")


@lru_cache(maxsize=None)
def is_rich_available() -> bool:
    return _is_package_available("rich")


@lru_cache(maxsize=None)
def is_tqdm_available() -> bool:
    return _is_package_available("tqdm")


def is_ipython_available() -> bool:
    return _is_package_available("IPython")


def is_notebook() -> bool:
    """Inside a Jupyter kernel (``notebook_launcher`` asks)."""
    if not is_ipython_available():
        return False
    try:
        from IPython import get_ipython

        ip = get_ipython()
        return ip is not None and "IPKernelApp" in getattr(ip, "config", {})
    except Exception:
        return False


# Trackers.

@lru_cache(maxsize=None)
def is_tensorboard_available() -> bool:
    return _is_package_available("tensorboardX") or _is_package_available("tensorboard")


@lru_cache(maxsize=None)
def is_wandb_available() -> bool:
    return _is_package_available("wandb")


@lru_cache(maxsize=None)
def is_comet_ml_available() -> bool:
    return _is_package_available("comet_ml")


@lru_cache(maxsize=None)
def is_mlflow_available() -> bool:
    return _is_package_available("mlflow")


@lru_cache(maxsize=None)
def is_aim_available() -> bool:
    return _is_package_available("aim")


@lru_cache(maxsize=None)
def is_clearml_available() -> bool:
    return _is_package_available("clearml")


@lru_cache(maxsize=None)
def is_dvclive_available() -> bool:
    return _is_package_available("dvclive")


@lru_cache(maxsize=None)
def is_boto3_available() -> bool:
    return _is_package_available("boto3")


# Devices and toolchains.

def is_cuda_available() -> bool:
    """A CUDA card is visible to torch."""
    import torch

    return torch.cuda.is_available()


def is_gpu_available() -> bool:
    return is_cuda_available()


def is_cpu_only() -> bool:
    return not is_cuda_available()


def is_multi_host() -> bool:
    """This process belongs to a process group of more than one process."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def is_nvcc_available() -> bool:
    """``nvcc`` is on the ``PATH`` or under ``CUDA_HOME`` (default
    ``/usr/local/cuda``): the port's CUDA kernels can be built."""
    if shutil.which("nvcc"):
        return True
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.exists(os.path.join(home, "bin", "nvcc"))


@lru_cache(maxsize=None)
def is_triton_available() -> bool:
    return _is_package_available("triton")
