"""Version comparisons.

Counterpart of ``accelerate_tpu/utils/versions.py``: ``compare_versions``,
and ``is_torch_version`` in place of the JAX and flax ones. ``packaging``
is used where installed, else the copy torch carries.
"""

from __future__ import annotations

import importlib.metadata
import operator as op

try:
    from packaging.version import Version, parse
except ImportError:  # torch vendors packaging
    from torch._vendor.packaging.version import Version, parse

STR_OPERATION_TO_FUNC = {">": op.gt, ">=": op.ge, "==": op.eq, "!=": op.ne, "<=": op.le,
                         "<": op.lt}


def compare_versions(library_or_version, operation: str, requirement_version: str) -> bool:
    """``library_or_version`` (an installed package's name, or a parsed
    ``Version``) ``operation`` (one of > >= == != <= <) ``requirement_version``."""
    if operation not in STR_OPERATION_TO_FUNC:
        raise ValueError(f"`operation` must be one of {list(STR_OPERATION_TO_FUNC)}, "
                         f"received {operation}")
    if isinstance(library_or_version, str):
        library_or_version = parse(importlib.metadata.version(library_or_version))
    return STR_OPERATION_TO_FUNC[operation](library_or_version, parse(requirement_version))


def is_torch_version(operation: str, version: str) -> bool:
    """The installed torch's release (local tags such as ``+cpu`` dropped)
    against ``version``."""
    import torch

    return compare_versions(Version(parse(torch.__version__).base_version), operation, version)
