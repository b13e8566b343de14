"""Rich tracebacks, when asked for.

Counterpart of ``accelerate_tpu/utils/rich.py``: with
``ACCELERATE_TPU_ENABLE_RICH=1`` and the ``rich`` package installed,
importing ``accelerate_tpu_torch.utils`` installs rich's traceback handler.
"""

from __future__ import annotations

import os

from .imports import is_rich_available

if os.environ.get("ACCELERATE_TPU_ENABLE_RICH", "0") == "1" and is_rich_available():
    from rich.traceback import install

    install(show_locals=False)
