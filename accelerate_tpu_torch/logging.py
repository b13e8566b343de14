"""Process-aware logging.

Counterpart of ``accelerate_tpu/logging.py``: ``MultiProcessAdapter`` and
``get_logger``. Every log call takes ``main_process_only`` (default True)
and ``in_order``; on one process every record is the main process's.
``ACCELERATE_TPU_DISABLE_LOGGING`` silences the adapter and
``ACCELERATE_TPU_LOG_LEVEL`` sets the level, as in the JAX package.
"""

from __future__ import annotations

import functools
import logging
import os


class MultiProcessAdapter(logging.LoggerAdapter):
    """Logs on the main process unless ``main_process_only=False``; with
    ``in_order=True`` the processes log one after another."""

    @staticmethod
    def _should_log(main_process_only):
        from .state import is_main_process

        return not main_process_only or is_main_process()

    def log(self, level, msg, *args, **kwargs):
        if os.environ.get("ACCELERATE_TPU_DISABLE_LOGGING", "false").lower() in ("1", "true"):
            return
        from .state import PartialState

        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        kwargs.setdefault("stacklevel", 2)
        if not self.isEnabledFor(level):
            return
        if self._should_log(main_process_only):
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)
        elif in_order:
            state = PartialState()
            for i in range(state.num_processes):
                if i == state.process_index:
                    msg, kwargs = self.process(msg, kwargs)
                    self.logger.log(level, msg, *args, **kwargs)
                state.wait_for_everyone()

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        """A warning once per distinct message."""
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """The process-aware logger of ``name``."""
    logger = logging.getLogger(name)
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_TPU_LOG_LEVEL", None)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
