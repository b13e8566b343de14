"""A progress bar shown by one process.

Counterpart of ``accelerate_tpu/utils/tqdm.py``: ``tqdm(main_process_only=
True, ...)`` draws only on the main process, so a launch of N processes
prints one bar.
"""

from __future__ import annotations

from .imports import is_tqdm_available


def tqdm(*args, main_process_only: bool = True, **kwargs):
    """``tqdm.auto.tqdm``, disabled on every process but the main one; a
    ``disable`` the caller passes wins."""
    if not is_tqdm_available():
        raise ImportError("accelerate_tpu_torch.utils.tqdm needs the tqdm package; install it "
                          "or iterate without a progress bar.")
    from tqdm.auto import tqdm as _tqdm

    if main_process_only and "disable" not in kwargs:
        from ..state import PartialState

        kwargs["disable"] = not PartialState().is_main_process
    return _tqdm(*args, **kwargs)
