"""Test helpers (counterpart of ``accelerate_tpu/test_utils/__init__.py``):
skip decorators for the card and for process groups, ``slow``, the
singleton-resetting ``AccelerateTestCase``, ``assert_allclose_tree`` and
the regression fixture of ``training.py``. The multi-process checks live
in ``scripts/`` so that ``launch`` can run them in several processes."""

from __future__ import annotations

import os
import unittest

from .training import RegressionData, RegressionModel, init_mlp, mlp_apply, mse_loss  # noqa: F401


def require_cuda(test_case):
    """Skip unless a CUDA card is visible (the JAX package's
    ``require_tpu``)."""
    import torch

    return unittest.skipUnless(torch.cuda.is_available(), "test requires a CUDA card")(test_case)


def require_multi_device(test_case):
    """Skip unless more than one CUDA card is visible."""
    import torch

    return unittest.skipUnless(torch.cuda.device_count() > 1,
                               "test requires several CUDA cards")(test_case)


def require_multi_process(test_case):
    """Skip unless this process belongs to a process group of several."""
    from ..utils.imports import is_multi_host

    return unittest.skipUnless(is_multi_host(), "test requires several processes")(test_case)


def require_transformers(test_case):
    from ..utils.imports import is_transformers_available

    return unittest.skipUnless(is_transformers_available(),
                               "test requires transformers")(test_case)


class AccelerateTestCase(unittest.TestCase):
    """Resets the state singletons after each test."""

    def tearDown(self):
        super().tearDown()
        from ..state import AcceleratorState, GradientState

        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()


def slow(test_case):
    """Run only with ``RUN_SLOW=1``."""
    return unittest.skipUnless(os.environ.get("RUN_SLOW", "0") == "1",
                               "test is slow; set RUN_SLOW=1")(test_case)


def assert_allclose_tree(a, b, rtol=1e-5, atol=1e-6):
    """Every leaf of two nested dicts/lists of tensors or arrays close."""
    import numpy as np
    import torch

    from ..utils.operations import _leaves

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb), f"{len(la)} leaves against {len(lb)}"
    for pa, pb in zip(la, lb):
        np.testing.assert_allclose(host(pa), host(pb), rtol=rtol, atol=atol)
