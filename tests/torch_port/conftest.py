"""The port's CPU tests run at tiny sizes, where torch's intra-op thread
pool buys nothing; one thread keeps them from contending for cores with the
suite's other test processes (some of which time their own steps).

The port's state singletons (``PartialState``, ``AcceleratorState``,
``GradientState``) are reset around every test, so no test sees another's
device, precision or accumulation window."""

import pytest
import torch

from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

torch.set_num_threads(1)


def _reset():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    _reset()
    yield
    _reset()
