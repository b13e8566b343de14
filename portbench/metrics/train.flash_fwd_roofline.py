"""The flash attention forward kernel (``ops/flash_cuda.py``:
``flash_fwd_sm90_kernel``, or ``flash_fwd_kernel`` on the other route)
against its roofline: each launch's least time (4 x B x H x head width x
the visible pairs of these rows, or its bytes) over the kernels' time."""

from portbench.metrics._readers import attention_shape, card_trace
from portbench.yardstick import (attention_bytes, flash_forward_ops, roofline_seconds,
                                 visible_pairs)


def read(cell):
    trace = card_trace(cell)
    if trace is None:
        return None
    kernels = trace.kernels_named("flash_fwd_sm90_kernel", "flash_fwd_kernel")
    if not kernels:
        return None
    a = attention_shape(cell)
    ops = flash_forward_ops(a["B"], a["H"], a["hd"], visible_pairs(a["S"], a["window"]))
    nbytes = attention_bytes(a["B"], a["S"], a["H"], a["G"], a["hd"], 2, backward=False)
    return 100.0 * len(kernels) * roofline_seconds(ops, nbytes) / (trace.total_us(kernels) / 1e6)
