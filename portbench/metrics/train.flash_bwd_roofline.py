"""The flash attention backward kernels (``flash_bwd_dkdv_sm90_kernel``
and ``flash_bwd_dq_sm90_kernel``, or the other route's) against their
roofline: each backward's least time ((8 + 6) x B x H x head width x the
visible pairs, or its bytes) over the two kernels' time."""

from portbench.metrics._readers import attention_shape, card_trace
from portbench.yardstick import (attention_bytes, flash_backward_ops, roofline_seconds,
                                 visible_pairs)


def read(cell):
    trace = card_trace(cell)
    if trace is None:
        return None
    dkdv = trace.kernels_named("flash_bwd_dkdv_sm90_kernel", "flash_bwd_dkdv_kernel")
    dq = trace.kernels_named("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_kernel")
    if not dkdv or len(dkdv) != len(dq):
        return None
    a = attention_shape(cell)
    ops = flash_backward_ops(a["B"], a["H"], a["hd"], visible_pairs(a["S"], a["window"]))
    nbytes = attention_bytes(a["B"], a["S"], a["H"], a["G"], a["hd"], 2, backward=True)
    seconds = (trace.total_us(dkdv) + trace.total_us(dq)) / 1e6
    return 100.0 * len(dkdv) * roofline_seconds(ops, nbytes) / seconds
