"""The whole decode tick's share of its roofline: the least time of the
mean traced tick's work (every active slot's token through the products,
its attention over its live keys; the bf16 weights read once and the live
tokens' K/V, not the slots' whole ``max_len``) over the mean decode step's
device time. Active slots and live tokens at each traced decode step come
from the client's own record of the streams."""

from portbench.yardstick import decode_tick_work, roofline_seconds


def read(cell):
    spans = (cell.counters.get("step_device_ms") or {}).get("decode")
    slots = cell.counters.get("decode_slots")
    if cell.device.type != "cuda" or not spans or not slots:
        return None
    ops, nbytes = decode_tick_work(cell.config, slots, cell.counters["decode_live_tokens"])
    return 100.0 * roofline_seconds(ops, nbytes) / (sum(spans) / len(spans) / 1e3)
