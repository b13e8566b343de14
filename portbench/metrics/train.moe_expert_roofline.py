"""The MoE experts' batched products (``ops/moe.py``'s ``torch.bmm``)
against their roofline: the least time the kept (token, expert) pairs'
products need, forward and backward, over the device time of the kernels
``aten::bmm`` launched in the traced updates. Capacity padding is not
work."""

from portbench.metrics._readers import card_trace
from portbench.yardstick import moe_expert_bytes, moe_expert_ops, roofline_seconds


def read(cell):
    trace = card_trace(cell)
    kept = cell.counters.get("kept_pairs")
    if trace is None or not kept:
        return None
    kernels = trace.kernels_of_op("aten::bmm")
    if not kernels:
        return None
    cfg = cell.config
    D, F, E = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_local_experts"]
    passes = cell.counters["traced_steps"] * cfg["num_hidden_layers"]
    bound = roofline_seconds(moe_expert_ops(kept, D, F), moe_expert_bytes(E, D, F, 2) * passes)
    return 100.0 * bound / (trace.total_us(kernels) / 1e6)
