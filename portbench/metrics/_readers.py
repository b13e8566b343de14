"""What the per-layer metric readers share: the device trace of a run on
the card (None elsewhere: a CPU run gives no device number) and the
attention shape of a training cell's rows."""

from __future__ import annotations


def card_trace(cell):
    """The traced sub-window's :class:`~portbench.trace.Trace`, when the
    run was on the card and its trace holds kernels."""
    if cell.device.type != "cuda" or cell.device_trace is None:
        return None
    return cell.device_trace if cell.device_trace.kernels() else None


def attention_shape(cell) -> dict:
    """Batch, sequence, heads, key heads and head width of a training
    cell's attention calls."""
    cfg = cell.config
    H = cfg["num_attention_heads"]
    return dict(B=cell.params["rows"], S=cell.params["seq_len"], H=H,
                G=cfg["num_key_value_heads"], hd=cfg["hidden_size"] // H,
                window=cfg.get("sliding_window"))
