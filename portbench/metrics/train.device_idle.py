"""Share of the traced updates' window with nothing on the device."""

from portbench.metrics._readers import card_trace


def read(cell):
    trace = card_trace(cell)
    return None if trace is None else trace.idle_share()
