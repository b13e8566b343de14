"""Host microseconds the engine's loop spends a decode tick on scheduling
and commits (``ServingStats``' ``host_us_per_tick``), over the window."""


def read(cell):
    s = cell.counters.get("serving") or {}
    return s.get("host_us_per_tick") if s.get("decode_ticks") else None
