"""Mean ms from submit to a slot of the requests admitted in the window
(``ServingStats``' ``queue_wait_ms``)."""


def read(cell):
    s = cell.counters.get("serving") or {}
    return s.get("queue_wait_ms") if s.get("requests_admitted") else None
