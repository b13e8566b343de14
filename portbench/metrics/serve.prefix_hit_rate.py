"""Share of the prefix cache's lookup chunks that it restored
(``ServingStats``' hit chunks over lookup chunks), over the window."""


def read(cell):
    s = cell.counters.get("serving") or {}
    lookups = cell.counters.get("prefix_lookup_chunks")
    if not lookups:
        return None
    return 100.0 * s["prefix_cache_hit_chunks"] / lookups
