"""Device ms of a decode step (a replay of the engine's ``decode`` graph:
the projections and ``models/llama.py``'s cached attention), between the CUDA events the benchmark records
before and after each step on the engine's stream in the traced seconds."""


def read(cell):
    spans = (cell.counters.get("step_device_ms") or {}).get("decode")
    if cell.device.type != "cuda" or not spans:
        return None
    return sum(spans) / len(spans)
