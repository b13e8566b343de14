"""Device ms of a prefill chunk step (a replay of the engine's ``chunk``
graph: ``prefill_chunk`` tokens of one prompt through the model and the
cache), between the CUDA events the benchmark records
before and after each step on the engine's stream in the traced seconds."""


def read(cell):
    spans = (cell.counters.get("step_device_ms") or {}).get("chunk")
    if cell.device.type != "cuda" or not spans:
        return None
    return sum(spans) / len(spans)
