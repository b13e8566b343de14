"""Device ms a window update spends from the start of the clip to the end
of ``zero_grad`` (``Accelerator.clip_grad_norm_``,
``AcceleratedOptimizer.step``), by CUDA events the benchmark records
around them."""


def read(cell):
    if cell.device.type != "cuda":
        return None
    return cell.counters.get("optimizer_ms")
