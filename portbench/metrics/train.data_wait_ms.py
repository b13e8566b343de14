"""Mean ms a window update waited for its batch (``PipelineStats``'s
``data_wait_ms`` of the prepared loader)."""


def read(cell):
    return cell.counters.get("data_wait_ms")
