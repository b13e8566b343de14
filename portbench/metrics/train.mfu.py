"""The whole step's share of the card's bf16 peak: model FLOPs a token (no
recompute: 6 x the active matmul parameters, plus attention over the
visible keys) times the window's ``train_tokens_per_s``, over 989 TFLOP/s."""

from portbench.yardstick import PEAK_BF16_FLOPS, train_flops_per_token


def read(cell):
    rate = cell.counters.get("train_tokens_per_s")
    if cell.device.type != "cuda" or not rate:
        return None
    flops = train_flops_per_token(cell.config, cell.params["seq_len"],
                                  cell.config.get("sliding_window"))
    return 100.0 * flops * rate / PEAK_BF16_FLOPS
