"""Sizes a CPU holds, for the benchmark's tests: each cell's configuration
and parameters cut down (``overrides`` of :func:`portbench.core.make_cell`).
The program runs at float32 here, so a sound run agrees with the reference
to rounding and a planted fault stands out."""

TRAIN = {"config": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                    "num_key_value_heads": 2, "vocab_size": 256, "num_local_experts": 4},
         "params": {"rows": 2, "seq_len": 64, "doc_median": 16, "doc_min": 4, "doc_max": 64,
                    "precision": "no"}}

SERVE = {"config": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                    "num_key_value_heads": 2, "vocab_size": 256, "num_hidden_layers": 2,
                    "sliding_window": 48},
         "params": {"engine": {"max_slots": 4, "max_len": 96, "prefill_chunk": 16,
                               "prefix_cache_mb": 1, "max_queued": 256},
                    "dtype": "float32", "rate": 8.0, "warmup_s": 0.5, "first_token_wait_s": 10,
                    "drain_s": 10, "prompt": {"median": 24, "sigma": 0.7, "min": 4, "max": 64},
                    "output": {"median": 8, "sigma": 0.7, "min": 2, "max": 32}}}

TINY = {"mixtral-train-packed4k": TRAIN, "mistral-serve-chat": SERVE}


def with_params(base: dict, **params) -> dict:
    """``base`` with more parameter overrides."""
    return {"config": base["config"], "params": {**base["params"], **params}}
