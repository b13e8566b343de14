"""The benchmark's frozen yardstick: the card's peaks, the arrival schedule
and percentile it times requests by, and the operation and byte counts its
roofline and utilisation metrics divide by.

Nothing here imports the program. ``ArrivalSchedule`` and ``percentile``
are copies of ``accelerate_tpu_torch/loadgen/generator.py`` and
``loadgen/report.py`` (a test holds them equal on fixed seeds); the copy of
the schedule adds one distribution, ``"exponential"`` (Poisson arrivals).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

#: Dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet), FLOP/s.
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet), bytes/s.
PEAK_HBM_BYTES = 3.35e12


class ArrivalSchedule:
    """Seeded open-loop arrival plan: ``n`` streams, inter-arrival times
    drawn from a heavy-tailed (or uniform, or exponential) distribution
    with a target mean, cumulated into arrival offsets starting at zero.

    Args:
      n: number of streams.
      mean_interarrival_s: target mean gap between consecutive arrivals.
      dist: ``"lognormal"`` (default), ``"pareto"``, ``"uniform"`` or
        ``"exponential"`` (a Poisson process).
      sigma: lognormal log-space sigma (burstiness; 0 -> near-constant).
      alpha: Pareto tail index (> 1).
      seed: RNG seed; the same seed always yields the same schedule.
    """

    DISTS = ("lognormal", "pareto", "uniform", "exponential")

    def __init__(self, n: int, mean_interarrival_s: float, *,
                 dist: str = "lognormal", sigma: float = 1.0,
                 alpha: float = 1.5, seed: int = 0):
        if n < 1:
            raise ValueError("n must be >= 1")
        if mean_interarrival_s <= 0:
            raise ValueError("mean_interarrival_s must be > 0")
        if dist not in self.DISTS:
            raise ValueError(f"dist must be one of {self.DISTS} "
                             f"(got {dist!r})")
        if alpha <= 1:
            raise ValueError("alpha must be > 1 (finite-mean Pareto)")
        self.n = int(n)
        self.mean_interarrival_s = float(mean_interarrival_s)
        self.dist = dist
        self.sigma = float(sigma)
        self.alpha = float(alpha)
        self.seed = int(seed)
        rng = np.random.default_rng(seed)
        m = self.mean_interarrival_s
        if dist == "lognormal":
            mu = np.log(m) - self.sigma ** 2 / 2.0
            gaps = rng.lognormal(mu, self.sigma, size=n)
        elif dist == "pareto":
            xm = m * (self.alpha - 1.0) / self.alpha
            gaps = (rng.pareto(self.alpha, size=n) + 1.0) * xm
        elif dist == "uniform":
            gaps = rng.uniform(0.0, 2.0 * m, size=n)
        else:
            gaps = rng.exponential(m, size=n)
        gaps[0] = 0.0  # first arrival defines t=0
        self._offsets = np.cumsum(gaps)

    def offsets(self) -> np.ndarray:
        """Arrival offsets in seconds from run start, ascending,
        ``offsets()[0] == 0``."""
        return self._offsets.copy()


def percentile(values, q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]) tolerant of ``inf``
    entries; returns None for an empty list and ``inf`` stays ``inf``."""
    vals = sorted(values)
    if not vals:
        return None
    if not 0 <= q <= 100:
        raise ValueError("q must be in [0, 100]")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return float(vals[rank - 1])


def lognormal_lengths(n: int, median: float, sigma: float, low: int, high: int,
                      rng: np.random.Generator) -> np.ndarray:
    """``n`` integer lengths, lognormal around ``median`` with log-space
    ``sigma``, clipped into ``[low, high]``."""
    draws = rng.lognormal(math.log(median), sigma, size=n)
    return np.clip(np.rint(draws), low, high).astype(np.int64)


# ---------------------------------------------------------------------------
# Counts of work
# ---------------------------------------------------------------------------

def visible_pairs(seq_len: int, window: Optional[int] = None, segments=None) -> int:
    """(query, key) pairs one row of causal attention computes: key
    ``j <= i``, within ``window`` keys of the query (``i - j < window``)
    when a window is given, and in the query's own document when
    ``segments`` (a list of document lengths adding up to ``seq_len``) is
    given."""
    lengths = [seq_len] if segments is None else list(segments)
    if sum(lengths) != seq_len:
        raise ValueError(f"segments add up to {sum(lengths)}, not {seq_len}")
    total = 0
    for n in lengths:
        if window is None or window >= n:
            total += n * (n + 1) // 2
        else:
            w = window
            total += w * (w + 1) // 2 + (n - w) * w
    return total


def flash_forward_ops(batch: int, heads: int, head_dim: int, pairs_per_row: int) -> float:
    """Operations of the attention forward over ``pairs_per_row`` visible
    pairs a (row, head): QK^T and PV, 2 products of 2 operations each."""
    return 4.0 * batch * heads * head_dim * pairs_per_row


def flash_backward_ops(batch: int, heads: int, head_dim: int, pairs_per_row: int) -> float:
    """Operations of the attention backward's two kernels: dK/dV forms
    QK^T again, dV, dP and dK (8 a pair a width), dQ forms QK^T again, dP
    and dQ (6)."""
    return (8.0 + 6.0) * batch * heads * head_dim * pairs_per_row


def attention_bytes(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int,
                    itemsize: int, backward: bool) -> float:
    """Each input read once and each output written once. Forward: Q, K, V
    in, O and the f32 log-sum-exp out. Backward: Q, K, V, O, dO and the
    log-sum-exp in, dQ, dK, dV out."""
    q = batch * seq * heads * head_dim * itemsize
    kv = batch * seq * kv_heads * head_dim * itemsize
    lse = batch * heads * seq * 4
    if not backward:
        return q + 2 * kv + q + lse
    return (q + 2 * kv + q + q + lse) + (q + 2 * kv)


def roofline_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM bandwidth."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def moe_expert_ops(kept_pairs: int, hidden: int, expert_hidden: int) -> float:
    """Operations of the SwiGLU experts' products over ``kept_pairs``
    (token, expert) pairs, forward and backward: three products of
    ``2 * hidden * expert_hidden`` a pair forward, twice that backward."""
    forward = 3 * 2.0 * hidden * expert_hidden * kept_pairs
    return 3.0 * forward


def moe_expert_bytes(num_experts: int, hidden: int, expert_hidden: int,
                     itemsize: int) -> float:
    """The experts' weights read by the forward, read again by the
    backward, and their gradients written: three passes over
    ``3 * E * hidden * expert_hidden`` weights."""
    return 3.0 * 3 * num_experts * hidden * expert_hidden * itemsize


def decoder_matmul_params(cfg: dict, active_experts: Optional[int] = None) -> int:
    """Parameters of the products one token goes through: attention
    projections, the MLP (the ``active_experts`` of a sparse layer, with the
    router) and the LM head; the embedding gather is not a product."""
    D, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, G = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    attn = D * H * hd * 2 + D * G * hd * 2
    if "num_local_experts" in cfg:
        k = active_experts if active_experts is not None else cfg["num_experts_per_tok"]
        mlp = 3 * D * F * k + D * cfg["num_local_experts"]
    else:
        mlp = 3 * D * F
    return cfg["num_hidden_layers"] * (attn + mlp) + D * V


def train_flops_per_token(cfg: dict, seq_len: int, window: Optional[int] = None,
                          segments=None) -> float:
    """Model FLOPs a trained token needs, no recompute counted: 6 x the
    active matmul parameters, plus attention's 12 x visible keys x the
    heads' width a layer (2 products of 2 operations, x3 for the
    backward), over the visible pairs of a row."""
    H = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // H
    keys_per_token = visible_pairs(seq_len, window, segments) / seq_len
    attn = 12.0 * cfg["num_hidden_layers"] * H * hd * keys_per_token
    return 6.0 * decoder_matmul_params(cfg) + attn


def decode_tick_work(cfg: dict, active_slots: float, live_tokens: float,
                     itemsize: int = 2) -> tuple:
    """``(ops, bytes)`` of one decode tick: every active slot's token
    through the products and its attention over its live keys; the weights
    read once and the K/V the live tokens need (not the slots' whole
    ``max_len``)."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, G = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    n = decoder_matmul_params(cfg)
    ops = 2.0 * n * active_slots + 4.0 * L * H * hd * live_tokens
    weights = (n + 2 * L * D + D) * itemsize
    kv = live_tokens * L * 2 * G * hd * itemsize
    return ops, weights + kv
