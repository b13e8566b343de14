"""The yardstick's counts against hand-worked values, and its copies of the
schedule and percentile against the originals on fixed seeds."""

import itertools

import numpy as np
import pytest

from portbench import yardstick as Y


def brute_pairs(seq, window=None, segments=None):
    doc = np.repeat(np.arange(len(segments or [seq])), segments or [seq])
    return sum(1 for i, j in itertools.product(range(seq), repeat=2)
               if j <= i and (window is None or i - j < window) and doc[i] == doc[j])


@pytest.mark.parametrize("seq,window,segments,expected", [
    (4, None, None, 10),          # 1 + 2 + 3 + 4
    (5, 2, None, 9),              # 1 + 2 + 2 + 2 + 2
    (5, None, [3, 2], 9),         # 6 + 3
    (6, 2, [4, 2], 10),           # (1 + 2 + 2 + 2) + (1 + 2)
    (7, 10, None, 28),            # a window wider than the row is causal
])
def test_visible_pairs_by_hand(seq, window, segments, expected):
    assert Y.visible_pairs(seq, window, segments) == expected
    assert brute_pairs(seq, window, segments) == expected


def test_visible_pairs_against_brute_force():
    rng = np.random.default_rng(0)
    for _ in range(20):
        cuts = sorted(rng.choice(np.arange(1, 40), size=3, replace=False))
        segments = list(np.diff([0, *cuts, 40]))
        window = int(rng.integers(1, 20))
        assert Y.visible_pairs(40, window, segments) == brute_pairs(40, window, segments)


def test_visible_pairs_rejects_segments_of_another_length():
    with pytest.raises(ValueError):
        Y.visible_pairs(10, segments=[4, 4])


def test_moe_kept_pair_operations_and_bytes():
    # 10 kept pairs, D=4, F=8: forward 3 products x 2*4*8 a pair = 1920,
    # backward twice the forward: 5760 in all.
    assert Y.moe_expert_ops(10, 4, 8) == 5760
    # 8 experts of 3 [4, 8] bf16 matrices = 1536 bytes, three passes.
    assert Y.moe_expert_bytes(8, 4, 8, 2) == 3 * 3 * 8 * 4 * 8 * 2


def test_flash_operations_and_roofline():
    assert Y.flash_forward_ops(2, 3, 4, 10) == 4 * 2 * 3 * 4 * 10
    assert Y.flash_backward_ops(2, 3, 4, 10) == 14 * 2 * 3 * 4 * 10
    # Compute-bound and bandwidth-bound cases of the bound.
    assert Y.roofline_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert Y.roofline_seconds(1.0, 3.35e12) == pytest.approx(1.0)


CFG = {"hidden_size": 8, "intermediate_size": 16, "vocab_size": 10, "num_hidden_layers": 2,
       "num_attention_heads": 2, "num_key_value_heads": 1}


def test_matmul_params_dense_and_moe():
    # attention: q 8x8, o 8x8, k 8x4, v 8x4 = 192; MLP 3*8*16 = 384; head 80.
    assert Y.decoder_matmul_params(CFG) == 2 * (192 + 384) + 80
    moe = {**CFG, "num_local_experts": 4, "num_experts_per_tok": 2}
    # two of four experts a token, and the router 8x4.
    assert Y.decoder_matmul_params(moe) == 2 * (192 + 2 * 384 + 32) + 80


def test_train_flops_per_token():
    # 6N plus 12 x layers x heads x hd x mean visible keys ((S + 1) / 2).
    n = Y.decoder_matmul_params(CFG)
    assert Y.train_flops_per_token(CFG, 4) == pytest.approx(6 * n + 12 * 2 * 8 * 10 / 4)


def test_decode_tick_work():
    n = Y.decoder_matmul_params(CFG)
    ops, nbytes = Y.decode_tick_work(CFG, active_slots=3, live_tokens=100)
    assert ops == 2 * n * 3 + 4 * 2 * 8 * 100
    # weights (with the norms) once, and K/V of 100 live tokens.
    assert nbytes == (n + 2 * 2 * 8 + 8) * 2 + 100 * 2 * 2 * 1 * 4 * 2


def test_percentile_matches_the_original():
    from accelerate_tpu_torch.loadgen.report import percentile as original

    rng = np.random.default_rng(1)
    values = list(rng.lognormal(0, 1, 57)) + [float("inf")]
    for q in (0, 1, 50, 90, 95, 99, 100):
        assert Y.percentile(values, q) == original(values, q)
    assert Y.percentile([], 95) is None
    assert Y.percentile([3.0, 1.0, 2.0], 50) == 2.0  # nearest rank


@pytest.mark.parametrize("dist", ["lognormal", "pareto", "uniform"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_arrival_schedule_matches_the_original(dist, seed):
    from accelerate_tpu_torch.loadgen.generator import ArrivalSchedule as Original

    mine = Y.ArrivalSchedule(50, 0.25, dist=dist, sigma=0.8, alpha=1.7, seed=seed)
    theirs = Original(50, 0.25, dist=dist, sigma=0.8, alpha=1.7, seed=seed)
    np.testing.assert_array_equal(mine.offsets(), theirs.offsets())


def test_exponential_arrivals_are_poisson():
    s = Y.ArrivalSchedule(20001, 0.5, dist="exponential", seed=3)
    gaps = np.diff(s.offsets())
    assert s.offsets()[0] == 0.0
    assert gaps.mean() == pytest.approx(0.5, rel=0.03)
    assert gaps.std() == pytest.approx(0.5, rel=0.05)  # exponential: sd = mean


def test_lognormal_lengths_are_clipped_and_seeded():
    a = Y.lognormal_lengths(1000, 512, 0.7, 64, 2048, np.random.default_rng(4))
    b = Y.lognormal_lengths(1000, 512, 0.7, 64, 2048, np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 64 and a.max() <= 2048
    assert abs(np.median(a) - 512) < 40
