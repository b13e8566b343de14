"""The plain references at tiny sizes: their pieces against hand-worked
values, their row-by-row gradients against one pass, and each whole
reference against the program at float32 (where both must agree to
rounding)."""

import math

import numpy as np
import pytest
import torch

from portbench import weights as W
from portbench.reference import common, dense_decoder, mixtral_train


def test_rms_norm_by_hand():
    x = torch.tensor([[3.0, 4.0]])
    # mean square 12.5: x / sqrt(12.5) times the scale.
    out = common.rms_norm(x, torch.tensor([1.0, 2.0]), 0.0)
    torch.testing.assert_close(out, torch.tensor([[3 / 12.5 ** 0.5, 8 / 12.5 ** 0.5]]))


def test_rotary_by_hand():
    # hd = 2: one pair (dims 0 and 1) turned by position * theta^0 = p rad.
    x = torch.tensor([[[1.0, 0.0]], [[1.0, 0.0]]])
    out = common.rotary(x, torch.tensor([0, 1]), theta=10000.0)
    torch.testing.assert_close(out[0, 0], torch.tensor([1.0, 0.0]))
    torch.testing.assert_close(out[1, 0], torch.tensor([math.cos(1.0), math.sin(1.0)]))


def test_causal_attention_by_hand():
    # One head, hd 1: q = k = 0 gives equal scores, so each query averages
    # the values it sees: v0, (v0 + v1) / 2, then within a window of 2.
    q = torch.zeros(3, 1, 1)
    v = torch.tensor([[[1.0]], [[3.0]], [[5.0]]])
    full = common.causal_attention(q, q, v)
    torch.testing.assert_close(full[:, 0], torch.tensor([1.0, 2.0, 3.0]))
    band = common.causal_attention(q, q, v, window=2)
    torch.testing.assert_close(band[:, 0], torch.tensor([1.0, 2.0, 4.0]))


def test_attention_query_heads_share_key_heads():
    q = torch.randn(5, 4, 8)
    k, v = torch.randn(5, 2, 8), torch.randn(5, 2, 8)
    out = common.causal_attention(q, k, v, head_block=3).view(5, 4, 8)
    alone = common.causal_attention(q[:, 2:3], k[:, 1:2], v[:, 1:2]).view(5, 1, 8)
    torch.testing.assert_close(out[:, 2:3], alone)


def test_route_by_hand():
    # Expert 0 is every token's first choice; capacity 2 keeps the first
    # two tokens' first choices, and the second choices (expert 1) fit.
    logits = torch.tensor([[2.0, 1.0], [2.0, 1.0], [2.0, 1.0]])
    expert, keep = mixtral_train.route(logits, top_k=2, capacity=2)
    assert expert.tolist() == [[0, 1]] * 3
    assert keep.tolist() == [[True, True], [True, True], [False, False]]


def test_route_first_choices_outrank_second():
    # Token 0's second choice (expert 1) comes after token 1's first.
    logits = torch.tensor([[2.0, 1.0], [1.0, 2.0]])
    expert, keep = mixtral_train.route(logits, top_k=2, capacity=1)
    assert expert.tolist() == [[0, 1], [1, 0]]
    assert keep.tolist() == [[True, False], [True, False]]


def test_capacity_rounds_up_to_eight():
    cfg = {"num_local_experts": 8, "num_experts_per_tok": 2, "capacity_factor": 1.25}
    assert mixtral_train.capacity(16384, cfg) == 5120
    assert mixtral_train.capacity(10, cfg) == 8


MOE = {"vocab_size": 64, "hidden_size": 16, "intermediate_size": 24, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "num_local_experts": 4,
       "num_experts_per_tok": 2, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
       "sliding_window": None, "capacity_factor": 1.0, "router_aux_loss_coef": 0.02,
       "router_z_loss_coef": 0.001, "max_position_embeddings": 64,
       "tie_word_embeddings": False}


def _leaves(cfg, seed):
    w = W.make_all(cfg, seed, "cpu", torch.float64)
    return {n: t.clone().requires_grad_(True) for n, t in w.items()}


def test_row_gradients_add_up_to_the_batch_gradient():
    """The reference's rows under fixed routing give the gradient of one
    pass over the whole batch (float64, so only the order differs)."""
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 64, (3, 12)))
    rows = _leaves(MOE, 1)
    loss = mixtral_train.loss_and_grads(rows, MOE, ids)
    whole = _leaves(MOE, 1)
    routes = mixtral_train._route_batch(whole, MOE, ids)
    total = sum(mixtral_train._row_loss(whole, MOE, ids[b], routes, b, ids.numel(), 3 * 11)
                for b in range(3))
    total.backward()
    assert loss == pytest.approx(float(total.detach()), rel=1e-12)
    for n in rows:
        torch.testing.assert_close(rows[n].grad, whole[n].grad, rtol=1e-10, atol=1e-12)


def test_mixtral_reference_agrees_with_the_program():
    from portbench import port
    from accelerate_tpu_torch.models.mixtral import mixtral_lm_loss

    model = port.build_model(MOE, 3, "cpu", torch.float32)
    ids = torch.as_tensor(np.random.default_rng(1).integers(3, 64, (2, 16)))
    program = float(mixtral_lm_loss(model)(dict(model.named_parameters()), {"input_ids": ids}))
    w = W.make_all(MOE, 3, "cpu", torch.float32)
    for t in w.values():
        t.requires_grad_(True)
    assert mixtral_train.loss_and_grads(w, MOE, ids) == pytest.approx(program, rel=1e-5)


DENSE = {"vocab_size": 64, "hidden_size": 16, "intermediate_size": 24, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
         "rope_theta": 1e4, "sliding_window": 5, "max_position_embeddings": 64,
         "tie_word_embeddings": False}


def test_dense_reference_agrees_with_the_program():
    """Logits of the program's forward (float32, window 5 acting) and the
    reference's, at every position of two sequences."""
    from portbench import port

    model = port.build_model(DENSE, 4, "cpu", torch.float32)
    rng = np.random.default_rng(2)
    seqs = [torch.as_tensor(rng.integers(0, 64, n)) for n in (9, 13)]
    picks = [torch.arange(len(s)) for s in seqs]
    ends = W.make_ends(DENSE, 4, "cpu", torch.float32)
    ref = dense_decoder.logits_at(DENSE, ends, lambda i: W.make_layer(DENSE, 4, i, "cpu",
                                                                      torch.float32), seqs, picks)
    with torch.no_grad():
        for s, r in zip(seqs, ref):
            torch.testing.assert_close(model(s[None])[0], r, rtol=1e-4, atol=1e-5)


def test_references_import_nothing_of_the_program():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = ("import sys; import portbench.reference.mixtral_train, "
            "portbench.reference.dense_decoder, portbench.compare, portbench.weights, "
            "portbench.yardstick; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'accelerate_tpu_torch', 'accelerate_tpu', 'jax', 'flax', 'optax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
