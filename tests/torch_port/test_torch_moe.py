"""The port's MoE layer (``ops/moe.py``) against the JAX package's, on the
CPU, from the same numpy inputs.

* Routing: ``top_k_routing``'s dispatch and combine tensors and its aux
  losses equal the JAX ones (within 1e-6) at ``top_k`` 1 and 2, with
  tokens dropped past capacity, and with a tie between experts (the lower
  index wins, as ``jax.lax.top_k`` orders ties).
* ``moe_mlp_apply`` at f32: the output within 1e-5 and the gradients of
  the experts, the router and the input (through the output and the two
  router losses) within 5e-4 of ``jax.grad``'s, relative to each one's
  largest entry; at bf16 (the router in f32 from f32 tokens) the output
  within 2e-2.
* The index dispatch equals the reference's one-hot einsums (kept here as
  the cross-check) to f32 rounding.
* Router jitter draws from a ``torch.Generator`` or a key tensor: it
  cannot match threefry, so it is held to seed determinism and to the
  reference's range ``[1 - eps, 1 + eps)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_common import close

from accelerate_tpu.ops import moe as jmoe
from accelerate_tpu_torch.ops import moe


def _logits(case: str, seed: int = 1):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((2, 24, 4)).astype(np.float32)
    if case == "skewed":  # expert 0 is everyone's first choice: drops at capacity 8
        logits[..., 0] += 3.0
    if case == "tie":  # equal first scores: the lower index is the first choice
        logits[0, 3] = [1.0, 1.0, 1.0, 0.5]
        logits[1, 5] = [0.2, 0.7, 0.7, 0.7]
    return logits


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", ["skewed", "tie", "plain"])
def test_routing_matches_jax(case, top_k):
    logits = _logits(case)
    capacity = 8
    d_ref, c_ref, a_ref = jmoe.top_k_routing(jnp.asarray(logits), top_k, capacity)
    d, c, a = moe.top_k_routing(torch.from_numpy(logits), top_k, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    close(c.numpy(), c_ref, "combine", 1e-6)
    for key in ("load_balance_loss", "router_z_loss", "expert_fraction"):
        close(a[key].numpy(), a_ref[key], key, 1e-6)
    if case == "skewed":
        assert float(d.sum()) < 2 * 24 * top_k  # some pairs dropped
    if case == "tie":
        assert d[0, 3, 0].sum() == 1 and d[1, 5, 1].sum() == 1


def test_normalize_gates_override_matches_jax():
    logits = _logits("plain")
    for top_k, norm in ((2, False), (1, True)):
        _, c_ref, _ = jmoe.top_k_routing(jnp.asarray(logits), top_k, 16, normalize_gates=norm)
        _, c, _ = moe.top_k_routing(torch.from_numpy(logits), top_k, 16, normalize_gates=norm)
        close(c.numpy(), c_ref, (top_k, norm), 1e-6)


def test_capacity_and_default_groups_match_jax():
    for args in [(10, 4, 1, 1.0), (100, 8, 2, 1.25), (3, 8, 2, 1.0), (2048, 8, 2, 8.0)]:
        assert moe.expert_capacity(*args) == jmoe.expert_capacity(*args)

    class Shape:  # what default_num_groups reads of a mesh
        def __init__(self, **axes):
            self.shape = axes

    for axes, n in [({"dp": 2, "ep": 2}, 64), ({"dp": 2, "fsdp": 2, "ep": 2}, 12),
                    ({"fsdp": 4}, 16), ({"dp": 3}, 16)]:
        assert moe.default_num_groups(n, Shape(**axes)) == \
            jmoe.default_num_groups(n, Shape(**axes))
    assert moe.default_num_groups(16) == 1


def _params(E=4, D=16, F=32, seed=0):
    rng = np.random.default_rng(seed)
    experts = {"gate_proj": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
               "up_proj": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
               "down_proj": rng.standard_normal((E, F, D)).astype(np.float32) / 6}
    router = rng.standard_normal((D, E)).astype(np.float32)
    x = rng.standard_normal((4, 8, D)).astype(np.float32)
    w = rng.standard_normal((4, 8, D)).astype(np.float32)
    return experts, router, x, w


def _jax_loss(top_k, cf, groups):
    def loss(experts, router, x, w):
        out, aux = jmoe.moe_mlp_apply(experts, router, x, top_k=top_k, capacity_factor=cf,
                                      num_groups=groups, mesh=None)
        return (jnp.sum(out * w) + 0.5 * aux["load_balance_loss"]
                + 0.1 * aux["router_z_loss"]), out

    return loss


@pytest.mark.parametrize("top_k,cf,groups", [(2, 1.0, 2), (1, 1.25, 1), (2, 4.0, 4)])
def test_moe_mlp_apply_and_its_gradients_match_jax(top_k, cf, groups):
    experts, router, x, w = _params()
    (ref_loss, ref_out), ref_grads = jax.value_and_grad(
        _jax_loss(top_k, cf, groups), argnums=(0, 1, 2), has_aux=True)(
        {k: jnp.asarray(v) for k, v in experts.items()}, jnp.asarray(router), jnp.asarray(x),
        jnp.asarray(w))
    t_experts = {k: torch.from_numpy(v).requires_grad_() for k, v in experts.items()}
    t_router = torch.from_numpy(router).requires_grad_()
    t_x = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_mlp_apply(t_experts, t_router, t_x, top_k=top_k, capacity_factor=cf,
                                 num_groups=groups)
    loss = (out * torch.from_numpy(w)).sum() + 0.5 * aux["load_balance_loss"] \
        + 0.1 * aux["router_z_loss"]
    loss.backward()
    close(out.detach().numpy(), ref_out, "out", 1e-5)
    close(loss.item(), ref_loss, "loss", 1e-5)
    for k in experts:
        close(t_experts[k].grad.numpy(), ref_grads[0][k], k, 5e-4)
    close(t_router.grad.numpy(), ref_grads[1], "router", 5e-4)
    close(t_x.grad.numpy(), ref_grads[2], "x", 5e-4)
    assert 0.0 <= float(aux["dropped_fraction"]) < 1.0
    assert float(aux["expert_load"].sum()) == top_k * 32 * (1 - float(aux["dropped_fraction"]))


def test_moe_mlp_apply_bf16_routes_in_f32():
    experts, router, x, _ = _params(seed=2)
    ref, _ = jmoe.moe_mlp_apply({k: jnp.asarray(v, jnp.bfloat16) for k, v in experts.items()},
                                jnp.asarray(router), jnp.asarray(x, jnp.bfloat16), top_k=2,
                                capacity_factor=1.0, num_groups=2)
    out, _ = moe.moe_mlp_apply({k: torch.from_numpy(v).bfloat16() for k, v in experts.items()},
                               torch.from_numpy(router), torch.from_numpy(x).bfloat16(), top_k=2,
                               capacity_factor=1.0, num_groups=2)
    assert out.dtype == torch.bfloat16
    close(out.float().numpy(), np.asarray(ref, np.float32), "bf16 out", 2e-2)


def test_index_dispatch_equals_the_one_hot_einsums():
    """The reference's einsums over ``top_k_routing``'s one-hots, in torch,
    against the index form on the same routing (drops included)."""
    experts, router, x, _ = _params(seed=3)
    t = {k: torch.from_numpy(v) for k, v in experts.items()}
    xt = torch.from_numpy(x)
    G = 2
    tokens = xt.reshape(G, -1, x.shape[-1])
    C = moe.expert_capacity(tokens.shape[1], 4, 2, 1.0)
    dispatch, combine, _ = moe.top_k_routing(tokens.float() @ torch.from_numpy(router), 2, C)
    expert_in = torch.einsum("gnec,gnd->egcd", dispatch, tokens)
    h = torch.nn.functional.silu(torch.einsum("egcd,edf->egcf", expert_in, t["gate_proj"]))
    h = h * torch.einsum("egcd,edf->egcf", expert_in, t["up_proj"])
    out_e = torch.einsum("egcf,efd->egcd", h, t["down_proj"])
    want = torch.einsum("gnec,egcd->gnd", combine, out_e).reshape(x.shape)
    got, aux = moe.moe_mlp_apply(t, torch.from_numpy(router), xt, top_k=2, capacity_factor=1.0,
                                 num_groups=G)
    assert float(aux["dropped_fraction"]) > 0
    close(got.numpy(), want.numpy(), "index vs one-hot", 1e-6)


def test_router_noise_is_seeded_and_in_range():
    experts, router, x, _ = _params(seed=4)
    t = {k: torch.from_numpy(v) for k, v in experts.items()}
    args = (t, torch.from_numpy(router), torch.from_numpy(x))
    kw = dict(top_k=2, capacity_factor=2.0, num_groups=1, router_noise_eps=0.5)
    base, _ = moe.moe_mlp_apply(*args, top_k=2, capacity_factor=2.0, num_groups=1)

    def run(seed):
        return moe.moe_mlp_apply(*args, router_noise_rng=torch.Generator().manual_seed(seed),
                                 **kw)[0]

    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8)) and not torch.equal(run(7), base)
    key = torch.tensor(123456789, dtype=torch.int64)
    keyed = [moe.moe_mlp_apply(*args, router_noise_rng=key, **kw)[0] for _ in range(2)]
    assert torch.equal(keyed[0], keyed[1])
    for source in (torch.Generator().manual_seed(1), key):
        u = moe._uniform(source, (64, 8), torch.device("cpu"))
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0 and 0.4 < float(u.mean()) < 0.6


def test_group_count_must_divide_the_tokens():
    experts, router, _, _ = _params()
    t = {k: torch.from_numpy(v) for k, v in experts.items()}
    with pytest.raises(ValueError) as ours:
        moe.moe_mlp_apply(t, torch.from_numpy(router), torch.ones(1, 10, 16), top_k=1,
                          capacity_factor=1.0, num_groups=3)
    with pytest.raises(ValueError) as theirs:
        jmoe.moe_mlp_apply({k: jnp.asarray(v) for k, v in experts.items()},
                           jnp.asarray(router), jnp.ones((1, 10, 16)), top_k=1,
                           capacity_factor=1.0, num_groups=3, mesh=None)
    assert str(ours.value) == str(theirs.value)
