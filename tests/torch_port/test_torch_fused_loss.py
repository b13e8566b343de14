"""The port's chunked LM-head loss against the JAX package's.

``chunked_softmax_xent`` (a ``torch.autograd.Function`` looping over vocab
chunks) is compared with the JAX ``custom_vjp`` of the same name: the loss,
dh and dW, with and without the final-logit softcap, and with plain
cross-entropy over the full logits. At fp32 both sides do the same f32
arithmetic in another order: relative 1e-5. The loss factories
(``fused_causal_lm_loss``, ``causal_lm_loss``) are held to the JAX ones on
the same weights. Inputs come from a numpy seed and go to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import PipelinedLlamaForCausalLM as JaxPipelined
from accelerate_tpu.models.llama import causal_lm_loss as jax_causal_lm_loss
from accelerate_tpu.models.llama import fused_causal_lm_loss as jax_fused_causal_lm_loss
from accelerate_tpu.ops.fused_loss import chunked_softmax_xent as jax_chunked_softmax_xent
from accelerate_tpu_torch import (
    LlamaConfig,
    PipelinedLlamaForCausalLM,
    causal_lm_loss,
    chunked_softmax_xent,
    fused_causal_lm_loss,
    state_dict_from_flax,
)

TOL = dict(atol=1e-6, rtol=1e-5)


def make_inputs(N=24, H=16, V=96, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, H), dtype=np.float32)
    kernel = 0.3 * rng.standard_normal((H, V), dtype=np.float32)
    targets = rng.integers(0, V, N).astype(np.int32)
    mask = (rng.random(N) > 0.25).astype(np.float32)
    return h, kernel, targets, mask


def torch_loss_and_grads(h, kernel, targets, mask, num_chunks, softcap):
    th = torch.from_numpy(h).requires_grad_()
    tk = torch.from_numpy(kernel).requires_grad_()
    loss = chunked_softmax_xent(th, tk, torch.from_numpy(targets).long(), torch.from_numpy(mask),
                                num_chunks, softcap)
    loss.backward()
    return loss.detach().numpy(), th.grad.numpy(), tk.grad.numpy()


@pytest.mark.parametrize("softcap", [None, 2.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("num_chunks", [1, 4, 8])
def test_matches_jax_custom_vjp(softcap, num_chunks):
    h, kernel, targets, mask = make_inputs(seed=num_chunks)

    def jax_loss(h, kernel):
        return jax_chunked_softmax_xent(h, kernel, jnp.asarray(targets), jnp.asarray(mask),
                                        num_chunks, softcap)

    ref_loss, (ref_dh, ref_dk) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(kernel))
    loss, dh, dk = torch_loss_and_grads(h, kernel, targets, mask, num_chunks, softcap)
    np.testing.assert_allclose(loss, np.asarray(ref_loss), **TOL)
    np.testing.assert_allclose(dh, np.asarray(ref_dh), **TOL)
    np.testing.assert_allclose(dk, np.asarray(ref_dk), **TOL)


@pytest.mark.parametrize("softcap", [None, 2.0], ids=["plain", "softcap"])
def test_matches_plain_cross_entropy(softcap):
    h, kernel, targets, mask = make_inputs(seed=5)
    loss, dh, dk = torch_loss_and_grads(h, kernel, targets, mask, 4, softcap)
    th = torch.from_numpy(h).requires_grad_()
    tk = torch.from_numpy(kernel).requires_grad_()
    logits = th @ tk
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    nll = F.cross_entropy(logits, torch.from_numpy(targets).long(), reduction="none")
    tmask = torch.from_numpy(mask)
    ref = (nll * tmask).sum() / tmask.sum().clamp(min=1)
    ref.backward()
    np.testing.assert_allclose(loss, ref.detach().numpy(), **TOL)
    np.testing.assert_allclose(dh, th.grad.numpy(), **TOL)
    np.testing.assert_allclose(dk, tk.grad.numpy(), **TOL)


def test_fully_masked_batch_gives_zero_loss_and_grads():
    h, kernel, targets, _ = make_inputs(seed=6)
    loss, dh, dk = torch_loss_and_grads(h, kernel, targets, np.zeros(len(targets), np.float32),
                                        4, None)
    assert loss == 0.0 and not dh.any() and not dk.any()


def test_bf16_hidden_states_keep_f32_logits():
    """16-bit inputs: f32 loss, grads in the inputs' dtype, within bf16
    rounding (2e-2 relative) of the f32 computation."""
    h, kernel, targets, mask = make_inputs(seed=7)
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    tk = torch.from_numpy(kernel).to(torch.bfloat16).requires_grad_()
    loss = chunked_softmax_xent(th, tk, torch.from_numpy(targets).long(), torch.from_numpy(mask),
                                4)
    loss.backward()
    assert loss.dtype == torch.float32
    assert th.grad.dtype == torch.bfloat16 and tk.grad.dtype == torch.bfloat16
    ref_loss, ref_dh, ref_dk = torch_loss_and_grads(
        th.detach().float().numpy(), tk.detach().float().numpy(), targets, mask, 4, None)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=2e-2)
    np.testing.assert_allclose(th.grad.float().numpy(), ref_dh, atol=2e-2 * np.abs(ref_dh).max())
    np.testing.assert_allclose(tk.grad.float().numpy(), ref_dk, atol=2e-2 * np.abs(ref_dk).max())


def test_rejects_indivisible_chunks():
    h, kernel, targets, mask = make_inputs(V=96)
    with pytest.raises(ValueError, match="not divisible"):
        torch_loss_and_grads(h, kernel, targets, mask, 7, None)


def _models(overrides, seed=0):
    cfg = JaxLlamaConfig.tiny(**overrides)
    jmodel = JaxPipelined(cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        jmodel.init_params(jax.random.PRNGKey(seed)))
    tcfg = LlamaConfig.tiny(**overrides)
    model = PipelinedLlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, tcfg))
    return jmodel, params, model


@pytest.mark.parametrize("overrides", [{}, dict(tie_word_embeddings=True,
                                                final_logit_softcapping=3.0)],
                         ids=["untied", "tied-softcap"])
def test_loss_factories_match_jax(overrides):
    jmodel, params, model = _models(overrides, seed=1)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    labels = ids.copy()
    labels[:, :3] = -100
    for batch in ({"input_ids": ids}, {"input_ids": ids, "labels": labels}):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        named = dict(model.named_parameters())
        ref_fused = float(jax_fused_causal_lm_loss(jmodel, 8)(params, jbatch))
        ref_plain = float(jax_causal_lm_loss(jmodel.apply)(params, jbatch))
        fused = fused_causal_lm_loss(model, 8)(named, tbatch)
        plain = causal_lm_loss(model)(named, tbatch)
        np.testing.assert_allclose(fused.item(), ref_fused, rtol=1e-5)
        np.testing.assert_allclose(plain.item(), ref_plain, rtol=1e-5)
        np.testing.assert_allclose(fused.item(), plain.item(), rtol=1e-5)
