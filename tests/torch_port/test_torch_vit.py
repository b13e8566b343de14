"""The port's ViT against the JAX package's, on the CPU, from the same
perturbed flax params at f32 (``state_dict_from_flax``).

* The forward on NHWC images: logits within 2e-5, at ``ViTConfig.tiny()``
  and at a 3-layer config of 4-pixel patches on 24 x 24 images.
* ``patchify``'s ``(c, ph, pw)`` order: the patch projection equals a
  stride-``p`` ``conv2d`` with its weight reshaped to ``[D, C, p, p]``.
* Dropout drawn from the forward's generator; three ``compile_train_step``
  AdamW steps of a cross-entropy loss within 1e-5 of the JAX
  ``Accelerator``'s at dropout 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models import vit as jvit
from accelerate_tpu_torch import Accelerator, ViTConfig, ViTForImageClassification
from accelerate_tpu_torch.models.vit import patchify
from accelerate_tpu_torch.utils.convert import state_dict_from_flax

CONFIGS = {"tiny": {}, "3-layer-patch-4": dict(image_size=24, patch_size=4, num_hidden_layers=3,
                                                num_labels=5)}


def vit_pair(name="tiny", seed=0, **overrides):
    kw = {**CONFIGS[name], **overrides}
    module = jvit.ViTForImageClassification(jvit.ViTConfig.tiny(**kw))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(seed)))
    cfg = ViTConfig.tiny(**kw)
    model = ViTForImageClassification(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return module, params, model


def images(cfg, B=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.image_size, cfg.image_size, cfg.num_channels)).astype(np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    module, params, model = vit_pair(name)
    x = images(model.config)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, model.config.num_labels)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_patch_projection_is_the_conv():
    _, _, model = vit_pair("3-layer-patch-4", seed=2)
    cfg = model.config
    x = torch.from_numpy(images(cfg, seed=3))
    proj = model.patch_projection
    p = cfg.patch_size
    with torch.no_grad():
        conv = F.conv2d(x.permute(0, 3, 1, 2), proj.weight.reshape(-1, cfg.num_channels, p, p),
                        proj.bias, stride=p)
        want = conv.flatten(2).transpose(1, 2)
        np.testing.assert_allclose(proj(patchify(x, p)).numpy(), want.numpy(), atol=1e-5)


def test_dropout_draws_from_the_generator():
    _, _, model = vit_pair(seed=4, hidden_dropout_prob=0.2, attention_probs_dropout_prob=0.1)
    x = torch.from_numpy(images(model.config, seed=5))

    def logits(seed):
        with torch.no_grad():
            return model(x, None if seed is None else torch.Generator().manual_seed(seed))

    assert torch.equal(logits(7), logits(7)) and not torch.equal(logits(7), logits(8))
    assert torch.equal(logits(None), logits(None)) and not torch.equal(logits(None), logits(7))


def test_train_steps_match_jax():
    module, params, model = vit_pair(seed=6)
    rng = np.random.default_rng(7)
    batches = [{"pixel_values": images(model.config, B=4, seed=8 + s),
                "labels": rng.integers(0, 10, 4).astype(np.int32)} for s in range(3)]

    def jax_loss(p, batch):
        logits = module.apply({"params": p}, batch["pixel_values"])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(logp, batch["labels"][:, None], axis=-1).mean()

    jacc = JaxAccelerator(mixed_precision="no")
    jacc.prepare(Model(module, params), optax.adamw(1e-4, weight_decay=1e-4))
    jstep = jacc.compile_train_step(jax_loss, max_grad_norm=1.0)
    ref = [float(jstep({k: jnp.asarray(v) for k, v in b.items()})["loss"]) for b in batches]
    acc = Accelerator(cpu=True)
    pmodel, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                                     weight_decay=1e-4))

    def loss_fn(params, batch, generator=None):
        logits = torch.func.functional_call(pmodel.module, params, (batch["pixel_values"],),
                                            {"generator": generator})
        logp = torch.log_softmax(logits.float(), -1)
        return -logp.gather(-1, batch["labels"].long()[:, None]).mean()

    step = acc.compile_train_step(loss_fn, max_grad_norm=1.0)
    got = [step({k: torch.from_numpy(v) for k, v in b.items()})["loss"].item() for b in batches]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
