"""The port's BERT, ResNet and small models against the JAX package's, on
the CPU, from the same perturbed flax variables at f32.

* BERT: logits within 1e-5 (an attention mask with padded keys, token
  types), and two ``compile_train_step`` steps of ``classification_loss``
  (Adam) whose losses match the JAX steps' within 1e-5; dropout drawn from
  the loss's generator, the same for the same seed.
* ResNet, both block kinds, on a tiny config whose stride-2 stem, pool and
  stage show flax's asymmetric "SAME" padding on an even input side (and
  its symmetric case on an odd one): logits in train and eval mode within
  1e-4, the running statistics after one train-mode forward within 1e-6 of
  flax's mutable ``batch_stats``, and two train steps of the cv example's
  loss (frozen statistics) within 1e-5.
* ``MLP`` and ``RegressionModel``: forwards within 1e-6 and one train step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models import bert as jbert
from accelerate_tpu.models import resnet as jresnet
from accelerate_tpu.models import simple as jsimple
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import (
    MLP,
    BertConfig,
    BertForSequenceClassification,
    RegressionModel,
    ResNet,
    ResNetConfig,
    classification_loss,
)
from accelerate_tpu_torch.models.resnet import _same_pads
from accelerate_tpu_torch.utils.convert import state_dict_from_flax


def perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + scale * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


def bert_pair(seed=0, **overrides):
    jcfg = jbert.BertConfig.tiny(use_flash_attention=False, **overrides)
    module = jbert.BertForSequenceClassification(jcfg)
    params = perturbed(module.init_params(jax.random.PRNGKey(seed)), seed)
    cfg = BertConfig.tiny(**overrides)
    model = BertForSequenceClassification(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return module, params, model


def bert_batch(B=4, S=24, seed=1):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.int32)
    mask[1, 17:] = 0
    mask[3, 5:] = 0
    return {"input_ids": rng.integers(0, 1024, (B, S)).astype(np.int32),
            "attention_mask": mask,
            "token_type_ids": (np.arange(S) >= S // 2).astype(np.int32)[None].repeat(B, 0),
            "labels": rng.integers(0, 2, B).astype(np.int32)}


def test_bert_logits_match_jax():
    module, params, model = bert_pair()
    b = bert_batch()
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(b["input_ids"]),
                                  jnp.asarray(b["attention_mask"]),
                                  jnp.asarray(b["token_type_ids"])))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(b[k]) for k in ("input_ids", "attention_mask",
                                                        "token_type_ids"))).numpy()
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_bert_train_steps_match_jax():
    module, params, model = bert_pair(seed=2, hidden_dropout_prob=0.0)
    batches = [bert_batch(seed=s) for s in (3, 4)]
    jacc = JaxAccelerator(mixed_precision="no")
    jacc.prepare(Model(module, params), optax.adam(1e-3))
    jstep = jacc.compile_train_step(jbert.classification_loss(module.apply))
    ref = [float(jstep({k: jnp.asarray(v) for k, v in b.items()})["loss"]) for b in batches]
    acc = Accelerator(cpu=True)
    pmodel, _ = acc.prepare(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step = acc.compile_train_step(classification_loss(pmodel))
    got = [step({k: torch.from_numpy(v) for k, v in b.items()})["loss"].item() for b in batches]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_bert_dropout_draws_from_the_loss_generator():
    _, _, model = bert_pair(seed=5, hidden_dropout_prob=0.3)
    b = {k: torch.from_numpy(v) for k, v in bert_batch().items()}
    loss_fn = classification_loss(model)
    params = dict(model.named_parameters())

    def loss(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return loss_fn(params, b, gen).item()

    assert loss(7) == loss(7)
    assert loss(7) != loss(8)
    assert loss(None) == loss(None) != loss(7)


RESNETS = {"basic": dict(), "bottleneck": dict(bottleneck=True)}


def resnet_pair(kind, seed=0, size=32):
    jcfg = jresnet.ResNetConfig.tiny(num_classes=3)
    cfg = ResNetConfig.tiny(num_classes=3)
    for name, value in RESNETS[kind].items():
        setattr(jcfg, name, value)
        setattr(cfg, name, value)
    module = jresnet.ResNet(jcfg)
    variables = perturbed(module.init_variables(jax.random.PRNGKey(seed), image_size=size), seed)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    model = ResNet(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, cfg))
    return module, variables, model


def test_same_padding_is_asymmetric_at_stride_two_on_an_even_side():
    assert _same_pads(32, 7, 2) == (2, 3)
    assert _same_pads(16, 3, 2) == (0, 1)
    assert _same_pads(33, 7, 2) == (3, 3)
    assert _same_pads(32, 3, 1) == (1, 1)
    assert _same_pads(32, 1, 2) == (0, 0)


@pytest.mark.parametrize("kind", sorted(RESNETS))
@pytest.mark.parametrize("size", [32, 33])
def test_resnet_forward_and_running_statistics_match_flax(kind, size):
    module, variables, model = resnet_pair(kind, size=size)
    x = np.random.default_rng(1).normal(size=(4, size, size, 3)).astype(np.float32)
    ref_eval = np.asarray(module.apply(variables, jnp.asarray(x), train=False))
    ref_train, updated = module.apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = model(torch.from_numpy(x), train=False).numpy()
        got_train = model(torch.from_numpy(x), train=True).numpy()
    np.testing.assert_allclose(got_eval, ref_eval, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_train, np.asarray(ref_train), atol=1e-4, rtol=1e-4)
    want = state_dict_from_flax({"params": variables["params"], **updated}, model.config)
    stats = {n: b for n, b in model.named_buffers()}
    assert set(stats) == {n for n in want if n.endswith((".mean", ".var"))}
    for name, buf in stats.items():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("kind", sorted(RESNETS))
def test_resnet_train_steps_match_jax(kind):
    """The cv example's loss: statistics frozen at their values (eval-mode
    normalization), Adam on the parameters."""
    module, variables, model = resnet_pair(kind, seed=3)
    rng = np.random.default_rng(4)
    batches = [{"pixel_values": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                "labels": rng.integers(0, 3, 4).astype(np.int32)} for _ in range(2)]
    stats = variables["batch_stats"]

    def apply_fn(p, pixel_values):
        return module.apply({"params": p, "batch_stats": stats}, pixel_values, train=False)

    def jax_loss(p, batch):
        logp = jax.nn.log_softmax(apply_fn(p, batch["pixel_values"]).astype(jnp.float32), -1)
        return -jnp.take_along_axis(logp, batch["labels"][:, None], axis=-1).mean()

    jacc = JaxAccelerator(mixed_precision="no")
    jacc.prepare(Model(apply_fn, variables["params"]), optax.adam(1e-3))
    jstep = jacc.compile_train_step(jax_loss)
    ref = [float(jstep({k: jnp.asarray(v) for k, v in b.items()})["loss"]) for b in batches]

    acc = Accelerator(cpu=True)
    pmodel, _ = acc.prepare(model, torch.optim.Adam(model.parameters(), lr=1e-3))

    def loss_fn(params, batch):
        logits = torch.func.functional_call(pmodel.module, params, (batch["pixel_values"],),
                                            {"train": False})
        logp = torch.log_softmax(logits.float(), -1)
        return -logp.gather(-1, batch["labels"].long()[:, None]).mean()

    step = acc.compile_train_step(loss_fn)
    got = [step({k: torch.from_numpy(v) for k, v in b.items()})["loss"].item() for b in batches]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_mlp_and_regression_model_match_jax():
    module = jsimple.MLP(features=(16, 8), num_outputs=2)
    params = perturbed(module.init_params(jax.random.PRNGKey(0), 5), 0)
    cfg = None
    mlp = MLP(5, features=(16, 8), num_outputs=2, device="cpu")
    mlp.load_state_dict(state_dict_from_flax(params, cfg))
    x = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(mlp(torch.from_numpy(x)).numpy(), ref, atol=1e-6, rtol=1e-6)

    y = (x[:, :2] * 0.5).astype(np.float32)
    jacc = JaxAccelerator(mixed_precision="no")
    jacc.prepare(Model(module, params), optax.sgd(0.1))
    jstep = jacc.compile_train_step(
        lambda p, b: jnp.mean((module.apply({"params": p}, b["x"]) - b["y"]) ** 2))
    batch = {"x": x, "y": y}
    ref_losses = [float(jstep({k: jnp.asarray(v) for k, v in batch.items()})["loss"])
                  for _ in range(2)]
    acc = Accelerator(cpu=True)
    pmlp, _ = acc.prepare(mlp, torch.optim.SGD(mlp.parameters(), lr=0.1))
    step = acc.compile_train_step(lambda p, b: torch.mean(
        (torch.func.functional_call(pmlp.module, p, (b["x"],)) - b["y"]) ** 2))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = [step(tbatch)["loss"].item() for _ in range(2)]
    np.testing.assert_allclose(losses, ref_losses, atol=1e-6, rtol=1e-6)

    reg = jsimple.RegressionModel()
    rparams = {"a": np.float32(1.5), "b": np.float32(-0.25)}
    ours = RegressionModel(device="cpu")
    ours.load_state_dict(state_dict_from_flax(rparams, None))
    with torch.no_grad():
        np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(),
                                   np.asarray(reg.apply({"params": rparams}, jnp.asarray(x))),
                                   atol=1e-7)
