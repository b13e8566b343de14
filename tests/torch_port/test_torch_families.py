"""The port's decoder families (GPT-2, OPT, GPT-J, GPT-NeoX, Phi, BLOOM)
against the JAX package's, on the CPU, from the same perturbed flax weights
at f32.

* The uncached logits within 1e-5 absolute / 1e-4 relative of the JAX
  model's (both attend by einsum here; the rest is summation order).
* Greedy ``generate`` token-exact with the JAX ``generate`` (f32 caches),
  BLOOM's ALiBi bias added from the cache's positions.
* ``compile_train_step`` over ``causal_lm_loss`` with Adam(1e-2) at f32 on
  the tiled-arange batch of ``tests/test_models.py:124-160``: the first loss
  within 1e-5 of the JAX step's, and the loss halving over 10 steps.
* The learned position tables (GPT-2, OPT) refuse positions past their end
  before the lookup.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model, NumpyDataLoader as JaxLoader
from accelerate_tpu.generation import generate as jax_generate
from accelerate_tpu.models import bloom as jbloom
from accelerate_tpu.models import gpt2 as jgpt2
from accelerate_tpu.models import gpt_neox as jneox
from accelerate_tpu.models import gptj as jgptj
from accelerate_tpu.models import opt as jopt
from accelerate_tpu.models import phi as jphi
from accelerate_tpu.models.llama import causal_lm_loss as jax_causal_lm_loss
from accelerate_tpu_torch import Accelerator, NumpyDataLoader, generate
from accelerate_tpu_torch.models import (
    BloomConfig,
    BloomForCausalLM,
    GPT2Config,
    GPT2LMHeadModel,
    GPTJConfig,
    GPTJForCausalLM,
    GPTNeoXConfig,
    GPTNeoXForCausalLM,
    OPTConfig,
    OPTForCausalLM,
    PhiConfig,
    PhiForCausalLM,
    causal_lm_loss,
)
from accelerate_tpu_torch.utils.convert import state_dict_from_flax

#: family -> (JAX config class, JAX model class, port config class, port
#: model class, tiny overrides): each variant the reference names
#: (NeoX's sequential residual, OPT's exact GELU, Phi's GQA) on one side.
FAMILIES = {
    "gpt2": (jgpt2.GPT2Config, jgpt2.GPT2LMHeadModel, GPT2Config, GPT2LMHeadModel, {}),
    "opt": (jopt.OPTConfig, jopt.OPTForCausalLM, OPTConfig, OPTForCausalLM, {}),
    "opt-gelu": (jopt.OPTConfig, jopt.OPTForCausalLM, OPTConfig, OPTForCausalLM,
                 dict(activation="gelu")),
    "gptj": (jgptj.GPTJConfig, jgptj.GPTJForCausalLM, GPTJConfig, GPTJForCausalLM, {}),
    "gpt_neox": (jneox.GPTNeoXConfig, jneox.GPTNeoXForCausalLM, GPTNeoXConfig,
                 GPTNeoXForCausalLM, {}),
    "gpt_neox-sequential": (jneox.GPTNeoXConfig, jneox.GPTNeoXForCausalLM, GPTNeoXConfig,
                            GPTNeoXForCausalLM, dict(use_parallel_residual=False)),
    "phi": (jphi.PhiConfig, jphi.PhiForCausalLM, PhiConfig, PhiForCausalLM, {}),
    "bloom": (jbloom.BloomConfig, jbloom.BloomForCausalLM, BloomConfig, BloomForCausalLM,
              dict(hidden_size=48, num_attention_heads=6)),  # slopes' non-power-of-two ladder
}
MAIN = ["gpt2", "opt", "gptj", "gpt_neox", "phi", "bloom"]
TOL = dict(atol=1e-5, rtol=1e-4)


def _jax_config(jcls, overrides):
    jcfg = jcls.tiny(**overrides)
    if any(f.name == "use_flash_attention" for f in dataclasses.fields(jcfg)):
        jcfg = dataclasses.replace(jcfg, use_flash_attention=False)
    return jcfg


def pair(family, seed=0):
    """(JAX module, params, port model, port config): JAX's init perturbed
    from a numpy seed, so norm scales and biases are not trivially 1 and 0."""
    jcls, jmodel_cls, cls, model_cls, overrides = FAMILIES[family]
    module = jmodel_cls(_jax_config(jcls, overrides))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(seed)))
    cfg = cls.tiny(**overrides)
    model = model_cls(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return module, params, model.eval(), cfg


def ids(B=2, S=13, seed=1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_jax(family):
    module, params, model, _ = pair(family)
    x = ids()
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).long()).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_generate_is_token_exact(family):
    module, params, model, _ = pair(family, seed=2)
    x = ids(seed=3)
    ref = np.asarray(jax_generate(module, jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(x), max_new_tokens=10, cache_dtype=jnp.float32))
    out = generate(model, torch.from_numpy(x).long(), max_new_tokens=10,
                   cache_dtype=torch.float32).numpy()
    assert out.shape == (2, 23)
    np.testing.assert_array_equal(out, ref)


def _train_batch(vocab):
    tokens = np.tile(np.arange(16, dtype=np.int32)[None], (8, 1)) % vocab
    return [{"input_ids": tokens[i]} for i in range(8)]


@pytest.mark.parametrize("family", MAIN)
def test_train_step_first_loss_matches_jax_and_halves(family):
    module, params, model, cfg = pair(family, seed=4)
    data = _train_batch(cfg.vocab_size)

    jacc = JaxAccelerator(mixed_precision="no")
    _, _, jloader = jacc.prepare(Model(module, params), optax.adam(1e-2),
                                 JaxLoader(data, batch_size=8))
    jstep = jacc.compile_train_step(jax_causal_lm_loss(module.apply))
    ref_first = float(jstep(next(iter(jloader)))["loss"])

    acc = Accelerator(cpu=True)
    pmodel, _, loader = acc.prepare(model.train(),
                                    torch.optim.Adam(model.parameters(), lr=1e-2),
                                    NumpyDataLoader(data, batch_size=8))
    step = acc.compile_train_step(causal_lm_loss(pmodel))
    losses = [step(batch)["loss"].item() for _ in range(10) for batch in loader]
    np.testing.assert_allclose(losses[0], ref_first, atol=1e-5, rtol=0)
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses


@pytest.mark.parametrize("family", ["gpt2", "opt"])
def test_learned_position_table_refuses_positions_past_its_end(family):
    _, _, model, cfg = pair(family)
    table = cfg.max_position_embeddings
    with torch.inference_mode():
        assert model(torch.zeros((1, table), dtype=torch.long)).shape[1] == table
        with pytest.raises(ValueError, match="learned position table"):
            model(torch.zeros((1, table + 1), dtype=torch.long))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate(model, torch.zeros((1, table - 4), dtype=torch.long), max_new_tokens=5)


#: family -> the HF model type the port writes and reads it as.
HF_TYPES = {"gpt2": "gpt2", "opt": "opt", "gptj": "gptj", "gpt_neox": "gpt_neox", "phi": "phi",
            "bloom": "bloom"}


@pytest.mark.parametrize("family", MAIN)
def test_streamed_model_equals_the_resident_one(tmp_path, family):
    """``save_hf_checkpoint`` then ``load_hf_checkpoint_and_dispatch`` with
    the first layer on disk and the rest in host memory: the streamed
    logits equal the resident model's bit for bit, and the streamed greedy
    decode equals ``generate``'s."""
    from accelerate_tpu_torch import load_hf_checkpoint_and_dispatch
    from accelerate_tpu_torch.big_modeling import block_specs_for
    from accelerate_tpu_torch.utils.hf_interop import save_hf_checkpoint

    _, _, model, cfg = pair(family, seed=6)
    save_hf_checkpoint(model, str(tmp_path / "hf"), cfg, HF_TYPES[family])
    first = block_specs_for(model)[1].name
    streamed, meta = load_hf_checkpoint_and_dispatch(
        str(tmp_path / "hf"), device_map={first: "disk", "": "cpu"}, execution_device="cpu")
    assert type(meta) is type(model) and meta.config == cfg
    x = torch.from_numpy(ids(seed=7)).long()
    with torch.inference_mode():
        assert torch.equal(streamed(x), model(x))
    want = generate(model, x, max_new_tokens=6, cache_dtype=torch.float32)
    assert torch.equal(streamed.generate(x, max_new_tokens=6, cache_dtype=torch.float32), want)
    assert streamed.position_bound == getattr(cfg, "max_position_embeddings", None)
    streamed.close()


@pytest.mark.parametrize("family", ["gpt2", "opt"])
def test_streamed_position_bound_refuses_past_the_table(family):
    from accelerate_tpu_torch import dispatch_model

    _, _, model, cfg = pair(family)
    streamed = dispatch_model(model, device_map={"": "cpu"}, execution_device="cpu")
    table = cfg.max_position_embeddings
    assert streamed.position_bound == table
    with pytest.raises(ValueError, match="position table"):
        streamed.generate(torch.zeros((1, table - 3), dtype=torch.long), max_new_tokens=4)
    with pytest.raises(ValueError, match="speculative slack"):
        streamed.generate(torch.zeros((1, table - 8), dtype=torch.long), max_new_tokens=4,
                          prompt_lookup_num_tokens=6)
    with torch.inference_mode(), pytest.raises(ValueError, match="learned position table"):
        streamed(torch.zeros((1, table + 1), dtype=torch.long))
    streamed.close()


@pytest.mark.parametrize("family", MAIN)
def test_block_specs_go_by_the_model_class_not_its_name(family):
    """A subclass of the port's model gets its family's specs and KV cache;
    another class of the same name (a transformers model, say) gets
    neither, and ``dispatch_model`` refuses it."""
    from accelerate_tpu_torch import dispatch_model
    from accelerate_tpu_torch.big_modeling import block_specs_for, cache_factory_for

    _, _, model, cfg = pair(family)
    subclass = type("Custom", (type(model),), {})(cfg, device="cpu")
    assert [s.name for s in block_specs_for(subclass)] == [
        s.name for s in block_specs_for(model)]
    assert cache_factory_for(subclass) is not None
    namesake = type(type(model).__name__, (torch.nn.Linear,), {})(2, 2)
    namesake.config = cfg
    assert block_specs_for(namesake) is None and cache_factory_for(namesake) is None
    with pytest.raises(ValueError, match="No block specs known"):
        dispatch_model(namesake, device_map={"": "cpu"}, execution_device="cpu")


def test_every_new_model_raises_without_a_card():
    """Built on ``cuda`` unless asked for the CPU; this suite runs without a
    card, so each raises."""
    from accelerate_tpu_torch.models import (
        MLP,
        BertConfig,
        BertForSequenceClassification,
        RegressionModel,
        ResNet,
        ResNetConfig,
    )

    assert not torch.cuda.is_available()
    builders = [lambda cls=cls, cfg_cls=cfg_cls: cls(cfg_cls.tiny())
                for _, _, cfg_cls, cls, _ in FAMILIES.values()]
    builders += [lambda: BertForSequenceClassification(BertConfig.tiny()),
                 lambda: ResNet(ResNetConfig.tiny()), lambda: MLP(4), lambda: RegressionModel()]
    for build in builders:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
