"""Shared pieces of the serving engine's CPU tests: one tiny Llama in the
JAX package and in the port with the same weights (carried across by
``utils/convert.py``), JAX ``generate`` as the oracle, and an engine
factory whose engines are shut down when the test ends, so a hang fails
one test rather than the suite's time limit."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import generate as jax_generate
from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.models.llama import LlamaForCausalLM as JaxLlamaForCausalLM
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.serving import ServingEngine
from accelerate_tpu_torch.utils.convert import state_dict_from_flax

#: Every wait in these tests is bounded by this many seconds.
WAIT = 60.0


def pair(seed=0, **overrides):
    """The same perturbed weights in the JAX module and the port's model."""
    module = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**overrides))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(seed)))
    cfg = LlamaConfig.tiny(**overrides)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return module, jax.tree_util.tree_map(jnp.asarray, params), model.eval()


def prompts(lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (1, n)).astype(np.int32) for n in lengths]


class Oracle:
    """JAX ``generate`` (greedy, f32 cache) per (prompt, max_new), cached."""

    def __init__(self, module, params):
        self.module, self.params = module, params
        self._memo = {}

    def __call__(self, prompt, max_new, eos_token_id=None):
        key = (prompt.tobytes(), prompt.shape[1], max_new, eos_token_id)
        if key not in self._memo:
            out = jax_generate(self.module, self.params, jnp.asarray(prompt),
                               max_new_tokens=max_new, eos_token_id=eos_token_id,
                               cache_dtype=jnp.float32)
            self._memo[key] = np.asarray(out)[0, prompt.shape[1]:]
        return self._memo[key]


@pytest.fixture
def make_engine():
    """``make_engine(model, **kw)``: a CPU engine with an f32 cache, shut
    down (without draining) when the test ends."""
    engines = []

    def make(model, **kw):
        kw.setdefault("device", "cpu")
        kw.setdefault("cache_dtype", torch.float32)
        engine = ServingEngine(model, **kw)
        engines.append(engine)
        return engine

    yield make
    for engine in engines:
        try:
            engine.shutdown(drain=False, timeout=WAIT)
        except RuntimeError:
            pass  # a test that killed its engine has checked the error
        assert not engine.running


def submit_staggered(engine, items, waves=3, pause=0.01, **kw):
    """Submit ``(prompt, max_new)`` items in ``waves`` groups, ``pause``
    seconds apart, so later requests join a batch already decoding."""
    reqs = []
    per = -(-len(items) // waves)
    for w in range(waves):
        for prompt, max_new in items[w * per:(w + 1) * per]:
            reqs.append(engine.submit(prompt, max_new_tokens=max_new, **kw))
        time.sleep(pause)
    return reqs


def wait_until(cond, timeout=WAIT, what="condition"):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{what} not reached within {timeout}s")
        time.sleep(0.002)
