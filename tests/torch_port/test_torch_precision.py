"""The port's precision policies against the JAX package's."""

import jax.numpy as jnp
import pytest
import torch

from accelerate_tpu.precision import policy_for as jax_policy_for
from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, policy_for


@pytest.mark.parametrize("mode", ["no", "fp32", "bf16", "fp16", "fp8"])
def test_policy_dtypes_match_jax(mode):
    ref, pol = jax_policy_for(mode), policy_for(mode)
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert str(getattr(pol, field)).split(".")[-1] == jnp.dtype(getattr(ref, field)).name


def test_bf16_policy_casts_floating_values_only():
    pol = policy_for("bf16")
    tree = {"w": torch.ones(2), "ids": torch.arange(3), "nested": [torch.zeros(1, dtype=torch.float64)]}
    cast = pol.cast_to_compute(tree)
    assert cast["w"].dtype == torch.bfloat16 and cast["ids"].dtype == torch.int64
    assert cast["nested"][0].dtype == torch.bfloat16
    assert pol.cast_to_output(cast)["w"].dtype == torch.float32
    model = pol.cast_to_compute(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"))
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in pol.cast_to_param(model).parameters()} == {torch.float32}


def test_unported_and_unknown_modes_raise():
    """Every mode is ported ("fp8", once refused, is the bf16 policy, the fp8
    products being the model's own); an unknown one raises."""
    assert policy_for("fp8") == policy_for("bf16")
    with pytest.raises(ValueError, match="Unknown"):
        policy_for("int3")
