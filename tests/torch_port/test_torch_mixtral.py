"""The port's Mixtral (``models/mixtral.py``) against the JAX package's, on
the CPU, from the same perturbed flax weights at f32.

* The forward's logits and layer-averaged router losses within 1e-5 of
  the largest entry, for the tiny config, top-1 routing, a tied head, and
  Qwen2-MoE's options (raw top-k gates, the sigmoid-gated shared expert,
  dense ``mlp_only_layers``).
* Greedy ``generate`` token-exact against the JAX ``generate``, with the
  dense and the ring (sliding-window) caches; sampling seed-deterministic.
* 5 fused AdamW steps of ``mixtral_lm_loss`` (capacity factor 1, so tokens
  drop) against the JAX ``compile_train_step``: losses and grad norms
  within 1e-5 relative, plain and with the whole block rematerialised.
* The ep/tp/fsdp specs of every leaf equal the JAX package's, string for
  string.
* Router jitter in training: seed-deterministic, and off without a
  generator.
* HF checkpoints: transformers' Mixtral and Qwen2-MoE load into the port
  with their logits (no drops) and export back tensor for tensor; the port's
  model streamed from its own HF export on the host, disk and "auto" tiers
  equals the resident model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_common import close

from accelerate_tpu.models.mixtral import MixtralConfig as JaxConfig
from accelerate_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from accelerate_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
    mixtral_lm_loss,
)
from accelerate_tpu_torch.utils.convert import state_dict_from_flax

QWEN2_MOE = dict(norm_topk_prob=False, shared_expert_intermediate_size=48,
                 mlp_only_layers=(1,), dense_intermediate_size=96)
VARIANTS = {"tiny": {}, "top1": dict(top_k=1), "tied": dict(tie_word_embeddings=True),
            "qwen2_moe": QWEN2_MOE}


def pair(overrides, seed=0):
    """The same perturbed weights in the JAX module and the port's model."""
    module = JaxMixtral(JaxConfig.tiny_moe(use_flash_attention=False, **overrides))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        module.init_params(jax.random.PRNGKey(seed)))
    cfg = MixtralConfig.tiny_moe(**overrides)
    model = MixtralForCausalLM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return module, params, model


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_and_router_losses_match_jax(name):
    module, params, model = pair(VARIANTS[name])
    ids = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    logits_ref, aux_ref = module.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(ids).long())
    close(logits.numpy(), logits_ref, "logits", 1e-5)
    for key in ("load_balance_loss", "router_z_loss"):
        close(aux[key].numpy(), aux_ref[key], key, 1e-5)
    assert [layer.dense for layer in model.layers] == [
        i in VARIANTS[name].get("mlp_only_layers", ()) for i in range(2)]


@pytest.mark.parametrize("window", [None, 8], ids=["dense", "ring"])
def test_greedy_generate_is_token_exact(window):
    from accelerate_tpu.generation import generate as jax_generate
    from accelerate_tpu_torch import generate

    module, params, model = pair({"sliding_window": window})
    ids = np.random.default_rng(1).integers(0, 256, (2, 11)).astype(np.int32)
    ref = jax_generate(module, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids),
                       max_new_tokens=12, cache_dtype=jnp.float32)
    out = generate(model.eval(), torch.from_numpy(ids).long(), max_new_tokens=12,
                   cache_dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_generate_is_seed_deterministic():
    from accelerate_tpu_torch import generate

    _, _, model = pair({})
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 5))).long()

    def run(seed):
        return generate(model.eval(), ids, max_new_tokens=8, do_sample=True, top_k=20,
                        generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))


def _jax_steps(params, cfg_kwargs, ids, labels):
    import optax

    from accelerate_tpu import Accelerator, Model
    from accelerate_tpu.data_loader import make_global_batch
    from accelerate_tpu.models.mixtral import mixtral_lm_loss as jax_loss
    from accelerate_tpu.state import AcceleratorState

    AcceleratorState._reset_state()
    from accelerate_tpu import MeshConfig

    acc = Accelerator(mesh_config=MeshConfig(devices=jax.devices()[:1]))
    cfg = JaxConfig.tiny_moe(use_flash_attention=False, **cfg_kwargs)
    module = JaxMixtral(cfg)
    model, _ = acc.prepare(Model(module, params), optax.adamw(1e-3, weight_decay=1e-4))
    step = acc.compile_train_step(jax_loss(module.apply, cfg), max_grad_norm=1.0)
    out = []
    for s in range(ids.shape[0]):
        m = step(make_global_batch({"input_ids": ids[s], "labels": labels[s]}, acc.mesh))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return np.asarray(out)


def _batches(steps=5, rows=4, seq=16):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (steps, rows, seq)).astype(np.int32)
    labels = np.roll(ids, -1, axis=2).astype(np.int32)
    labels[:, :, -1] = -100
    labels[:, 0, 10:] = -100
    return ids, labels


@pytest.mark.parametrize("remat", [None, "dots", "nothing"])
def test_train_steps_match_jax(remat):
    from accelerate_tpu_torch import Accelerator

    overrides = {"capacity_factor": 1.0}
    if remat is not None:
        overrides.update(remat=True, remat_policy=remat)
    _, params, model = pair(overrides)
    ids, labels = _batches()
    ref = _jax_steps(params, overrides, ids, labels)
    acc = Accelerator(cpu=True)
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3,
                                                    weight_decay=1e-4))
    step = acc.compile_train_step(mixtral_lm_loss(model), max_grad_norm=1.0)
    got = []
    for s in range(ids.shape[0]):
        m = step({"input_ids": torch.from_numpy(ids[s]).long(),
                  "labels": torch.from_numpy(labels[s]).long()})
        got.append([m["loss"].item(), m["grad_norm"].item()])
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5)


def test_router_noise_in_training_is_seeded():
    from accelerate_tpu_torch import Accelerator

    _, _, model = pair({"router_noise_eps": 0.5, "capacity_factor": 1.0})
    ids, labels = _batches(steps=1)
    batch = {"input_ids": torch.from_numpy(ids[0]).long(),
             "labels": torch.from_numpy(labels[0]).long()}
    acc = Accelerator(cpu=True)
    loss_fn = mixtral_lm_loss(model)
    params = dict(model.named_parameters())
    with torch.no_grad():
        plain = loss_fn(params, batch)
        noisy = [loss_fn(params, batch, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert noisy[0] == noisy[1] and noisy[0] != noisy[2] and noisy[0] != plain
    assert acc.generator is not None


def test_param_specs_match_jax():
    """Every leaf's spec under ep, tp and fsdp (the JAX test's mesh, with an
    FSDP plugin too) equals the JAX package's."""
    from accelerate_tpu import MeshConfig as JaxMeshConfig
    from accelerate_tpu.parallel.sharding import infer_param_shardings as jax_infer
    from accelerate_tpu.utils import ExpertParallelPlugin as JaxEP
    from accelerate_tpu.utils import FullyShardedDataParallelPlugin as JaxFSDP
    from accelerate_tpu.utils import TensorParallelPlugin as JaxTP
    from accelerate_tpu_torch import (
        ExpertParallelPlugin,
        FullyShardedDataParallelPlugin,
        TensorParallelPlugin,
    )
    from accelerate_tpu_torch.parallel.sharding import layout_specs, reference_path, swap_spec
    from accelerate_tpu_torch.parallel.sharding import _is_kernel

    module, params, model = pair(QWEN2_MOE)
    for axes, fsdp in (({"dp": 2, "ep": 2, "tp": 2}, False), ({"fsdp": 2, "ep": 4}, True)):
        jmesh = JaxMeshConfig(**axes, devices=jax.devices()[:8]).build()
        plugins = dict(tp_plugin=JaxTP(tp_size=2) if "tp" in axes else None,
                       ep_plugin=JaxEP(ep_size=axes["ep"]),
                       fsdp_plugin=JaxFSDP(min_weight_size_to_shard=1024) if fsdp else None)
        want = jax.tree_util.tree_map(lambda s: str(s.spec), jax_infer(params, jmesh, **plugins))
        ours = layout_specs(
            model, FullyShardedDataParallelPlugin(min_weight_size_to_shard=1024) if fsdp else None,
            dict(jmesh.shape), TensorParallelPlugin(tp_size=2) if "tp" in axes else None,
            None, ExpertParallelPlugin(ep_size=axes["ep"]))
        for name, spec in ours.items():
            p = dict(model.named_parameters())[name]
            ref_spec = swap_spec(spec, p.ndim, _is_kernel(model, name, p.ndim))
            node = want
            for part in reference_path(model, name).split("/"):
                node = node[part]
            assert str(ref_spec) == node, (name, str(ref_spec), node)
        experts = ours["layers.0.mlp.experts.gate_proj"]
        assert experts[0] == "ep"


HF_FAMILIES = {
    "mixtral": dict(num_local_experts=4, num_experts_per_tok=2),
    "qwen2_moe": dict(intermediate_size=80, moe_intermediate_size=48,
                      shared_expert_intermediate_size=64, num_experts=4, num_experts_per_tok=2,
                      norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[1],
                      use_sliding_window=False),
}


def hf_model(family):
    import transformers

    kind = {"mixtral": "Mixtral", "qwen2_moe": "Qwen2Moe"}[family]
    kwargs = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=64, rms_norm_eps=1e-5,
                  router_jitter_noise=0.0, attention_dropout=0.0, tie_word_embeddings=False)
    if family == "mixtral":
        kwargs["intermediate_size"] = 48
    hf_cfg = getattr(transformers, f"{kind}Config")(**kwargs, **HF_FAMILIES[family])
    torch.manual_seed(0)
    with torch.no_grad():
        return getattr(transformers, f"{kind}ForCausalLM")(hf_cfg).eval(), hf_cfg.to_dict()


@pytest.mark.parametrize("family", sorted(HF_FAMILIES))
def test_hf_checkpoints_round_trip_against_transformers(family):
    """transformers 4.57's model -> the port (the router transposed, the
    experts stacked and transposed) gives its logits within 5e-4 with no
    drops, holds the tensors the JAX package's conversion gives, and
    exports back to the same HF tensors and config."""
    from accelerate_tpu.utils import hf_interop as jhf
    from accelerate_tpu_torch.utils import hf_interop as phf

    hf, hf_cfg = hf_model(family)
    assert phf.detect_family(hf_cfg) == family
    cfg = phf.config_from_hf(hf_cfg)
    jcfg = jhf.config_from_hf(hf_cfg)
    for field in ("num_experts", "top_k", "norm_topk_prob", "shared_expert_intermediate_size",
                  "mlp_only_layers", "dense_intermediate_size", "intermediate_size",
                  "attention_qkv_bias", "router_aux_coef"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    cfg.capacity_factor = float(cfg.num_experts)  # HF drops nothing
    state = phf.convert_hf_state_dict(hf.state_dict(), family, strict=True)
    jax_state = state_dict_from_flax(jhf.convert_hf_state_dict(hf.state_dict(), family), cfg)
    assert set(state) == set(jax_state)
    for name, t in state.items():
        np.testing.assert_array_equal(t.numpy(), jax_state[name].numpy(), err_msg=name)
    model = MixtralForCausalLM(cfg, device="cpu")
    model.load_state_dict(state)
    ids = torch.from_numpy((np.arange(16).reshape(2, 8) * 5) % 96)
    with torch.no_grad():
        ours, theirs = model(ids)[0], hf(ids).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=5e-4)
    back = phf.export_hf_state_dict(model, family)
    ref = hf.state_dict()
    assert set(back) == set(ref)
    for name, t in ref.items():
        assert torch.equal(back[name], t), name
    again = phf.config_from_hf(phf.hf_config_from(cfg, family), family)
    assert dataclasses_equal(again, cfg, skip=("capacity_factor",))


def dataclasses_equal(a, b, skip=()):
    import dataclasses

    return all(getattr(a, f.name) == getattr(b, f.name)
               for f in dataclasses.fields(a) if f.name not in skip)


@pytest.mark.parametrize("tier", ["cpu", "disk", "auto"])
def test_streamed_mixtral_equals_the_resident_model(tmp_path, tier):
    """The port's model exported to an HF directory by the port's exporter,
    loaded back by ``load_hf_checkpoint_and_dispatch`` on one tier (disk:
    each layer's experts a ``LazyStack`` over the per-expert tensors; auto:
    the solver's map under a budget that leaves layers off the card), gives
    the resident model's logits and greedy tokens."""
    from accelerate_tpu_torch import generate
    from accelerate_tpu_torch.big_modeling import LazyStack, load_hf_checkpoint_and_dispatch
    from accelerate_tpu_torch.utils.hf_interop import save_hf_checkpoint

    # The auto tier's checkpoint is a Qwen2-MoE one (q/k/v biases, the shared
    # expert, a dense layer), the others Mixtral.
    _, _, model = pair({**QWEN2_MOE, "attention_qkv_bias": True} if tier == "auto" else {})
    model.eval()
    save_hf_checkpoint(model, str(tmp_path), model.config,
                       family="qwen2_moe" if tier == "auto" else "mixtral", max_shard_size="200KB")
    device_map = "auto" if tier == "auto" else {"": tier}
    streamed, module = load_hf_checkpoint_and_dispatch(
        str(tmp_path), device_map=device_map, execution_device="cpu",
        max_memory={0: "260KB", "cpu": "300KB"} if tier == "auto" else None)
    module.config.capacity_factor = model.config.capacity_factor
    places = set(streamed.store.placement.values())
    if tier == "auto":
        assert places == {0, "cpu", "disk"}, places
    if tier == "disk":
        assert isinstance(streamed.store.entries["layers.0.mlp.experts.gate_proj"], LazyStack)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 16)))
    with torch.no_grad():
        want = model(ids)[0]
    got = streamed(ids)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        generate(streamed, ids, max_new_tokens=6, cache_dtype=torch.float32).numpy(),
        generate(model, ids, max_new_tokens=6, cache_dtype=torch.float32).numpy())
