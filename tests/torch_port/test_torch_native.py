"""The port's native host-IO runtime (``accelerate_tpu_torch/native``): the
cases of ``tests/test_native.py`` on the port's own copy of the C++
source, built with this machine's g++: parallel region reads, the prefetch
ring (order, shuffled schedules, a partial batch, the Python path), the
token loader (coverage, disjoint process shards, shuffle and epochs,
resume, feeding the port's train step), ``fast_load_safetensors`` against
``safetensors`` (bf16 as ``torch.bfloat16``), and
``load_safetensors_model(threads=)`` against the one-thread reader."""

import os

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.native import PrefetchRing, available, parallel_read
from accelerate_tpu_torch.native.io import TokenBinDataLoader, fast_load_safetensors


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "tokens.bin")
    tokens = np.arange(10_000, dtype=np.int32)
    tokens.tofile(path)
    return path, tokens


def test_native_lib_builds_into_the_ignored_build_directory():
    from accelerate_tpu_torch import native

    assert available(), "the native library should build with this machine's g++"
    assert native._BUILD_DIR.endswith(os.path.join("accelerate_tpu_torch", "_build", "native"))
    assert any(f.startswith("libatpu_native_") for f in os.listdir(native._BUILD_DIR))


def test_regions_round_trip(token_file):
    path, tokens = token_file
    rng = np.random.default_rng(0)
    offsets = rng.integers(0, tokens.nbytes - 400, 50).astype(np.int64)
    sizes = np.full(50, 400, np.int64)
    dests = [np.empty(400, np.uint8) for _ in range(50)]
    parallel_read(path, offsets, sizes, dests, threads=8)
    raw = tokens.tobytes()
    for off, d in zip(offsets, dests):
        assert d.tobytes() == raw[off: off + 400]


def test_validation_and_missing_file(token_file):
    path, _ = token_file
    with pytest.raises(ValueError, match="equal length"):
        parallel_read(path, [0], [4, 8], [np.empty(8, np.uint8)])
    with pytest.raises(ValueError, match="smaller"):
        parallel_read(path, [0], [400], [np.empty(4, np.uint8)])
    with pytest.raises(IOError):
        parallel_read("/nonexistent/file.bin", [0], [4], [np.empty(4, np.uint8)])


def test_ring_yields_ordered_exact_batches(token_file):
    path, tokens = token_file
    sample_bytes = 16 * 4
    ring = PrefetchRing(path, np.arange(40, dtype=np.int64) * sample_bytes, sample_bytes,
                        batch_size=8, depth=3, threads=4)
    assert ring.num_batches == 5
    seen = []
    for buf, valid in ring:
        assert valid == 8
        seen.append(buf.view(np.int32).reshape(8, 16).copy())
    np.testing.assert_array_equal(np.concatenate(seen).reshape(-1), tokens[: 40 * 16])


def test_ring_follows_a_shuffled_schedule_and_a_partial_batch(token_file):
    path, tokens = token_file
    order = np.array([5, 0, 3, 1], dtype=np.int64)
    ring = PrefetchRing(path, order * 32, 32, batch_size=2)
    flat = np.concatenate([buf.view(np.int32).reshape(2, 8)[:v].copy() for buf, v in ring])
    for row, idx in zip(flat, order):
        np.testing.assert_array_equal(row, tokens[idx * 8: idx * 8 + 8])
    ring = PrefetchRing(path, np.arange(5, dtype=np.int64) * 32, 32, batch_size=2)
    assert [v for _, v in ring] == [2, 2, 1]


def test_python_path_matches_the_native_ring(token_file):
    path, _ = token_file
    offsets = np.arange(6, dtype=np.int64) * 32
    native = [(b.copy(), v) for b, v in PrefetchRing(path, offsets, 32, batch_size=3)]
    ring_py = PrefetchRing(path, offsets, 32, batch_size=3)
    ring_py._lib = None
    fallback = [(b.copy(), v) for b, v in ring_py]
    assert len(native) == len(fallback) == 2
    for (a, va), (b, vb) in zip(native, fallback):
        assert va == vb
        np.testing.assert_array_equal(a[: va * 32], b[: vb * 32])


def test_loader_covers_an_epoch_in_tensors(token_file):
    path, tokens = token_file
    dl = TokenBinDataLoader(path, seq_len=64, batch_size=4, shuffle=False)
    batches = list(dl)
    assert all(b["input_ids"].shape == (4, 64) and b["input_ids"].dtype == torch.int32
               for b in batches)
    got = torch.cat([b["input_ids"] for b in batches]).reshape(-1).numpy()
    np.testing.assert_array_equal(got, tokens[: len(got)])
    assert len(batches) == len(dl)


def test_process_shards_are_disjoint(token_file):
    path, _ = token_file
    rows = []
    for rank in range(4):
        dl = TokenBinDataLoader(path, seq_len=32, batch_size=2, shuffle=True, seed=7,
                                num_processes=4, process_index=rank)
        rows += [tuple(r.tolist()) for b in dl for r in b["input_ids"]]
    assert len(rows) == len(set(rows))


def test_shuffle_is_deterministic_and_epochs_differ(token_file):
    path, _ = token_file

    def epoch(dl):
        return torch.cat([b["input_ids"] for b in dl])

    dl = TokenBinDataLoader(path, seq_len=32, batch_size=4, shuffle=True, seed=3)
    dl2 = TokenBinDataLoader(path, seq_len=32, batch_size=4, shuffle=True, seed=3)
    first = epoch(dl)
    assert torch.equal(first, epoch(dl2))
    dl2.set_epoch(1)
    assert not torch.equal(first, epoch(dl2))


def test_resume_skips_the_consumed_batches(token_file):
    path, _ = token_file

    def loader():
        return TokenBinDataLoader(path, seq_len=32, batch_size=4, shuffle=True, seed=5)

    dl = loader()
    it = iter(dl)
    for _ in range(3):
        next(it)
    state = dl.state_dict()
    assert state == {"epoch": 0, "skip_batches": 3}
    resumed = loader()
    resumed.load_state_dict(state)
    assert resumed.state_dict() == state  # a save before iterating round-trips
    rest = torch.cat([b["input_ids"] for b in resumed])
    full = [b["input_ids"] for b in loader()]
    assert torch.equal(rest, torch.cat(full[3:]))


def test_loader_feeds_the_port_train_step(token_file):
    from accelerate_tpu_torch import (
        Accelerator,
        LlamaConfig,
        LlamaForCausalLM,
        fused_causal_lm_loss,
        make_global_batch,
    )

    path, _ = token_file
    cfg = LlamaConfig.tiny(vocab_size=16384, use_flash_attention=False)
    acc = Accelerator(cpu=True)
    model = LlamaForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model, _ = acc.prepare(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    step = acc.compile_train_step(fused_causal_lm_loss(model))
    losses = []
    for i, batch in enumerate(TokenBinDataLoader(path, seq_len=32, batch_size=8)):
        losses.append(step(make_global_batch(batch, acc))["loss"].item())
        if i >= 2:
            break
    assert len(losses) == 3 and all(np.isfinite(losses))


@pytest.mark.parametrize("threads", [1, 4])
def test_fast_load_matches_safetensors(tmp_path, threads):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {
        "a.weight": torch.randn((128, 64), generator=gen),
        "a.bias": torch.randn((64,), generator=gen),
        "b.weight": torch.randint(-100, 100, (32, 16), generator=gen, dtype=torch.int32),
        "c.half": torch.randn((8, 8), generator=gen).half(),
        "d.bf16": torch.arange(64, dtype=torch.float32).reshape(8, 8).bfloat16(),
        "e.empty": torch.zeros((0, 4)),
    }
    path = str(tmp_path / "m.safetensors")
    save_file(tensors, path)
    loaded = fast_load_safetensors(path, threads=threads)
    reference = load_file(path)
    assert set(loaded) == set(tensors)
    for k in tensors:
        assert loaded[k].dtype == tensors[k].dtype and loaded[k].device.type == "cpu"
        assert torch.equal(loaded[k], reference[k]), k
    assert loaded["d.bf16"].dtype == torch.bfloat16


def test_load_safetensors_model_reads_through_the_threads(tmp_path, monkeypatch):
    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.checkpointing import load_safetensors_model, save_model
    from accelerate_tpu_torch.native import io as native_io

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             generator=torch.Generator().manual_seed(1))
    save_model(None, model, str(tmp_path), max_shard_size="100KB")
    calls = []
    real = native_io.fast_load_safetensors
    monkeypatch.setattr(native_io, "fast_load_safetensors",
                        lambda path, threads=8: calls.append(threads) or real(path, threads))
    threaded = load_safetensors_model(str(tmp_path), threads=3)
    assert calls and set(calls) == {3} and len(calls) > 1  # every shard, 3 threads
    single = load_safetensors_model(str(tmp_path), threads=1)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    a, b = dict(flat(threaded)), dict(flat(single))
    state = model.state_dict()
    assert set(a) == set(b) == set(state)
    for name in state:
        assert torch.equal(a[name], b[name]) and torch.equal(a[name], state[name])
