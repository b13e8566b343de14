"""The port's data loading against the JAX package's.

Index batches (``NumpyDataLoader``, ``SeedableRandomSampler``,
``BatchSamplerShard``) and packed rows (``pack_sequences``) are pure host
arithmetic on both sides, so they must be equal, not close. The prepared
loader must yield the JAX package's batches as tensors of the
``make_global_batch`` types, resume where ``state_dict`` says, and its
background prefetch must keep the order, raise a worker's error and leave
no thread behind.
"""

import threading

import numpy as np
import pytest
import torch

from accelerate_tpu import data_loader as jdl
from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu_torch import Accelerator, DataLoaderConfiguration
from accelerate_tpu_torch import data_loader as tdl


def dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal(3).astype(np.float32), "id": np.int32(i)}
            for i in range(n)]


def as_numpy(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("n,batch_size,shuffle,drop_last,seed,epoch", [
    (23, 4, True, False, 0, 0), (23, 4, True, True, 7, 3), (16, 8, False, False, 0, 0),
    (10, 3, True, False, 123, 1),
])
def test_numpy_loader_yields_the_jax_batches(n, batch_size, shuffle, drop_last, seed, epoch):
    data = dataset(n)
    ours = tdl.NumpyDataLoader(data, batch_size=batch_size, shuffle=shuffle,
                               drop_last=drop_last, seed=seed)
    ref = jdl.NumpyDataLoader(data, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
                              seed=seed)
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    assert len(ours) == len(ref)
    got, want = list(ours), list(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("num_processes,split_batches,even_batches,drop_last", [
    (1, False, True, False), (2, False, True, False), (3, False, False, False),
    (2, True, True, False), (2, True, False, False), (3, False, True, True),
])
def test_batch_sampler_shard_matches_jax(num_processes, split_batches, even_batches, drop_last):
    for n in (26, 24, 7):
        for seed in (0, 5):
            inner_t = tdl.BatchSamplerFromSampler(tdl.SeedableRandomSampler(n, seed=seed), 4,
                                                  drop_last)
            inner_j = jdl.BatchSamplerFromSampler(jdl.SeedableRandomSampler(n, seed=seed), 4,
                                                  drop_last)
            for rank in range(num_processes):
                kw = dict(num_processes=num_processes, process_index=rank,
                          split_batches=split_batches, even_batches=even_batches)
                ours, ref = tdl.BatchSamplerShard(inner_t, **kw), jdl.BatchSamplerShard(inner_j, **kw)
                assert list(ours) == list(ref), (n, seed, rank)
                assert len(ours) == len(ref)


def test_pack_sequences_matches_jax():
    rng = np.random.default_rng(3)
    docs = [rng.integers(1, 1000, size=int(rng.integers(1, 90))) for _ in range(40)]
    docs.append(np.arange(1, 200))  # longer than a row: cut into chunks
    ours, ref = tdl.pack_sequences(docs, seq_len=64, pad_token_id=0), jdl.pack_sequences(
        docs, seq_len=64, pad_token_id=0)
    assert ours.keys() == ref.keys()
    for key in ref:
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])


def prepared(data, batch_size=4, shuffle=True, seed=0, **config):
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(**config))
    return acc, acc.prepare(tdl.NumpyDataLoader(data, batch_size=batch_size, shuffle=shuffle,
                                                seed=seed))


@pytest.mark.parametrize("async_prefetch", [True, False], ids=["async", "sync"])
def test_prepared_loader_yields_the_jax_batches_as_tensors(async_prefetch):
    data = dataset(19)
    _, loader = prepared(data, async_prefetch=async_prefetch)
    jax_acc = JaxAccelerator(cpu=True)
    ref = jax_acc.prepare(jdl.NumpyDataLoader(data, batch_size=4, shuffle=True, seed=0))
    for epoch in range(2):
        got = list(loader)
        want = [as_numpy(b) for b in ref]
        assert len(got) == len(want) == 5, epoch
        for a, b in zip(got, want):
            assert a["x"].dtype == torch.float32 and a["id"].dtype == torch.int64
            assert a["x"].device.type == "cpu"
            np.testing.assert_array_equal(a["x"].numpy(), b["x"])
            np.testing.assert_array_equal(a["id"].numpy(), b["id"])


def test_state_dict_and_skip_first_batches_resume_the_stream():
    data = dataset(30)
    _, loader = prepared(data)
    full = [b["id"].tolist() for b in loader]  # epoch 0
    it = iter(loader)  # epoch 1, stopped after 3 batches
    head = [next(it)["id"].tolist() for _ in range(3)]
    sd = loader.state_dict()
    assert sd == {"epoch": 1, "batches_consumed": 3}
    it.close()
    rest_epoch1 = None
    for make in ("load_state_dict", "skip_first_batches"):
        acc2, fresh = prepared(data)
        if make == "load_state_dict":
            fresh.load_state_dict(sd)
            resumed = [b["id"].tolist() for b in fresh]
        else:
            fresh.set_epoch(1)
            resumed = [b["id"].tolist() for b in acc2.skip_first_batches(fresh, 3)]
        rest_epoch1 = rest_epoch1 or resumed
        assert resumed == rest_epoch1
    _, again = prepared(data)
    again.set_epoch(1)
    assert head + rest_epoch1 == [b["id"].tolist() for b in again]
    assert full != head + rest_epoch1  # epoch 1 is another order
    # An unprepared iterable is wrapped.
    assert list(tdl.skip_first_batches([1, 2, 3, 4], 2)) == [3, 4]


def test_async_prefetch_keeps_order_raises_and_joins():
    before = {t for t in threading.enumerate() if t.name == "atpu-prefetch"}
    source = iter(range(50))
    prefetcher = tdl.AsyncPrefetcher(lambda: next(source), lambda x: x * 2, prefetch_size=3,
                                     num_workers=3)
    got = []
    while True:
        try:
            got.append(prefetcher.get())
        except StopIteration:
            break
    prefetcher.close()
    assert got == [2 * i for i in range(50)]

    def failing():
        for i in range(5):
            yield {"x": np.full(2, i, np.float32)}
        raise KeyError("a worker's error")

    _, loader = prepared(list(range(1)), async_prefetch=True)
    loader.base_dataloader = failing()
    seen = []
    with pytest.raises(KeyError, match="a worker's error"):
        for batch in loader:
            seen.append(int(batch["x"][0]))
    assert seen == [0, 1, 2, 3]  # the loader runs one batch ahead
    # Abandoning an epoch midway stops its worker too.
    _, loader = prepared(dataset(40))
    for i, _ in enumerate(loader):
        if i == 2:
            break
    for thread in threading.enumerate():
        if thread.name == "atpu-prefetch" and thread not in before:
            thread.join(timeout=10)
            assert not thread.is_alive()


def test_prepare_takes_a_torch_dataloader_and_an_iterable():
    acc = Accelerator(cpu=True)
    ds = torch.utils.data.TensorDataset(torch.arange(10, dtype=torch.int32),
                                        torch.ones(10, dtype=torch.float64))
    loader = acc.prepare(torch.utils.data.DataLoader(ds, batch_size=4))
    batches = list(loader)
    assert [b[0].tolist() for b in batches] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert batches[0][0].dtype == torch.int64 and batches[0][1].dtype == torch.float32
    gen = acc.prepare_data_loader(({"a": np.full((2,), i)} for i in range(3)))
    assert [b["a"].tolist() for b in gen] == [[0, 0], [1, 1], [2, 2]]


def test_input_pipeline_metrics_count_the_batches():
    acc, loader = prepared(dataset(12))
    for _ in loader:
        pass
    metrics = acc.input_pipeline_metrics()
    assert metrics["batches_waited"] == 3 and metrics["batches_staged"] == 3
    assert metrics["data_wait_ms"] >= 0 and metrics["stage_ms"] >= 0


def test_gradient_state_sync_sequence_matches_jax():
    """An epoch of 7 batches with num_steps=3: syncs on the 3rd and 6th
    microbatch and, with the loader's end, on the 7th."""
    data = dataset(7)
    jax_acc = JaxAccelerator(cpu=True, gradient_accumulation_steps=3)
    ref_loader = jax_acc.prepare(jdl.NumpyDataLoader(data, batch_size=1))
    acc = Accelerator(cpu=True, gradient_accumulation_steps=3)
    loader = acc.prepare(tdl.NumpyDataLoader(data, batch_size=1))
    sequences = []
    for a, dl in ((jax_acc, ref_loader), (acc, loader)):
        seq = []
        for _ in range(2):
            for _ in dl:
                with a.accumulate():
                    seq.append((a.sync_gradients, a.gradient_state.end_of_dataloader))
        sequences.append(seq)
    assert sequences[1] == sequences[0]
    assert [s for s, _ in sequences[1][:7]] == [False, False, True, False, False, True, True]


def test_make_global_batch_raises_on_other_types():
    with pytest.raises(TypeError, match="numeric"):
        tdl.make_global_batch({"s": np.array(["a"])}, "cpu")
