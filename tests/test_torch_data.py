"""The port's token pipeline against the JAX package's.

``repro_torch.data.TokenPipeline`` is the port's own copy of the
reference's numpy pipeline: ``batch_at`` must equal the reference's bit
for bit over seeds, steps, data-parallel ranks, microbatch counts and
extra inputs; the twins of ``tests/test_data.py`` follow.
"""
import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as RefPipeline
from repro_torch.data import TokenPipeline


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every port test file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [
    dict(vocab=1024, seq_len=64, global_batch=8, microbatches=2, seed=5),
    dict(vocab=100352, seq_len=32, global_batch=8, microbatches=4, seed=0),
    dict(vocab=512, seq_len=16, global_batch=12, microbatches=3,
         dp_rank=1, dp_size=2, seed=7),
    dict(vocab=300, seq_len=8, global_batch=4, seed=3,
         extra_shapes={"enc_frames": ((5, 6), np.float32),
                       "image_embeds": ((2, 3), np.float32)}),
])
def test_batch_at_equals_reference_bit_for_bit(kw):
    mine, ref = TokenPipeline(**kw), RefPipeline(**kw)
    for step in (0, 1, 17, 1000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for name in b:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].shape == b[name].shape, name
            np.testing.assert_array_equal(a[name], b[name])


def test_batch_is_pure_function_of_step():
    p1 = TokenPipeline(1024, 64, 8, microbatches=2, seed=5)
    p2 = TokenPipeline(1024, 64, 8, microbatches=2, seed=5)
    for s in (0, 3, 17):
        b1, b2 = p1.batch_at(s), p2.batch_at(s)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])


def test_labels_are_shifted_tokens():
    p = TokenPipeline(512, 32, 4, seed=0)
    b = p.batch_at(0)
    np.testing.assert_array_equal(
        b["tokens"].reshape(-1, 32)[:, 1:],
        b["labels"].reshape(-1, 32)[:, :-1])


def test_dp_ranks_get_distinct_data():
    a = TokenPipeline(512, 32, 8, dp_rank=0, dp_size=2, seed=0)
    b = TokenPipeline(512, 32, 8, dp_rank=1, dp_size=2, seed=0)
    assert a.local_batch == 4
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              b.batch_at(0)["tokens"])


def test_tokens_in_vocab_range():
    p = TokenPipeline(100, 64, 4, seed=1)
    b = p.batch_at(0)
    assert b["tokens"].min() >= 0
    assert b["tokens"].max() < 100


def test_prefetch_thread_delivers_in_order():
    p = TokenPipeline(256, 16, 4, seed=2, prefetch=2)
    p.start(from_step=0)
    try:
        got0 = p.next_prefetched()
        got1 = p.next_prefetched()
        np.testing.assert_array_equal(got0["tokens"],
                                      p.batch_at(0)["tokens"])
        np.testing.assert_array_equal(got1["tokens"],
                                      p.batch_at(1)["tokens"])
    finally:
        p.stop()


def test_iteration_and_tensors_on_a_device():
    p = TokenPipeline(256, 16, 4, microbatches=2, seed=2)
    it = iter(p)
    for s in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      p.batch_at(s)["tokens"])
    batch = {k: torch.from_numpy(v).to("cpu") for k, v in
             p.batch_at(0).items()}
    assert batch["tokens"].dtype == torch.int32
    assert tuple(batch["tokens"].shape) == (2, 2, 16)
