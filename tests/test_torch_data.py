"""The port's synthetic data pipeline against the reference's.

`repro_torch/data/pipeline.py` is a copy of the reference's numpy code
(the port imports nothing of the JAX package), so every batch must be
bit-equal to the reference's for any (seed, step, shard): the trainer's
resume depends on it (a restart at step k sees the stream an
uninterrupted run saw).
"""
import numpy as np
import pytest

from repro.data import pipeline as RD
from repro_torch.data import pipeline as TD

from _torch_threads import one_torch_thread  # noqa: F401


def _equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,step,shard,seq", [
    (0, 0, 0, 32), (0, 7, 0, 64), (3, 100, 1, 128), (5, 2, 3, 47),
])
def test_synthetic_lm_bit_equal(seed, step, shard, seq):
    spec = dict(global_batch=8, seq_len=seq, vocab=1000, n_shards=4,
                shard=shard)
    ref = RD.SyntheticLM(RD.LMBatchSpec(**spec), seed=seed)
    port = TD.SyntheticLM(TD.LMBatchSpec(**spec), seed=seed)
    _equal(ref.batch_at(step), port.batch_at(step))
    assert port.spec.local_batch == 2


def test_synthetic_lm_iterates_steps_in_order():
    spec = TD.LMBatchSpec(global_batch=2, seq_len=16, vocab=50)
    it = iter(TD.SyntheticLM(spec, seed=1))
    for step in range(3):
        _equal(next(it), TD.SyntheticLM(spec, seed=1).batch_at(step))


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (2, 9, 1)])
def test_synthetic_embeds_bit_equal(seed, step, shard):
    spec = dict(global_batch=4, seq_len=24, vocab=300, n_shards=2,
                shard=shard)
    ref = RD.SyntheticEmbeds(RD.LMBatchSpec(**spec), 64, seed=seed)
    port = TD.SyntheticEmbeds(TD.LMBatchSpec(**spec), 64, seed=seed)
    _equal(ref.batch_at(step), port.batch_at(step))


@pytest.mark.parametrize("seed,step", [(0, 0), (4, 3)])
def test_synthetic_images_bit_equal(seed, step):
    ref = RD.SyntheticImages(2, size=32, classes=10, seed=seed)
    port = TD.SyntheticImages(2, size=32, classes=10, seed=seed)
    _equal(ref.batch_at(step), port.batch_at(step))
