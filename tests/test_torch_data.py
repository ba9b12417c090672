"""The port's data pipeline (``repro_torch.data.pipeline``, its own numpy
copy) against the reference's, bit for bit: the synthetic stream's
batches, the byte-file dataset's rows (a temporary file, byte and
smaller vocabularies), document packing, and the prefetching loader's
order, including its straggler backups."""
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as ref  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed,vocab", [(0, 512), (3, 64), (11, 122753)])
def test_synthetic_batches_equal_reference(seed, vocab):
    kw = dict(batch=3, seq=17, vocab=vocab, seed=seed)
    mine = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
    theirs = ref.SyntheticLM(ref.DataConfig(**kw))
    np.testing.assert_array_equal(mine.table, theirs.table)
    for step in (0, 1, 7, 1000):
        _equal(mine.batch_at(step), theirs.batch_at(step))
    assert not np.array_equal(mine.batch_at(1)["tokens"],
                              mine.batch_at(2)["tokens"])


@pytest.mark.parametrize("vocab", [256, 50])
def test_byte_file_rows_equal_reference(tmp_path, vocab):
    p = tmp_path / "corpus.txt"
    p.write_text("the quick brown fox jumps over the lazy dog; " * 20)
    kw = dict(batch=4, seq=24, vocab=vocab, seed=5)
    mine = pipeline.ByteFileLM(p, pipeline.DataConfig(**kw))
    theirs = ref.ByteFileLM(p, ref.DataConfig(**kw))
    for step in range(4):
        got = mine.batch_at(step)
        _equal(got, theirs.batch_at(step))
        assert got["tokens"].max() < vocab


@pytest.mark.parametrize("lens,seq", [([3, 9, 1, 40], 8), ([50], 64),
                                      ([], 4), ([7, 7, 7], 7)])
def test_pack_documents_equal_reference(lens, seq):
    docs = [np.arange(1, n + 1, dtype=np.int32) * (i + 1)
            for i, n in enumerate(lens)]
    got = pipeline.pack_documents(docs, seq, pad_id=0)
    np.testing.assert_array_equal(got, ref.pack_documents(docs, seq, 0))
    assert (got > 0).sum() == sum(lens)


def test_loader_order_equals_source():
    cfg = pipeline.DataConfig(batch=2, seq=8, vocab=64, prefetch=3)
    src = ref.SyntheticLM(ref.DataConfig(batch=2, seq=8, vocab=64))
    loader = pipeline.PrefetchingLoader(pipeline.SyntheticLM(cfg), cfg)
    try:
        for i in range(6):
            _equal(next(loader), src.batch_at(i))
    finally:
        loader.close()
    assert loader.backup_batches == 0


class _Slow:
    """A source whose worker-side batches take longer than the loader's
    straggler deadline."""

    def __init__(self, inner):
        self.inner = inner

    def batch_at(self, step):
        time.sleep(0.3)
        return self.inner.batch_at(step)


def test_loader_straggler_backup_is_the_same_batch():
    cfg = pipeline.DataConfig(batch=2, seq=8, vocab=64, prefetch=1,
                              straggler_deadline_s=0.05)
    src = pipeline.SyntheticLM(cfg)
    loader = pipeline.PrefetchingLoader(_Slow(src), cfg)
    try:
        for i in range(2):
            _equal(next(loader), src.batch_at(i))
    finally:
        loader.close()
    assert loader.backup_batches >= 1
