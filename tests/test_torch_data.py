"""The port's copy of the data pipeline: ports of the three data tests of
tests/test_substrate.py, and batches equal to the reference loader's."""
import numpy as np

from repro.data import pipeline as R
from repro_torch.data.pipeline import DataConfig, ShardedLoader, SyntheticCorpus


def test_corpus_deterministic_and_seekable():
    c = SyntheticCorpus(DataConfig(vocab_size=1000, seed=7))
    a = c.tokens_at(0, 5000)
    b = c.tokens_at(0, 5000)
    np.testing.assert_array_equal(a, b)
    # seek: arbitrary offset equals slice of longer read
    np.testing.assert_array_equal(c.tokens_at(1234, 100), a[1234:1334])
    assert a.min() >= 1 and a.max() < 1000


def test_loader_cursor_resume():
    cfg = DataConfig(vocab_size=500, seq_len=32, global_batch=2, seed=3)
    l1 = ShardedLoader(cfg)
    next(l1)
    next(l1)
    cur = l1.state()["cursor"]
    l1.close()
    # restart from the checkpointed cursor: next batch identical to b3
    l2 = ShardedLoader(cfg, start_cursor=cur)
    l1b = ShardedLoader(cfg)
    next(l1b), next(l1b)
    b3a = next(l1b)
    b3b = next(l2)
    np.testing.assert_array_equal(b3a["tokens"], b3b["tokens"])
    l2.close()
    l1b.close()


def test_targets_shift_by_one():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=1, seed=9)
    l = ShardedLoader(cfg)
    b = next(l)
    np.testing.assert_array_equal(b["tokens"][0, 1:], b["targets"][0, :-1])
    l.close()


def test_batches_equal_the_reference_loader():
    kw = dict(vocab_size=49152, seq_len=64, global_batch=3, seed=11,
              frontend_tokens=2, d_model=8)
    cursor = 5 * 3 * 65 + 17
    port = ShardedLoader(DataConfig(**kw), start_cursor=cursor)
    ref = R.ShardedLoader(R.DataConfig(**kw), start_cursor=cursor)
    try:
        for _ in range(3):
            a, b = next(port), next(ref)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            assert port.state() == ref.state()
    finally:
        port.close()
        ref.close()
