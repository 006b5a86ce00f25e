"""The port's copy of the synthetic data stream
(``repro_torch.data.pipeline``) against the reference's: byte-equal
batches for every (seed, host, step), and the reference's own data tests
(``tests/test_data_optimizer.py::TestData``) on the copy."""
import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


def _pair(**kw):
    return (jpipe.SyntheticLMStream(jpipe.DataConfig(**kw)),
            tpipe.SyntheticLMStream(tpipe.DataConfig(**kw)))


@pytest.mark.parametrize("seed", (0, 1, 7))
@pytest.mark.parametrize("hosts,host", ((1, 0), (2, 0), (2, 1), (4, 3)))
def test_batches_byte_equal_to_reference(seed, hosts, host):
    ref, port = _pair(vocab_size=300, seq_len=96, global_batch=8, seed=seed,
                      mean_doc_len=32, num_hosts=hosts, host_id=host)
    assert port.local_batch == ref.local_batch == 8 // hosts
    for step in (0, 1, 5, 123):
        a, b = ref.batch(step), port.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (k, step)


def test_iterators_match_reference():
    ref, port = _pair(vocab_size=128, seq_len=64, global_batch=4, seed=3)
    for a, b in zip(ref.batches(2, 3), port.batches(2, 3)):
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    it_a, it_b = iter(ref), iter(port)
    for _ in range(2):
        a, b = next(it_a), next(it_b)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert tpipe.EOS == jpipe.EOS == 0


def test_deterministic_in_seed_host_step():
    a = tpipe.SyntheticLMStream(tpipe.DataConfig(256, 64, 4, seed=1)).batch(3)
    b = tpipe.SyntheticLMStream(tpipe.DataConfig(256, 64, 4, seed=1)).batch(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = tpipe.SyntheticLMStream(tpipe.DataConfig(256, 64, 4, seed=2)).batch(3)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_shapes_labels_and_mask():
    d = tpipe.SyntheticLMStream(tpipe.DataConfig(256, 64, 4)).batch(0)
    assert d["tokens"].shape == (4, 64) == d["labels"].shape
    np.testing.assert_array_equal(d["tokens"][:, 1:], d["labels"][:, :-1])
    np.testing.assert_array_equal(d["mask"], d["labels"] != tpipe.EOS)
    d = tpipe.SyntheticLMStream(tpipe.DataConfig(100, 128, 2)).batch(5)
    assert d["tokens"].min() >= 0 and d["tokens"].max() < 100
