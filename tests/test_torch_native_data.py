"""tpufw_torch.train.native_data and prefetch, mirroring
tests/test_native_data.py: the port builds libtpufwdata from the repo's
native/dataloader source (g++, into build-torch/) and its TokenCorpus
matches tpufw's pack_documents and tpufw's own TokenCorpus over the same
library, shuffled or not; its Python path matches tpufw's fallback. A
library that cannot load raises (no silent fallback). prefetch_to_device
on the CPU: batches, source errors, an abandoned consumer."""

import shutil
import threading

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.train import TokenCorpus as JTokenCorpus
from tpufw.train import pack_documents as j_pack_documents
from tpufw_torch.train import (
    TokenCorpus,
    prefetch_to_device,
    write_token_corpus,
)
from tpufw_torch.train.native_data import load_library

DOCS = [
    list(range(1, 20)),
    list(range(100, 107)),
    [],  # an empty doc is skipped, not a segment
    list(range(200, 249)),
    [7],
]


@pytest.fixture(scope="session")
def lib_path():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build libtpufwdata from native/dataloader")
    from tpufw_torch.ops._build import data_library_path

    return str(data_library_path())


@pytest.fixture()
def corpus(tmp_path):
    prefix = str(tmp_path / "corpus")
    write_token_corpus(prefix, DOCS)
    return prefix


def _equal(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k])


def test_native_matches_tpufw_pack_documents(lib_path, corpus):
    corpus_ = TokenCorpus(corpus, 2, 16, epochs=1, lib_path=lib_path)
    assert corpus_.native
    _equal(list(corpus_),
           list(j_pack_documents((np.asarray(d) for d in DOCS), 2, 16)))


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_matches_tpufw_token_corpus_on_the_same_library(
        lib_path, tmp_path, shuffle):
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 1000, rng.integers(1, 60)) for _ in range(80)]
    prefix = str(tmp_path / "c")
    write_token_corpus(prefix, docs)
    kw = dict(shuffle=shuffle, seed=5, epochs=2)
    mine = list(TokenCorpus(prefix, 4, 32, lib_path=lib_path, **kw))
    theirs = list(JTokenCorpus(prefix, 4, 32, lib_path=lib_path, **kw))
    _equal(mine, theirs)
    # Shards too: a disjoint round-robin subset each.
    kw = dict(shuffle=shuffle, seed=5)
    for shard in (0, 1):
        a = TokenCorpus(prefix, 2, 32, lib_path=lib_path, shard_id=shard,
                        num_shards=2, **kw)
        b = JTokenCorpus(prefix, 2, 32, lib_path=lib_path, shard_id=shard,
                         num_shards=2, **kw)
        _equal([x for x, _ in zip(a, range(6))],
               [x for x, _ in zip(b, range(6))])


@pytest.mark.parametrize("shuffle", [False, True])
def test_python_path_matches_tpufw_fallback(corpus, shuffle):
    mine = list(TokenCorpus(corpus, 2, 16, epochs=2, shuffle=shuffle,
                            seed=3, native=False))
    theirs = list(JTokenCorpus(corpus, 2, 16, epochs=2, shuffle=shuffle,
                               seed=3, lib_path="/nonexistent"))
    _equal(mine, theirs)


def test_native_equals_python_without_shuffle(lib_path, corpus):
    _equal(list(TokenCorpus(corpus, 2, 16, epochs=1, lib_path=lib_path)),
           list(TokenCorpus(corpus, 2, 16, epochs=1, native=False)))


def test_no_tokens_dropped_and_epochs_stream(lib_path, corpus):
    one = list(TokenCorpus(corpus, 2, 16, epochs=1, lib_path=lib_path))
    assert sum(int(b["loss_mask"].sum()) for b in one) == sum(map(len, DOCS))
    three = list(TokenCorpus(corpus, 2, 16, epochs=3, lib_path=lib_path))
    assert len(three) == 3 * len(one)
    np.testing.assert_array_equal(three[len(one)]["tokens"], one[0]["tokens"])


def test_missing_library_raises_instead_of_falling_back(corpus, tmp_path):
    with pytest.raises(FileNotFoundError, match="libtpufwdata"):
        TokenCorpus(corpus, 2, 16, lib_path=str(tmp_path / "nope.so"))


def test_library_env_override(lib_path, monkeypatch):
    monkeypatch.setenv("TPUFWDATA_LIB", lib_path)
    assert load_library() is load_library(lib_path)


def test_open_rejects_corrupt_idx(lib_path, tmp_path):
    prefix = str(tmp_path / "bad")
    write_token_corpus(prefix, [[1, 2, 3]])
    with open(prefix + ".bin", "wb") as f:
        f.write(b"\x00" * 4)
    with pytest.raises(FileNotFoundError, match="does not match"):
        list(TokenCorpus(prefix, 1, 8, epochs=1, lib_path=lib_path))


def test_prefetch_on_cpu(lib_path, corpus):
    host = list(TokenCorpus(corpus, 2, 16, epochs=1, lib_path=lib_path))
    out = list(prefetch_to_device(iter(host), "cpu", buffer_size=1))
    assert len(out) == len(host)
    for o, h in zip(out, host):
        for k in h:
            assert isinstance(o[k], torch.Tensor) and o[k].device.type == "cpu"
            np.testing.assert_array_equal(o[k].numpy(), h[k])


def test_prefetch_propagates_source_error():
    def bad():
        yield {"tokens": np.zeros((8, 4), np.int32)}
        raise RuntimeError("source blew up")

    it = prefetch_to_device(bad(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="source blew up"):
        list(it)


def test_abandoned_consumer_stops_the_thread_and_closes_the_source():
    closed = threading.Event()

    def endless():
        try:
            while True:
                yield {"tokens": np.ones((2, 4), np.int32)}
        finally:
            closed.set()

    it = prefetch_to_device(endless(), "cpu", buffer_size=2)
    next(it), next(it)
    it.close()
    assert closed.wait(5)
    assert not any(t.name == "tpufw-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_prefetch_depth_from_env(monkeypatch):
    monkeypatch.setenv("TPUFW_PREFETCH_DEPTH", "3")
    pulled = []

    def source():
        for i in range(10):
            pulled.append(i)
            yield {"tokens": np.full((1, 2), i, np.int32)}

    it = prefetch_to_device(source(), "cpu")
    first = next(it)
    # The thread runs ahead by the queue's depth (3) and one batch in hand.
    deadline = 50
    while len(pulled) < 5 and deadline:
        threading.Event().wait(0.02)
        deadline -= 1
    assert int(first["tokens"][0, 0]) == 0 and len(pulled) == 5
    it.close()


def test_prefetch_keeps_order_under_thread_switching():
    """A short switch interval forces the worker and the consumer to
    interleave at every bytecode: no batch is lost, repeated or
    reordered."""
    import sys

    n = 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = [int(b["i"][0]) for b in prefetch_to_device(
            ({"i": np.array([i])} for i in range(n)), "cpu", buffer_size=1)]
    finally:
        sys.setswitchinterval(old)
    assert out == list(range(n))
