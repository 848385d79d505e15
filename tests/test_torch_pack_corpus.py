"""tpufw_torch.tools.pack_corpus against tpufw.tools.pack_corpus: the same
inputs give byte-identical corpora and stats, which the port's TokenCorpus
reads back; per-line mode and the CLI's stats line."""

import json

import numpy as np
import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.tools import pack_corpus as j_pack
from tpufw_torch.tools.pack_corpus import (
    byte_tokenizer,
    hf_tokenizer,
    main,
    pack_corpus,
)
from tpufw_torch.train import TokenCorpus


def test_byte_tokenizer_matches_tpufw():
    for text in ("ab", "héllo wörld", "", "\x00\n"):
        assert byte_tokenizer(text) == j_pack.byte_tokenizer(text)
    assert 0 not in byte_tokenizer("ab")


@pytest.fixture
def inputs(tmp_path):
    (tmp_path / "a.txt").write_text("hello world\nsecond line\n\nthird\n")
    (tmp_path / "b.jsonl").write_text(
        json.dumps({"text": "doc two"}) + "\n"
        + json.dumps({"text": "doc three"}) + "\n\n"
        + json.dumps("a bare string") + "\n")
    return [str(tmp_path / "a.txt"), str(tmp_path / "b.jsonl")]


@pytest.mark.parametrize("per_line", [False, True])
def test_corpus_bytes_equal_tpufw(tmp_path, inputs, per_line):
    mine = pack_corpus(inputs, str(tmp_path / "mine"), per_line=per_line)
    theirs = j_pack.pack_corpus(inputs, str(tmp_path / "theirs"),
                                per_line=per_line)
    assert {k: v for k, v in mine.items() if k not in ("bin", "idx")} == {
        k: v for k, v in theirs.items() if k not in ("bin", "idx")}
    for ext in (".bin", ".idx"):
        assert (tmp_path / f"mine{ext}").read_bytes() == (
            tmp_path / f"theirs{ext}").read_bytes()
    assert mine["n_docs"] == (6 if per_line else 4)


def test_round_trip_through_token_corpus(tmp_path, inputs):
    pack_corpus(inputs, str(tmp_path / "c"))
    batches = list(TokenCorpus(str(tmp_path / "c"), 2, 16, epochs=1))
    row, segs = batches[0]["tokens"][0], batches[0]["segment_ids"][0]
    first = row[segs == 1].tolist()
    assert bytes(b - 1 for b in first[:11]) == b"hello world"


def test_cli_prints_stats(tmp_path, capsys):
    (tmp_path / "a.txt").write_text("abc")
    assert main([str(tmp_path / "a.txt"), "--out", str(tmp_path / "c")]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["n_docs"] == 1 and stats["n_tokens"] == 3
    assert np.fromfile(tmp_path / "c.idx", np.uint64).tolist() == [0, 3]


def test_hf_tokenizer_reads_local_files_only(tmp_path):
    """A name that is not a local directory is not fetched."""
    with pytest.raises(FileNotFoundError, match="no hub download"):
        hf_tokenizer(str(tmp_path / "no-such-tokenizer"))
    with pytest.raises(FileNotFoundError):
        hf_tokenizer("gpt2")
