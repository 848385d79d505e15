"""Corpus prep CLI (port of ``tpufw.tools.pack_corpus``): text files -> a
packed token corpus (<prefix>.bin/.idx) for ``TPUFW_DATA_PREFIX``.

    python -m tpufw_torch.tools.pack_corpus --out /data/corpus \\
        --tokenizer bytes file1.txt file2.jsonl

Tokenizers:
- ``--tokenizer bytes`` (default): byte-level ids (utf-8 byte + 1; 0 is
  reserved for padding), dependency-free and deterministic;
- ``--tokenizer <local dir>`` (or ``hf:<dir>``): a HuggingFace tokenizer
  through ``transformers.AutoTokenizer``, imported only on this path; it
  raises ImportError where ``transformers`` is not installed. Ids must fit
  the corpus's uint32.

Documents: one per line for ``.jsonl`` files (key ``text``) and for
``.txt`` files with ``--per-line``; otherwise a whole file is one
document. Empty documents are dropped.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
from typing import Iterator, List, Sequence


def byte_tokenizer(text: str) -> List[int]:
    """utf-8 byte ids shifted by 1 so id 0 stays the pad id."""
    return [b + 1 for b in text.encode("utf-8")]


def hf_tokenizer(name: str):
    """A local HuggingFace tokenizer directory (``hf:`` prefix optional)
    through ``transformers.AutoTokenizer``, local files only: the port's
    one import of ``transformers``, made here and only here. A name
    that is not a local directory raises FileNotFoundError: nothing is
    fetched from a hub."""
    path = name.removeprefix("hf:")
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"tokenizer {name!r}: 'bytes' or a local tokenizer directory "
            "(no hub download)")
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"tokenizer {name!r} needs the 'transformers' package, which is "
            f"not installed; use 'bytes' here ({e})"
        ) from e
    return AutoTokenizer.from_pretrained(path, local_files_only=True)


def iter_documents(
    paths: Sequence[str], per_line: bool = False
) -> Iterator[str]:
    """Yield raw document strings from .txt / .jsonl inputs."""
    for p in paths:
        path = pathlib.Path(p)
        if path.suffix == ".jsonl":
            with path.open() as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    doc = json.loads(ln)
                    text = doc["text"] if isinstance(doc, dict) else str(doc)
                    if text:
                        yield text
        elif per_line:
            with path.open() as f:
                for ln in f:
                    if ln.strip():
                        yield ln.rstrip("\n")
        else:
            text = path.read_text()
            if text:
                yield text


def pack_corpus(
    inputs: Sequence[str],
    out_prefix: str,
    tokenizer: str = "bytes",
    per_line: bool = False,
) -> dict:
    """Tokenize and write the corpus; returns summary stats."""
    from tpufw_torch.train.native_data import write_token_corpus

    encode = (
        byte_tokenizer if tokenizer == "bytes"
        else hf_tokenizer(tokenizer).encode
    )
    docs: List[List[int]] = []
    for text in iter_documents(inputs, per_line=per_line):
        ids = encode(text)
        if not ids:
            continue
        if any(i < 0 or i >= 2**32 for i in ids):
            raise ValueError(
                f"tokenizer {tokenizer!r} produced ids outside uint32"
            )
        docs.append(ids)
    if not docs:
        raise SystemExit("no non-empty documents found")
    bin_path, idx_path = write_token_corpus(out_prefix, docs)
    return {
        "bin": bin_path,
        "idx": idx_path,
        "n_docs": len(docs),
        "n_tokens": sum(len(d) for d in docs),
        "tokenizer": tokenizer,
    }


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpufw_torch.tools.pack_corpus",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("inputs", nargs="+", help=".txt / .jsonl files")
    ap.add_argument(
        "--out", required=True,
        help="output prefix (writes <out>.bin and <out>.idx)",
    )
    ap.add_argument(
        "--tokenizer", default="bytes",
        help="'bytes' (default) or a local HuggingFace tokenizer directory",
    )
    ap.add_argument(
        "--per-line", action="store_true",
        help="treat each line of .txt inputs as its own document",
    )
    args = ap.parse_args(argv)
    stats = pack_corpus(args.inputs, args.out, args.tokenizer, args.per_line)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
