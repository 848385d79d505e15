"""Incremental tpulint for the port: replay cache (``--cache``) and
change gating (``--since <ref>``); port of ``tpufw.analysis.incremental``.

Every rule worth having here is cross-file (the callgraph, the env and
obs catalogs), so a per-file "only re-lint what changed" scheme is
unsound. The honest incremental contract is a *whole-scan replay
cache*: the cache records a signature of everything the analysis can
observe — per-file content hashes of the scan set, the analyzer's own
sources, the rule selection, and the out-of-scan catalog docs checkers
read — and a hit replays the previous findings without parsing or
running a single checker. Any drift in any input misses and the full
scan runs (then refreshes the cache).

``--since <ref>`` is orthogonal: the full tree is still *analyzed*
(cross-file rules need it), but only findings located in files changed
since ``ref`` (committed or not) gate the exit code.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
from typing import List, Optional, Sequence, Set

from tpufw_torch.analysis.core import ENV_DOC_PAGES, Finding

CACHE_VERSION = 1
DEFAULT_CACHE = ".tpulint_torch_cache.json"

# Out-of-scan documents checkers read via Project.read_doc; a change
# here changes findings, so they are part of the signature.
_CONTEXT_DOCS = ENV_DOC_PAGES


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:20]


def _file_sha(path: str) -> Optional[str]:
    try:
        with open(path, "rb") as fh:
            return _sha(fh.read())
    except OSError:
        return None


def analyzer_signature() -> str:
    """One hash over every .py in tpufw_torch/analysis — a rule edit
    must invalidate the cache even when no scanned file changed."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for name in sorted(os.listdir(pkg)):
        if not name.endswith(".py"):
            continue
        h.update(name.encode())
        digest = _file_sha(os.path.join(pkg, name))
        h.update((digest or "?").encode())
    return h.hexdigest()[:20]


def scan_signature(
    root: str,
    py_files: Sequence[tuple],
    rules: Optional[Sequence[str]],
    layer: str = "all",
) -> dict:
    """Signature over everything the analysis observes. ``py_files``
    is :func:`core.iter_py_files` output — hashing raw bytes here is
    what lets a cache hit skip parsing entirely."""
    return {
        "version": CACHE_VERSION,
        "analyzer": analyzer_signature(),
        "rules": sorted(rules) if rules is not None else "all",
        "layer": layer,
        "docs": {
            d: _file_sha(os.path.join(root, d)) for d in _CONTEXT_DOCS
        },
        "files": {rel: _file_sha(ap) for ap, rel in py_files},
    }


def load_cached(path: str, signature: dict) -> Optional[List[Finding]]:
    """Previous findings iff the cached signature matches exactly."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if data.get("signature") != signature:
        return None
    try:
        return [Finding(**f) for f in data.get("findings", [])]
    except TypeError:
        return None


def save_cache(
    path: str, signature: dict, findings: Sequence[Finding]
) -> None:
    data = {
        "comment": "tpulint replay cache — safe to delete, never commit",
        "signature": signature,
        "findings": [dataclasses.asdict(f) for f in findings],
    }
    try:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh)
            fh.write("\n")
    except OSError:
        pass  # a read-only tree just means no cache, not a failure


# ------------------------------------------------------------- --since

def changed_files(root: str, since: str) -> Optional[Set[str]]:
    """Repo-relative paths changed since ``since``: committed diff,
    staged, unstaged, and untracked. None when git can't answer (bad
    ref, not a checkout) — the caller falls back to a full gate."""
    out: Set[str] = set()
    cmds = (
        ["git", "diff", "--name-only", since, "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    )
    for cmd in cmds:
        try:
            res = subprocess.run(
                cmd,
                cwd=root,
                capture_output=True,
                text=True,
                timeout=30,
                check=True,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        out.update(
            line.strip().replace(os.sep, "/")
            for line in res.stdout.splitlines()
            if line.strip()
        )
    return out


def filter_since(
    findings: Sequence[Finding], changed: Set[str]
) -> List[Finding]:
    return [f for f in findings if f.path in changed]
