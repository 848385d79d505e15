"""Tolerant Prometheus text-exposition parser + bit-exact renderer (a
copy of ``tpufw.obs.promtext``).

The fleet collector (``tpufw.obs.fleet``, ROADMAP.md item 13b in the
port) scrapes ``/metrics`` endpoints it does not control mid-write,
mid-restart, and mid-version-skew — so the parser is *tolerant*: any line that does not parse is
dropped, never raised. The renderer is the opposite: it re-emits a
parsed document byte-for-byte, and the round trip against
``Registry.render()``'s own exposition is pinned by tests — which is
what keeps this module and ``registry.py`` from drifting into two
dialects of the same format.

Shape model: a document is an ordered list of ``Family`` (one ``#
HELP``/``# TYPE`` header group), each holding ordered ``Sample`` rows.
Histogram families own their ``_bucket``/``_sum``/``_count`` samples.
Label order inside a sample is preserved as scraped; ``sample_key``
produces the *canonical* (sorted-label) form the series store keys on.

Stdlib only — importable from the collector daemon and bare CI
containers alike.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from tpufw_torch.obs.registry import _fmt, escape_help, escape_label_value

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")

#: Sample-name suffixes a typed family may own beyond its bare name.
_FAMILY_SUFFIXES = {
    "histogram": ("_bucket", "_sum", "_count"),
    "summary": ("_sum", "_count"),
}


def _unescape(s: str, quoted: bool = False) -> str:
    """Invert exposition escaping: ``\\\\`` -> ``\\``, ``\\n`` ->
    newline, and (inside quoted label values only) ``\\"`` -> ``"``."""
    if "\\" not in s:
        return s
    out: List[str] = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if quoted and nxt == '"':
                out.append('"')
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def format_value(v: float) -> str:
    """Exposition value text matching ``registry._fmt``, extended with
    the spec spellings for non-finite floats (the registry never emits
    those, but a scraped document may round-trip them)."""
    if v != v:  # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return _fmt(v)


@dataclass
class Sample:
    """One exposition row. ``labels`` keep scrape order; ``raw`` is
    the value text exactly as scraped (the renderer re-emits it, so
    float formatting can never drift through a round trip)."""

    name: str
    labels: Tuple[Tuple[str, str], ...]
    value: float
    raw: str = ""
    timestamp: str = ""

    def labels_dict(self) -> Dict[str, str]:
        return dict(self.labels)

    def key(self) -> str:
        return sample_key(self.name, dict(self.labels))


@dataclass
class Family:
    """A ``# HELP``/``# TYPE`` header group and its samples. ``help``
    is the *unescaped* text; ``None`` means no HELP line was seen
    (distinct from an empty one, for bit-exact re-rendering)."""

    name: str
    kind: str = ""
    help: Optional[str] = None
    samples: List[Sample] = field(default_factory=list)

    def owns(self, sample_name: str) -> bool:
        if sample_name == self.name:
            return True
        for suffix in _FAMILY_SUFFIXES.get(self.kind, ()):
            if sample_name == self.name + suffix:
                return True
        return False


def sample_key(name: str, labels: Dict[str, str]) -> str:
    """Canonical series key: name + sorted, escaped labels — the
    exposition spelling the registry itself would use, so store keys
    and scraped lines agree char-for-char."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{escape_label_value(str(v))}"'
        for k, v in sorted(labels.items())
    )
    return f"{name}{{{inner}}}"


def parse_sample_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Invert ``sample_key`` (tolerant: a bare name parses as no
    labels; malformed label blocks yield whatever prefix parsed)."""
    brace = key.find("{")
    if brace < 0:
        return key, {}
    labels, _ = _parse_labels(key[brace:])
    return key[:brace], dict(labels)


def _parse_labels(
    s: str,
) -> Tuple[Tuple[Tuple[str, str], ...], Optional[int]]:
    """Parse ``{k="v",...}`` at the start of ``s``. Returns
    (label pairs, index just past the closing brace) — index ``None``
    when the block is malformed (caller drops the line)."""
    assert s[0] == "{"
    pairs: List[Tuple[str, str]] = []
    i = 1
    while True:
        while i < len(s) and s[i] in " \t":
            i += 1
        if i < len(s) and s[i] == "}":
            return tuple(pairs), i + 1
        m = _NAME_RE.match(s, i)
        if m is None:
            return tuple(pairs), None
        name = m.group(0)
        i = m.end()
        while i < len(s) and s[i] in " \t":
            i += 1
        if i >= len(s) or s[i] != "=":
            return tuple(pairs), None
        i += 1
        while i < len(s) and s[i] in " \t":
            i += 1
        if i >= len(s) or s[i] != '"':
            return tuple(pairs), None
        i += 1
        buf: List[str] = []
        while i < len(s):
            c = s[i]
            if c == "\\" and i + 1 < len(s):
                nxt = s[i + 1]
                if nxt == "\\":
                    buf.append("\\")
                elif nxt == "n":
                    buf.append("\n")
                elif nxt == '"':
                    buf.append('"')
                else:
                    buf.append(c)
                    buf.append(nxt)
                i += 2
                continue
            if c == '"':
                break
            buf.append(c)
            i += 1
        else:
            return tuple(pairs), None  # unterminated value
        i += 1  # past closing quote
        pairs.append((name, "".join(buf)))
        while i < len(s) and s[i] in " \t":
            i += 1
        if i < len(s) and s[i] == ",":
            i += 1
            continue
        if i < len(s) and s[i] == "}":
            return tuple(pairs), i + 1
        return tuple(pairs), None


def _parse_sample_line(line: str) -> Optional[Sample]:
    m = _NAME_RE.match(line)
    if m is None:
        return None
    name = m.group(0)
    rest = line[m.end():]
    labels: Tuple[Tuple[str, str], ...] = ()
    if rest.startswith("{"):
        labels, end = _parse_labels(rest)
        if end is None:
            return None
        rest = rest[end:]
    parts = rest.split()
    if not parts or len(parts) > 2:
        return None
    raw = parts[0]
    try:
        value = float(raw)
    except ValueError:
        return None
    return Sample(
        name=name,
        labels=labels,
        value=value,
        raw=raw,
        timestamp=parts[1] if len(parts) == 2 else "",
    )


def parse(text: str) -> List[Family]:
    """Parse an exposition document into ordered families. Tolerant:
    unparseable lines (torn writes, foreign comment syntax) are
    dropped; samples with no preceding TYPE get an untyped family of
    their own."""
    families: List[Family] = []
    current: Optional[Family] = None
    for line in text.split("\n"):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "HELP":
                name = parts[2]
                help_text = _unescape(parts[3]) if len(parts) > 3 else ""
                if current is None or current.name != name:
                    current = Family(name)
                    families.append(current)
                current.help = help_text
            elif len(parts) >= 4 and parts[1] == "TYPE":
                name = parts[2]
                if current is None or current.name != name:
                    current = Family(name)
                    families.append(current)
                current.kind = parts[3]
            # other comments: dropped (tolerance over fidelity)
            continue
        sample = _parse_sample_line(line)
        if sample is None:
            continue
        if current is None or not current.owns(sample.name):
            current = Family(sample.name)
            families.append(current)
        current.samples.append(sample)
    return families


def render(families: Iterable[Family]) -> str:
    """Re-emit families as exposition text. Raw value text and label
    order are preserved, so ``render(parse(x))`` is byte-identical for
    any ``x`` the registry produced."""
    lines: List[str] = []
    for fam in families:
        if fam.help is not None:
            lines.append(f"# HELP {fam.name} {escape_help(fam.help)}")
        if fam.kind:
            lines.append(f"# TYPE {fam.name} {fam.kind}")
        for s in fam.samples:
            if s.labels:
                inner = ",".join(
                    f'{k}="{escape_label_value(v)}"' for k, v in s.labels
                )
                head = f"{s.name}{{{inner}}}"
            else:
                head = s.name
            raw = s.raw if s.raw else format_value(s.value)
            line = f"{head} {raw}"
            if s.timestamp:
                line += f" {s.timestamp}"
            lines.append(line)
    return "\n".join(lines) + "\n" if lines else ""


def flatten(
    text_or_families, *, drop_buckets: bool = True
) -> Dict[str, float]:
    """Canonical-key -> value map of a document, the shape the series
    store records. Histogram ``_bucket`` rows are dropped by default
    (their cardinality would dominate every record; ``_sum``/``_count``
    carry the rate math the fleet layer actually uses)."""
    families = (
        parse(text_or_families)
        if isinstance(text_or_families, str)
        else text_or_families
    )
    out: Dict[str, float] = {}
    for fam in families:
        for s in fam.samples:
            if drop_buckets and s.name.endswith("_bucket") and any(
                k == "le" for k, _ in s.labels
            ):
                continue
            out[s.key()] = s.value
    return out
