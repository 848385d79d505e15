"""CLI for the port's tpulint: ``python -m tpufw_torch.analysis [paths...]``
(port of ``tpufw.analysis.__main__``).

Exit codes: 0 = clean (or everything baselined), 1 = new findings,
2 = usage error. With no paths the scan set is the port's code:
``tpufw_torch/``, ``scripts/*_torch.py`` and ``chip_smoke.py``.
``tpufw_torch/analysis/baseline.json`` is applied automatically when
present (``--no-baseline`` for the raw view); the baseline may only
shrink — regenerate it with ``--write-baseline`` only to *remove* fixed
entries.

``--sarif out.sarif`` additionally writes the gating findings as
SARIF 2.1.0 for GitHub code scanning. ``--cache`` enables the
whole-scan replay cache (see :mod:`tpufw_torch.analysis.incremental`),
and ``--since <ref>`` gates the exit code on findings in files changed
since ``ref`` — the pre-commit fast path.

``--layer {python,all}`` (default ``all``, every ported layer) selects
the rules; ``TPUFW_LINT_LAYERS`` (a comma list) picks the default when
``--layer`` is not given. ``tpufw``'s other layers exit 2 with the
reason: ``protocol`` and ``lifetime`` are item 13d(b), and ``deploy``
is ``tpufw``'s own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from tpufw_torch.analysis import core, incremental

DEFAULT_BASELINE = "tpufw_torch/analysis/baseline.json"


def _default_paths(root: str) -> List[str]:
    """The port's code: the package, its scripts (``scripts/*_torch.py``)
    and ``chip_smoke.py``."""
    out = [
        os.path.join(root, p) for p in ("tpufw_torch", "chip_smoke.py")
        if os.path.exists(os.path.join(root, p))
    ]
    scripts = os.path.join(root, "scripts")
    if os.path.isdir(scripts):
        out += [
            os.path.join(scripts, fn) for fn in sorted(os.listdir(scripts))
            if fn.endswith("_torch.py")
        ]
    return out


def _layers(arg: str | None) -> List[str]:
    """The requested layers: ``--layer``, else ``TPUFW_LINT_LAYERS``.
    Raises ValueError naming the source for a layer the port does not
    run."""
    if arg is not None:
        core.check_layer(arg)
        return [arg]
    from tpufw_torch.workloads.env import env_str

    layers = [
        part.strip()
        for part in env_str("lint_layers", "all").split(",")
        if part.strip()
    ] or ["all"]
    for part in layers:
        try:
            core.check_layer(part)
        except ValueError as e:
            raise ValueError(f"TPUFW_LINT_LAYERS: {e}") from None
    return layers


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpufw_torch.analysis",
        description="tpulint for the PyTorch port: static analysis",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help=(
            "files/directories to scan (default: tpufw_torch, "
            "scripts/*_torch.py, chip_smoke.py)"
        ),
    )
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument(
        "--rules",
        help="comma-separated rule subset (e.g. TPU001,TPU004)",
    )
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument(
        "--layer",
        default=None,
        help=(
            "scan layer: python = the ast rules over .py files, all = "
            "every ported layer (default). protocol, lifetime and deploy "
            "are not run by the port (exit 2). Unset, TPUFW_LINT_LAYERS "
            "(comma list) picks the default"
        ),
    )
    ap.add_argument(
        "--baseline",
        default=None,
        help=f"baseline file (default: <root>/{DEFAULT_BASELINE} if present)",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore any baseline; report every finding",
    )
    ap.add_argument(
        "--write-baseline",
        metavar="PATH",
        help="write current findings as the new baseline and exit 0",
    )
    ap.add_argument(
        "--sarif",
        metavar="PATH",
        help="also write gating findings as SARIF 2.1.0",
    )
    ap.add_argument(
        "--cache",
        nargs="?",
        const=incremental.DEFAULT_CACHE,
        default=None,
        metavar="PATH",
        help=(
            "replay cache file (default "
            f"<root>/{incremental.DEFAULT_CACHE}); an exact "
            "signature hit skips the scan entirely"
        ),
    )
    ap.add_argument(
        "--since",
        metavar="REF",
        help=(
            "gate the exit code only on findings in files changed "
            "since REF (committed or not); the full tree is still "
            "analyzed so cross-file rules stay sound"
        ),
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        checkers = core.all_checkers()
        by_layer: dict = {}
        for c in checkers:
            by_layer.setdefault(c.layer, []).append(c)
        # Present layers in the canonical LAYERS order so the output
        # is stable for tooling that diffs it.
        order = [l for l in core.LAYERS if l in by_layer]
        order += [l for l in by_layer if l not in order]
        for layer in order:
            print(f"layer {layer}:")
            for c in by_layer[layer]:
                print(f"  {c.rule}  {c.name}  [{c.severity}]")
        for layer, why in core.UNPORTED_LAYERS.items():
            print(f"layer {layer}: {why}")
        return 0

    try:
        layers = _layers(args.layer)
    except ValueError as e:
        print(f"tpulint: {e}", file=sys.stderr)
        return 2
    root = core.find_repo_root(args.paths[0] if args.paths else ".")
    paths = args.paths or _default_paths(root)
    if not paths:
        print("tpulint: nothing to scan", file=sys.stderr)
        return 2
    layer_spec = ",".join(layers)
    rules = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules
        else None
    )
    cache_path = None
    if args.cache is not None:
        cache_path = (
            os.path.join(root, args.cache)
            if args.cache == incremental.DEFAULT_CACHE
            else args.cache
        )

    findings = None
    signature = None
    if cache_path is not None:
        signature = incremental.scan_signature(
            root, core.iter_py_files(paths, root), rules,
            layer=layer_spec,
        )
        findings = incremental.load_cached(cache_path, signature)
        if findings is not None:
            print(
                f"tpulint: replayed {len(findings)} finding(s) from "
                f"cache {os.path.relpath(cache_path, root)}",
                file=sys.stderr,
            )
    if findings is None:
        try:
            findings = []
            seen = set()
            for layer in layers:
                for f in core.run_analysis(
                    paths, root=root, rules=rules, layer=layer,
                ):
                    # Layers overlap ("all" subsumes the rest) — one
                    # finding, one report.
                    k = (f.key(), f.line)
                    if k not in seen:
                        seen.add(k)
                        findings.append(f)
            if len(layers) > 1:
                findings.sort(key=lambda f: (f.path, f.line, f.rule))
        except ValueError as e:
            print(f"tpulint: {e}", file=sys.stderr)
            return 2
        if cache_path is not None and signature is not None:
            incremental.save_cache(cache_path, signature, findings)

    if args.write_baseline:
        core.write_baseline(args.write_baseline, findings)
        print(
            f"tpulint: wrote baseline with {len(findings)} finding(s) "
            f"to {args.write_baseline}"
        )
        return 0

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    baseline = set()
    if not args.no_baseline and os.path.exists(baseline_path):
        try:
            baseline = core.load_baseline(baseline_path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"tpulint: bad baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
    new, old, stale = core.split_by_baseline(findings, baseline)

    since_excluded = 0
    if args.since:
        changed = incremental.changed_files(root, args.since)
        if changed is None:
            print(
                f"tpulint: --since {args.since}: git could not "
                "resolve the ref; gating on all findings",
                file=sys.stderr,
            )
        else:
            kept = incremental.filter_since(new, changed)
            since_excluded = len(new) - len(kept)
            new = kept

    if args.sarif:
        from tpufw_torch.analysis import sarif

        sarif.write_sarif(args.sarif, new)

    if args.json:
        # Tooling partitions results by layer without re-parsing rule
        # IDs; TPU000 parse errors belong to every layer -> "core".
        layer_of = {c.rule: c.layer for c in core.all_checkers()}

        def as_dict(f):
            d = f.as_dict()
            d["layer"] = layer_of.get(f.rule, "core")
            return d

        print(
            json.dumps(
                {
                    "findings": [as_dict(f) for f in new],
                    "baselined": [as_dict(f) for f in old],
                    "stale_baseline_keys": sorted(stale),
                },
                indent=2,
            )
        )
    else:
        for f in new:
            print(f.render())
        if old:
            print(
                f"tpulint: {len(old)} pre-existing finding(s) tolerated "
                f"by baseline {os.path.relpath(baseline_path, root)}"
            )
        if stale:
            print(
                f"tpulint: {len(stale)} baseline entr"
                f"{'y is' if len(stale) == 1 else 'ies are'} no longer "
                "observed — shrink the baseline "
                "(python -m tpufw_torch.analysis --write-baseline "
                f"{os.path.relpath(baseline_path, root)}):"
            )
            for k in sorted(stale):
                print(f"  stale: {k}")
        if since_excluded:
            print(
                f"tpulint: {since_excluded} finding(s) outside "
                f"--since {args.since} not gating this run"
            )
        if not new:
            print(
                f"tpulint: clean ({len(findings)} finding(s) total, "
                f"{len(old)} baselined)"
            )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
