"""SARIF 2.1.0 output for the port's tpulint (``--sarif out.sarif``;
port of ``tpufw.analysis.sarif``).

SARIF is the interchange format GitHub code scanning ingests
(``github/codeql-action/upload-sarif``), so findings show up as PR
annotations with the same identity the baseline ratchet uses: the
``rule:path:symbol`` key is carried as a ``partialFingerprints`` entry,
which lets code scanning track a finding across line drift exactly like
the baseline does.

Only the subset of the (large) SARIF spec that code scanning reads is
emitted: tool.driver with per-rule metadata (the ported rules only), and
one ``result`` per finding with level, message, physical location, and
fingerprint. URIs are repo-relative with a SRCROOT base, which is what
the uploader expects when it resolves annotations against the
checked-out tree.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

from tpufw_torch.analysis.core import Checker, Finding, all_checkers

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

# SARIF "level" vocabulary; tpulint's "info" maps to SARIF's "note".
_LEVELS = {"error": "error", "warning": "warning", "info": "note"}

_RULE_HELP = {
    "TPU000": "file failed to parse; nothing else can be checked",
    "TPU001": "host sync (.item(), .cpu(), synchronize, I/O) in traced "
              "or captured code or in the step loop",
    "TPU004": "workload env var missing from the env registry",
    "TPU005": "observability event/metric name drift",
    "TPU009": "shared mutable attribute accessed across the thread "
              "boundary without the owning lock",
}


def _tool_rules(checkers: Sequence[Checker]) -> List[dict]:
    rules: List[dict] = [
        {
            "id": "TPU000",
            "name": "syntax-error",
            "shortDescription": {"text": _RULE_HELP["TPU000"]},
            "defaultConfiguration": {"level": "error"},
        }
    ]
    for c in checkers:
        rules.append(
            {
                "id": c.rule,
                "name": c.name,
                "shortDescription": {
                    "text": _RULE_HELP.get(c.rule, c.name)
                },
                "help": {
                    "text": f"See docs/torch/ANALYSIS.md, section {c.rule}."
                },
                "defaultConfiguration": {
                    "level": _LEVELS.get(c.severity, "error")
                },
            }
        )
    return rules


def to_sarif(findings: Sequence[Finding]) -> dict:
    checkers = all_checkers()
    rules = _tool_rules(checkers)
    index: Dict[str, int] = {r["id"]: i for i, r in enumerate(rules)}
    results: List[dict] = []
    for f in findings:
        res = {
            "ruleId": f.rule,
            "level": _LEVELS.get(f.severity, "error"),
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path,
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {
                            "startLine": max(1, f.line),
                            "startColumn": max(1, f.col),
                        },
                    }
                }
            ],
            # The baseline key doubles as the cross-commit identity
            # GitHub code scanning uses to dedupe across line drift.
            "partialFingerprints": {"tpulintKey/v1": f.key()},
        }
        if f.rule in index:
            res["ruleIndex"] = index[f.rule]
        results.append(res)
    return {
        "version": SARIF_VERSION,
        "$schema": SARIF_SCHEMA,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "tpulint",
                        "organization": "tpufw_torch",
                        "semanticVersion": "5.0.0",
                        "rules": rules,
                    }
                },
                "columnKind": "utf16CodeUnits",
                "results": results,
            }
        ],
    }


def write_sarif(path: str, findings: Sequence[Finding]) -> None:
    doc = to_sarif(findings)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
