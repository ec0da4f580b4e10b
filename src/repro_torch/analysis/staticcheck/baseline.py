"""Baseline file: grandfathered findings that don't fail the build.

Format — one finding per line, comments and blanks ignored (the JAX
package's checker reads and writes the same format):

    RULE_ID  path  fingerprint    # why this is grandfathered

The fingerprint is ``sha1(stripped source line)[:12]``, not a line
number, so unrelated edits above a finding don't invalidate its
baseline entry; editing the flagged line itself does (on purpose —
touched code must come clean). Entries whose finding disappeared are
reported as stale so the file shrinks over time instead of rotting.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Set, Tuple

from .core import Finding


def fingerprint(finding: Finding, source_lines: List[str]) -> str:
    try:
        text = source_lines[finding.line - 1].strip()
    except IndexError:
        text = ""
    return hashlib.sha1(text.encode()).hexdigest()[:12]


def entry_key(finding: Finding, source_lines: List[str]) -> Tuple[str, str,
                                                                  str]:
    path = finding.path.replace("\\", "/")
    return (finding.rule, path, fingerprint(finding, source_lines))


def load(path: str) -> Set[Tuple[str, str, str]]:
    return set(load_reasons(path))


def load_reasons(path: str) -> Dict[Tuple[str, str, str], str]:
    """Every entry of the file with its ``# reason`` ("" where none)."""
    out: Dict[Tuple[str, str, str], str] = {}
    with open(path, encoding="utf-8") as fh:
        for raw in fh:
            line, _, reason = raw.partition("#")
            parts = line.split()
            if len(parts) >= 3:
                out[(parts[0], parts[1].replace("\\", "/"), parts[2])] = \
                    reason.strip()
    return out


def render(findings: Iterable[Tuple[Finding, List[str]]]) -> str:
    lines = ["# staticcheck baseline — RULE_ID path fingerprint  # reason",
             "# regenerate: python -m repro_torch.analysis.staticcheck "
             "--write-baseline <paths>"]
    for finding, src in findings:
        rid, path, fp = entry_key(finding, src)
        lines.append(f"{rid}  {path}  {fp}  # {finding.message}")
    return "\n".join(lines) + "\n"


def split(findings: Iterable[Finding], src_lines: Dict[str, List[str]],
          known: Set[Tuple[str, str, str]]
          ) -> Tuple[List[Finding], List[Finding], Set[Tuple[str, str, str]]]:
    """(fresh findings, baselined findings, stale entries of ``known``)."""
    fresh: List[Finding] = []
    held: List[Finding] = []
    seen: Set[Tuple[str, str, str]] = set()
    for f in findings:
        key = entry_key(f, src_lines.get(f.path, []))
        seen.add(key)
        (held if key in known else fresh).append(f)
    return fresh, held, known - seen
