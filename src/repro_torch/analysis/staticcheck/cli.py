"""CLI: ``python -m repro_torch.analysis.staticcheck [paths] [options]``.

Exit codes: 0 clean (or everything baselined), 1 unbaselined findings,
2 usage error. ``--github-summary FILE`` appends a markdown findings
table. The default baseline is the port's own
``staticcheck-torch-baseline.txt``; the JAX package's
``staticcheck-baseline.txt`` is never read unless passed by name.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from . import baseline as baseline_mod
from .core import RULES, Finding, Project, run_rules

DEFAULT_BASELINE = "staticcheck-torch-baseline.txt"
DEFAULT_PATH = "src/repro_torch"


def _split_ids(value: Optional[str]) -> Optional[set]:
    if not value:
        return None
    ids = {v.strip() for v in value.replace(",", " ").split() if v.strip()}
    unknown = ids - set(RULES)
    if unknown:
        raise SystemExit(
            f"staticcheck: unknown rule id(s): {', '.join(sorted(unknown))} "
            f"(have: {', '.join(sorted(RULES))})")
    return ids


def _github_table(findings: List[Finding], n_baselined: int) -> str:
    lines = ["## staticcheck (repro_torch)", ""]
    if not findings:
        lines.append(f"No findings ({n_baselined} baselined). "
                     f"{len(RULES)} rules active.")
    else:
        lines += ["| location | rule | message | fix |",
                  "|---|---|---|---|"]
        for f in findings:
            msg = f.message.replace("|", "\\|")
            hint = f.hint.replace("|", "\\|")
            lines.append(f"| `{f.path}:{f.line}` | {f.rule} | {msg} "
                         f"| {hint} |")
        lines.append("")
        lines.append(f"**{len(findings)} finding(s)** "
                     f"({n_baselined} baselined).")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.staticcheck",
        description="the PyTorch port's AST checker for host syncs, "
                    "capture hazards, kernel fallbacks and page lifetimes")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files or directories to scan (default: "
                         f"{DEFAULT_PATH})")
    ap.add_argument("--select", help="comma-separated rule ids to run")
    ap.add_argument("--ignore", help="comma-separated rule ids to skip")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: ./{DEFAULT_BASELINE} "
                         "when present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current findings to the baseline file "
                         "and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--github-summary", metavar="FILE",
                    help="append a markdown findings table to FILE")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            print(f"{rid}  {RULES[rid].summary}")
        return 0

    paths = args.paths or [DEFAULT_PATH]
    for p in paths:
        if not os.path.exists(p):
            print(f"staticcheck: no such path: {p}", file=sys.stderr)
            return 2

    try:
        select = _split_ids(args.select)
        ignore = _split_ids(args.ignore)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 2

    project = Project(paths)
    findings = run_rules(project, select=select, ignore=ignore)
    src_lines = {m.relpath: m.lines for m in project.iter_modules()}

    if args.write_baseline:
        out = args.baseline or DEFAULT_BASELINE
        pairs = [(f, src_lines.get(f.path, [])) for f in findings]
        with open(out, "w", encoding="utf-8") as fh:
            fh.write(baseline_mod.render(pairs))
        print(f"staticcheck: wrote {len(findings)} entries to {out}")
        return 0

    baseline_path = args.baseline or (
        DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None)
    known = baseline_mod.load(baseline_path) if baseline_path else set()
    fresh, held, stale = baseline_mod.split(findings, src_lines, known)

    for f in fresh:
        print(f.render())
    for rid, path, fp in sorted(stale):
        print(f"staticcheck: stale baseline entry {rid} {path} {fp} — "
              "finding no longer present, remove it", file=sys.stderr)

    if args.github_summary:
        with open(args.github_summary, "a", encoding="utf-8") as fh:
            fh.write(_github_table(fresh, len(held)))

    n_rules = len(select) if select else len(RULES) - len(ignore or ())
    status = "clean" if not fresh else f"{len(fresh)} finding(s)"
    print(f"staticcheck: {status} — {n_rules} rules over "
          f"{len(project.modules)} files ({len(held)} baselined)")
    return 1 if fresh else 0
