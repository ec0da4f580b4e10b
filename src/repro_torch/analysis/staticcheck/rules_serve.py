"""AS001 — bare `assert` guarding a serve-layer invariant.

`python -O` strips asserts.  In the serve layer these statements guard
allocator refcounts, page-size agreement, and speculative-row shapes —
invariants whose violation must fail loudly in production, not only in
dev runs. The JAX package's checker holds the same rule (its counterpart
of the same id); the fix is a typed raise, as ``COWViolationError``.

Scope: any module with a `serve` path component. Kernel-layer asserts
stay out of scope: the port's kernel wrappers validate with typed
raises, and KW001 holds their dispatch.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, Project, rule


@rule("AS001", "bare assert in the serve layer")
def check_as001(project: Project) -> Iterator[Finding]:
    for mod in project.iter_modules():
        parts = mod.relpath.replace("\\", "/").split("/")
        if "serve" not in parts:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assert):
                cond = ast.unparse(node.test) if hasattr(ast, "unparse") \
                    else "<condition>"
                yield Finding(
                    mod.relpath, node.lineno, "AS001",
                    f"bare `assert {cond}` is stripped under python -O — "
                    "a serve-layer invariant must survive production "
                    "builds",
                    "raise a typed error (see COWViolationError in "
                    "scheduler.py) instead of assert")
