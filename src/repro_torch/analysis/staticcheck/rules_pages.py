"""PG001 — allocator pages acquired but not released on some path.

Scope: scheduler.py / engine.py module basenames (the two files that
own page lifetimes; kv_pages.py *is* the allocator and engine probes
run under it).  The model, per function body:

- acquire: `x = <anything>.alloc(...)` / `x = <anything>.alloc_view(...)`
  binds fresh refcounts to `x`; `<anything>.share(x)` bumps refcounts
  on pages already bound to `x`; `state, x = <anything>.fork_partial(...)`
  (the CacheBackend partial-page COW fork returns `(state, dst_page)`)
  binds the freshly copied page to the *last* Name in the tuple target.
- a `return` statement reachable after the acquire must satisfy one of:
  the returned expression mentions `x` (ownership handed to the
  caller); a release/free call naming `x` happened first; `x` escaped
  (passed to any call, stored into an attribute/subscript, or aliased
  into another binding — someone else now owns it); or the return sits
  under an `x is None` / `not x` guard (the allocation *failed*, there
  is nothing to release).
- a function that falls off the end without any of the above leaks too.

Line-interval approximation: "happened first" means a smaller line
number within the same binding's live range — branches that release on
a sibling path can mask a leak on this one, which keeps the rule quiet
enough to gate CI. The runtime refcount fuzz suites cover the rest.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from .core import Finding, ModuleInfo, Project, rule

_SCOPE_BASENAMES = ("scheduler.py", "engine.py")
_ACQUIRE = ("alloc", "alloc_view")
_ACQUIRE_TUPLE = ("fork_partial",)   # returns (state, page): bind the page
_RELEASE = ("release", "free")


def _call_tail(mod: ModuleInfo, call: ast.Call) -> str:
    raw = mod.raw_chain(call.func) or ""
    return raw.rsplit(".", 1)[-1]


def _mentions(node: ast.AST, name: str) -> bool:
    return any(isinstance(s, ast.Name) and s.id == name
               for s in ast.walk(node))


def _none_guarded(mod: ModuleInfo, stmt: ast.stmt, fn: ast.AST,
                  name: str) -> bool:
    """Is ``stmt`` under an `if <name> is None` / `if not <name>` arm?"""
    cur = mod.parents.get(stmt)
    while cur is not None and cur is not fn:
        if isinstance(cur, ast.If):
            t = cur.test
            if isinstance(t, ast.Compare) and _mentions(t, name) and any(
                    isinstance(c, ast.Constant) and c.value is None
                    for c in t.comparators):
                return True
            if isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not) \
                    and _mentions(t.operand, name):
                return True
            if isinstance(t, ast.BoolOp) and any(
                    isinstance(v, ast.Compare) and _mentions(v, name) and any(
                        isinstance(c, ast.Constant) and c.value is None
                        for c in v.comparators)
                    for v in t.values):
                return True
        cur = mod.parents.get(cur)
    return False


def _acquisitions(mod: ModuleInfo, fn: ast.FunctionDef
                  ) -> List[Tuple[str, int]]:
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            tail = _call_tail(mod, node.value)
            if tail in _ACQUIRE and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                out.append((node.targets[0].id, node.lineno))
            elif tail in _ACQUIRE_TUPLE and len(node.targets) == 1 and \
                    isinstance(node.targets[0], (ast.Tuple, ast.List)):
                # `self.state, dst = backend.fork_partial(...)`: the new
                # page rides in the last element of the tuple target
                last = node.targets[0].elts[-1] if node.targets[0].elts \
                    else None
                if isinstance(last, ast.Name):
                    out.append((last.id, node.lineno))
        elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            if _call_tail(mod, call) == "share" and call.args and \
                    isinstance(call.args[0], ast.Name):
                out.append((call.args[0].id, node.lineno))
    return out


def _live_range(mod: ModuleInfo, fn: ast.FunctionDef, name: str,
                bind_line: int) -> Tuple[int, int]:
    """[bind, next re-acquire or fn end] — each binding checked alone."""
    hi = fn.end_lineno or bind_line
    for other, line in _acquisitions(mod, fn):
        if other == name and bind_line < line <= hi:
            hi = line - 1
    return bind_line, hi


def _handled_before(mod: ModuleInfo, fn: ast.FunctionDef, name: str,
                    lo: int, hi: int) -> bool:
    """Did `name` get released or escape within [lo, hi]?"""
    for node in ast.walk(fn):
        line = getattr(node, "lineno", None)
        if line is None or not lo <= line <= hi:
            continue
        if isinstance(node, ast.Call):
            tail = _call_tail(mod, node)
            if tail in _ACQUIRE or tail in _ACQUIRE_TUPLE or \
                    tail == "share":
                continue    # the acquire itself is not an escape
            if any(_mentions(a, name) for a in node.args) or any(
                    _mentions(kw.value, name) for kw in node.keywords):
                return True     # released, or escaped into a callee
        elif isinstance(node, ast.Assign):
            if _mentions(node.value, name):
                for tgt in node.targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        return True     # stored: owner is elsewhere now
                    if isinstance(tgt, ast.Name) and tgt.id != name:
                        return True     # aliased into another binding
            for tgt in node.targets:
                if isinstance(tgt, (ast.Tuple, ast.List)) and \
                        _mentions(node.value, name):
                    return True
    return False


@rule("PG001", "allocated pages leak on some path")
def check_pg001(project: Project) -> Iterator[Finding]:
    for mod in project.iter_modules():
        base = mod.relpath.replace("\\", "/").rsplit("/", 1)[-1]
        if base not in _SCOPE_BASENAMES:
            continue
        for fn in (n for n in ast.walk(mod.tree)
                   if isinstance(n, ast.FunctionDef)):
            returns = [n for n in ast.walk(fn) if isinstance(n, ast.Return)]
            for name, bind_line in _acquisitions(mod, fn):
                lo, hi = _live_range(mod, fn, name, bind_line)
                exits: List[Tuple[int, Optional[ast.Return]]] = [
                    (r.lineno, r) for r in returns if lo < r.lineno <= hi]
                body_ends_in_return = bool(fn.body) and isinstance(
                    fn.body[-1], ast.Return)
                if not body_ends_in_return:
                    exits.append((hi, None))    # implicit `return None`
                for line, ret in exits:
                    if ret is not None and ret.value is not None and \
                            _mentions(ret.value, name):
                        continue    # ownership returned to the caller
                    if ret is not None and _none_guarded(mod, ret, fn, name):
                        continue    # allocation-failed bail-out
                    if _handled_before(mod, fn, name, lo, line):
                        continue
                    where = "falls off the end" if ret is None else \
                        f"returns at line {line}"
                    yield Finding(
                        mod.relpath, bind_line, "PG001",
                        f"pages bound to `{name}` (line {bind_line}) are "
                        f"never released: `{fn.name}` {where} without "
                        "release/free, return, or handoff",
                        "release on every early exit, or return the pages "
                        "so the caller owns them")
                    break           # one finding per acquisition
