"""Core of the port's static checker.

Stdlib-only (``ast`` + ``os``): it imports no torch, no jax and nothing
of the JAX package, so it runs in a bare Python. The pieces:

- ``Finding`` — one diagnostic, rendered ``file:line · RULE_ID · message
  · fix: hint``.
- ``rule(...)`` / ``RULES`` — the registry. A rule is a generator over a
  ``Project`` yielding ``Finding``s.
- ``ModuleInfo`` — one parsed file with its import-alias maps and a
  parent map (ast has no uplinks).
- ``Project`` — the scanned file set plus the *step-region resolver*:
  the set of functions that run once for each step, wave or call on the
  card, closed transitively over cross-module references.

Step regions (the counterpart of the JAX package's jit regions; the port
runs eagerly, so a region is where a host sync stalls every call and
where a CUDA-graph capture would have to hold):

- **Step factories.** Every def nested in a ``make_*`` factory whose name
  ends in ``_fn`` or ``_step`` (``launch/steps.py``'s
  ``make_train_fn``, ``make_prefill_fn``, ``make_serve_fn``,
  ``make_paged_serve_fn``, ``make_paged_verify_fn``,
  ``make_draft_wave_fn``; ``core/lp.py``'s ``make_fwd_step`` and
  ``make_adj_step``). The JAX package marks the inner defs of *every*
  ``make_*``; the port narrows that to the step-builder suffixes, so a
  factory of host objects (``make_pipeline``, ``make_backend``,
  ``make_queue``) and its inner defs stay host code.
- **Autograd Functions.** ``forward`` / ``backward`` (and
  ``setup_context``) of every class deriving ``torch.autograd.Function``
  (the kernels' bindings, ``core/lp.py``'s ``_LPForward``,
  ``models/moe.py``'s dispatch and combine). ``kernels/ops.py``'s
  ``_MetaKernel`` counts too: it runs inside the dry-run's meta step,
  where a read-back raises, so it is held to the same rules.
- **Partials.** ``functools.partial(f, ...)`` marks ``f``: the serve
  backends hand their paged forwards to the step factories that way
  (``serve/cache.py``'s ``_decode_fn`` / ``_verify_fns``).
- **Closure.** Anything a step region references by name (a def of the
  same module, a ``from m import f``, or ``alias.f`` of an imported
  module) is a step region too.

Host code — the scheduler, the engine, ``CacheBackend._apply``'s token
read-back, the ``Trainer``'s probe reads — is reached through methods
(``self.x``), which the resolver does not follow, and stays outside.

Rules import nothing outside this package, so fixture tests can build a
``Project`` over a temp directory and assert exact findings.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import (Callable, Dict, Iterable, Iterator, List, Optional, Set,
                    Tuple)

PACKAGE = "repro_torch"

# --------------------------------------------------------------------------
# findings + registry


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str          # as scanned (repo-relative when invoked from root)
    line: int
    rule: str
    message: str
    hint: str = ""

    def render(self) -> str:
        out = f"{self.path}:{self.line} · {self.rule} · {self.message}"
        if self.hint:
            out += f" · fix: {self.hint}"
        return out

    def sort_key(self) -> Tuple[str, int, str]:
        return (self.path, self.line, self.rule)


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    summary: str
    check: Callable[["Project"], Iterable[Finding]]


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, summary: str):
    """Register ``fn`` as the checker for ``rule_id``."""
    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = Rule(rule_id, summary, fn)
        return fn
    return deco


# --------------------------------------------------------------------------
# per-module model

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


class ModuleInfo:
    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # local alias -> dotted module ("F" -> "torch.nn.functional",
        # and from-imports of modules: "kops" -> "repro_torch.kernels.ops")
        self.module_aliases: Dict[str, str] = {}
        # local name -> (module, original name) for `from m import n`
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        # function name -> all defs with that name (any nesting depth)
        self.defs_by_name: Dict[str, List[ast.FunctionDef]] = {}
        # module-level defs only (cross-module resolution target)
        self.toplevel_funcs: Dict[str, ast.FunctionDef] = {}
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.dotted = _dotted_name(relpath)
        self._index()

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    self.module_aliases[local] = (
                        alias.name if alias.asname else alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    local = alias.asname or alias.name
                    self.from_imports[local] = (node.module, alias.name)
                    # `from repro_torch.models import transformer` also
                    # binds a module object; record both interpretations.
                    self.module_aliases.setdefault(
                        local, f"{node.module}.{alias.name}")
            elif isinstance(node, _FUNC_DEFS):
                self.defs_by_name.setdefault(node.name, []).append(node)
        for node in self.tree.body:
            if isinstance(node, _FUNC_DEFS):
                self.toplevel_funcs[node.name] = node

    # -- expression helpers -------------------------------------------------

    def raw_chain(self, expr: ast.AST) -> Optional[str]:
        """Literal dotted text of a Name/Attribute chain, else None."""
        parts: List[str] = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if isinstance(expr, ast.Name):
            parts.append(expr.id)
            return ".".join(reversed(parts))
        return None

    def resolved_chain(self, expr: ast.AST) -> Optional[str]:
        """Import-resolved dotted name ("np.asarray" -> "numpy.asarray")."""
        raw = self.raw_chain(expr)
        if raw is None:
            return None
        root, _, rest = raw.partition(".")
        if root in self.module_aliases:
            base = self.module_aliases[root]
            return f"{base}.{rest}" if rest else base
        return raw

    def is_module_chain(self, expr: ast.AST) -> bool:
        """Does the Name/Attribute chain start at an imported name (a
        module or a from-import, as opposed to a value: ``torch.x``
        against ``t.x``)?"""
        raw = self.raw_chain(expr)
        return raw is not None and \
            raw.partition(".")[0] in self.module_aliases

    def enclosing_function(self, node: ast.AST) -> Optional[ast.FunctionDef]:
        node = self.parents.get(node)
        while node is not None:
            if isinstance(node, _FUNC_DEFS):
                return node
            node = self.parents.get(node)
        return None

    def innermost_function_at(self, line: int) -> Optional[ast.FunctionDef]:
        """The innermost def whose body spans source line ``line``."""
        best = None
        for node in ast.walk(self.tree):
            if isinstance(node, _FUNC_DEFS) and \
                    node.lineno <= line <= (node.end_lineno or node.lineno):
                if best is None or node.lineno >= best.lineno:
                    best = node
        return best


def _dotted_name(relpath: str) -> str:
    parts = relpath.replace("\\", "/").split("/")
    if parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    if PACKAGE in parts:
        parts = parts[parts.index(PACKAGE):]
    else:
        # fixture/temp trees: the stem is the import name
        parts = parts[-1:]
    return ".".join(parts) if parts else relpath


# --------------------------------------------------------------------------
# project + step-region resolver

_STEP_FACTORY_SUFFIXES = ("_fn", "_step")
_AUTOGRAD_BASES = ("torch.autograd.Function", "torch.autograd.function.Function")
_AUTOGRAD_METHODS = ("forward", "backward", "setup_context")
_PARTIALS = ("functools.partial", "partial")


def is_step_factory(name: str) -> bool:
    return name.startswith("make_") and name.endswith(_STEP_FACTORY_SUFFIXES)


class Project:
    def __init__(self, paths: Iterable[str],
                 known_axes: Optional[Set[str]] = None):
        self.known_axes = known_axes  # SH001's vocabulary, for fixtures
        self.modules: List[ModuleInfo] = []
        for path in paths:
            for fpath, rel in _collect(path):
                with open(fpath, encoding="utf-8") as fh:
                    src = fh.read()
                self.modules.append(ModuleInfo(fpath, rel, src))
        self.by_dotted: Dict[str, ModuleInfo] = {
            m.dotted: m for m in self.modules}
        # (module dotted, func name) -> (mod, node), module-level defs
        self.func_index: Dict[Tuple[str, str],
                              Tuple[ModuleInfo, ast.FunctionDef]] = {}
        for m in self.modules:
            for name, node in m.toplevel_funcs.items():
                self.func_index[(m.dotted, name)] = (m, node)
        self._step: Dict[int, Tuple[ModuleInfo, ast.FunctionDef]] = {}
        self._resolve_step_regions()

    # -- scanning helpers ---------------------------------------------------

    def iter_modules(self) -> Iterator[ModuleInfo]:
        return iter(self.modules)

    def find_module(self, suffix: str) -> Optional[ModuleInfo]:
        suffix = suffix.replace("\\", "/")
        for m in self.modules:
            if m.relpath.replace("\\", "/").endswith(suffix):
                return m
        return None

    def step_functions(self) -> List[Tuple[ModuleInfo, ast.FunctionDef]]:
        return list(self._step.values())

    def is_step(self, node: ast.AST) -> bool:
        return id(node) in self._step

    def step_region_at(self, path_suffix: str, line: int) -> Optional[str]:
        """Name of the step region whose innermost def holds ``line`` of
        the module ending in ``path_suffix``, else None (host code, or a
        line outside any def). Used by ``chip_smoke.py``'s sync census."""
        mod = self.find_module(path_suffix)
        if mod is None:
            return None
        fn = mod.innermost_function_at(line)
        return fn.name if fn is not None and self.is_step(fn) else None

    # -- cross-module function resolution ----------------------------------

    def resolve_func(self, mod: ModuleInfo, expr: ast.AST
                     ) -> List[Tuple[ModuleInfo, ast.FunctionDef]]:
        out: List[Tuple[ModuleInfo, ast.FunctionDef]] = []
        if isinstance(expr, ast.Name):
            for node in mod.defs_by_name.get(expr.id, ()):
                out.append((mod, node))
            if not out and expr.id in mod.from_imports:
                m, orig = mod.from_imports[expr.id]
                hit = self.func_index.get((_canon(m), orig))
                if hit:
                    out.append(hit)
        elif isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                            ast.Name):
            dotted = mod.module_aliases.get(expr.value.id)
            if dotted:
                hit = self.func_index.get((_canon(dotted), expr.attr))
                if hit:
                    out.append(hit)
        return out

    # -- step-region computation -------------------------------------------

    def _resolve_step_regions(self) -> None:
        work: List[Tuple[ModuleInfo, ast.FunctionDef]] = []

        def mark(mod: ModuleInfo, fn: ast.AST) -> None:
            if isinstance(fn, _FUNC_DEFS) and id(fn) not in self._step:
                self._step[id(fn)] = (mod, fn)
                work.append((mod, fn))

        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, _FUNC_DEFS) and is_step_factory(node.name):
                    for sub in ast.walk(node):
                        if sub is not node and isinstance(sub, _FUNC_DEFS):
                            mark(mod, sub)
                elif isinstance(node, ast.ClassDef) and any(
                        mod.resolved_chain(b) in _AUTOGRAD_BASES
                        for b in node.bases):
                    for sub in node.body:
                        if isinstance(sub, _FUNC_DEFS) and \
                                sub.name in _AUTOGRAD_METHODS:
                            mark(mod, sub)
                elif isinstance(node, ast.Call) and node.args and \
                        mod.resolved_chain(node.func) in _PARTIALS:
                    for tmod, tfn in self.resolve_func(mod, node.args[0]):
                        mark(tmod, tfn)
        # transitive closure: anything a step region references is itself
        # a step region when called.
        while work:
            mod, fn = work.pop()
            for node in ast.walk(fn):
                if isinstance(node, (ast.Name, ast.Attribute)):
                    for tmod, tfn in self.resolve_func(mod, node):
                        mark(tmod, tfn)


def _canon(dotted: str) -> str:
    parts = dotted.split(".")
    if PACKAGE in parts:
        parts = parts[parts.index(PACKAGE):]
    return ".".join(parts)


def _collect(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (path-as-walked, same) — display paths stay exactly as the
    caller spelled the root, so baselines written from the repo root are
    stable ("src/repro_torch/...")."""
    if os.path.isfile(path):
        yield path, path
        return
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs
                         if d not in ("__pycache__", ".git"))
        for name in sorted(files):
            if name.endswith(".py"):
                full = os.path.join(root, name)
                yield full, full


def run_rules(project: Project,
              select: Optional[Set[str]] = None,
              ignore: Optional[Set[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, int, str, str]] = set()
    for rid in sorted(RULES):
        if select and rid not in select:
            continue
        if ignore and rid in ignore:
            continue
        for f in RULES[rid].check(project):
            key = (f.path, f.line, f.rule, f.message)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    findings.sort(key=Finding.sort_key)
    return findings
