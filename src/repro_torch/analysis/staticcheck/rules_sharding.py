"""SH001 — logical axis names must exist in the sharding vocabulary.

The port's counterpart of the JAX package's rule of the same id. The
vocabulary is read from the tree being scanned, so it cannot drift from
the code: the ``ShardingConfig`` string fields in ``configs/base.py``
plus the keys of the alias dict ``_ALIASES`` in ``parallel/sharding.py``
(or, as the reference keeps it, a dict inside ``resolve_axis``).
Everything that names logical axes is checked against it:
``logical_constraint`` / ``spec_for`` / ``named_sharding`` /
``resolve_axis`` / ``tree_shardings`` call sites (string constants
inside any tuple or list argument: ``pre + ("pages", None, "mlp")`` is
walked), the run-time tensor-parallel queries ``tp.split(name, ...)`` /
``tp.axis_of(mesh, cfg, name)`` (their string arguments), the
``_*_AXES`` placement tables in ``parallel/params.py`` (dict *values*
only; the keys hold parameter names) and the tuples of executed axes
(``_*AXES`` / ``*EXECUTED`` tuple assignments).

A mistyped axis does not crash: ``resolve_axis`` returns None and the
tensor is silently held whole on every rank. Fixture projects can pass
a vocabulary as ``Project(known_axes=...)``.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator, Optional, Set

from .core import Finding, Project, rule

_AXIS_CALLEES = ("logical_constraint", "spec_for", "named_sharding",
                 "resolve_axis", "tree_shardings")
_TP_CALLS = ("tp.split", "tp.axis_of")
_TABLE_RE = re.compile(r"^_[A-Z0-9_]*AXES$")
_TUPLE_RE = re.compile(r"^(_[A-Z0-9_]*AXES|[A-Z0-9_]*EXECUTED)$")


def _dict_keys(node: ast.AST) -> Iterator[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Dict):
            for k in sub.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    yield k.value


def _known_axes(project: Project) -> Optional[Set[str]]:
    if project.known_axes is not None:
        return set(project.known_axes)
    known: Set[str] = set()
    base = project.find_module("configs/base.py")
    if base is not None:
        for node in ast.walk(base.tree):
            if isinstance(node, ast.ClassDef) and \
                    node.name == "ShardingConfig":
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and \
                            isinstance(stmt.target, ast.Name) and \
                            "str" in ast.dump(stmt.annotation):
                        known.add(stmt.target.id)
    shard = project.find_module("parallel/sharding.py")
    if shard is not None:
        for node in shard.tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_ALIASES"
                    for t in node.targets):
                known.update(_dict_keys(node.value))
            elif isinstance(node, ast.FunctionDef) and \
                    node.name == "resolve_axis":
                known.update(_dict_keys(node))
    return known or None


def _tuple_strings(expr: ast.AST) -> Iterator[ast.Constant]:
    """String constants inside tuple/list displays anywhere in expr."""
    for node in ast.walk(expr):
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                if isinstance(elt, ast.Constant) and \
                        isinstance(elt.value, str):
                    yield elt


@rule("SH001", "unknown logical sharding axis")
def check_sh001(project: Project) -> Iterator[Finding]:
    known = _known_axes(project)
    if known is None:
        return      # no vocabulary in this tree (a fixture without one)
    hint = ("add the axis to ShardingConfig / the resolve_axis aliases, "
            "or fix the name: an unknown axis is silently held whole")
    for mod in project.iter_modules():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and \
                    (mod.raw_chain(node.func) or "") in _TP_CALLS:
                for arg in node.args:
                    if isinstance(arg, ast.Constant) and \
                            isinstance(arg.value, str) and \
                            arg.value not in known:
                        yield Finding(
                            mod.relpath, node.lineno, "SH001",
                            f"logical axis `{arg.value}` is not in the "
                            "sharding vocabulary", hint)
            elif isinstance(node, ast.Call):
                callee = (mod.raw_chain(node.func) or "").rsplit(".", 1)[-1]
                if callee not in _AXIS_CALLEES:
                    continue
                if callee == "resolve_axis" and node.args and \
                        isinstance(node.args[0], ast.Constant) and \
                        isinstance(node.args[0].value, str) and \
                        node.args[0].value not in known:
                    yield Finding(
                        mod.relpath, node.lineno, "SH001",
                        f"logical axis `{node.args[0].value}` is not in "
                        "the sharding vocabulary", hint)
                for expr in list(node.args) + [kw.value
                                               for kw in node.keywords]:
                    for const in _tuple_strings(expr):
                        if const.value not in known:
                            yield Finding(
                                mod.relpath, const.lineno, "SH001",
                                f"logical axis `{const.value}` is not in "
                                "the sharding vocabulary", hint)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Dict) and any(
                        isinstance(t, ast.Name) and _TABLE_RE.match(t.id)
                        for t in node.targets):
                for val in node.value.values:
                    for const in _tuple_strings(val):
                        if const.value not in known:
                            yield Finding(
                                mod.relpath, const.lineno, "SH001",
                                f"logical axis `{const.value}` in a "
                                "placement table is not in the sharding "
                                "vocabulary", hint)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Tuple) and any(
                        isinstance(t, ast.Name) and _TUPLE_RE.match(t.id)
                        for t in node.targets):
                for const in _tuple_strings(node.value):
                    if const.value not in known:
                        yield Finding(
                            mod.relpath, const.lineno, "SH001",
                            f"logical axis `{const.value}` in a tuple of "
                            "executed axes is not in the sharding "
                            "vocabulary", hint)
