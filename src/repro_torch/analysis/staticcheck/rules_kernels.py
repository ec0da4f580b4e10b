"""KW001 — a kernel wrapper that hides its kernel.

The port's ground rule for kernels (ROADMAP, "Dispatch"): a CUDA tensor
reaches the hand-written kernel, which launches or raises; the plain
PyTorch version runs only because a tensor lies on the CPU. This rule is
that rule written down, over every module with a ``kernels`` path
component (the wrappers and ``kernels/ops.py``). Two cases:

(a) an ``except`` handler in a function that builds or launches a kernel
    — one that references the kernel build module
    (``repro_torch.kernels.build``) or ``ctypes``, or calls a function of
    its own module that does — whose handler does anything but re-raise:
    calls a ``*_ref`` plain version, returns, or ends without a
    ``raise``. A failing build or launch must surface, not turn into the
    plain version's answer.
(b) a route picked by anything other than the tensor's device, dtype or
    shape: a test (``if`` / ``while`` / conditional expression) that
    reads ``os.environ``, ``os.getenv``, ``torch.cuda.is_available()``
    or a module flag (a module-level name bound to ``True`` / ``False``
    or to an environment read, or rebound through ``global``). The
    device tests of ``kernels/ops.py`` (``t.is_cuda``, ``t.is_meta``,
    ``kernel_route``) and the wrappers' dtype and shape checks are
    silent by construction.

Approximations: "builds or launches" is decided by name within one
module (a launcher reached only through another module's function is
not seen); a flag is only recognised at module level, not as an
attribute of another object.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from .core import Finding, ModuleInfo, Project, rule

_BUILD_MODULE = "kernels.build"
_ENV_READS = ("os.environ", "os.getenv", "os.environ.get",
              "torch.cuda.is_available")


def _in_scope(mod: ModuleInfo) -> bool:
    return "kernels" in mod.relpath.replace("\\", "/").split("/")


def _touches_build(mod: ModuleInfo, fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = mod.resolved_chain(node) or ""
            if d == "ctypes" or d.startswith("ctypes.") or \
                    d.endswith(_BUILD_MODULE) or f"{_BUILD_MODULE}." in d:
                return True
    return False


def _launchers(mod: ModuleInfo) -> Set[str]:
    """Names of this module's defs that build or launch a kernel, closed
    over same-module calls."""
    defs = {n.name: n for n in ast.walk(mod.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    out = {name for name, fn in defs.items() if _touches_build(mod, fn)}
    grew = True
    while grew:
        grew = False
        for name, fn in defs.items():
            if name in out:
                continue
            if any(isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                   and c.func.id in out for c in ast.walk(fn)):
                out.add(name)
                grew = True
    return out


def _reraises(handler: ast.ExceptHandler) -> bool:
    """Does the handler end in ``raise`` with no return and no plain
    version on the way?"""
    if not handler.body or not isinstance(handler.body[-1], ast.Raise):
        return False
    for node in ast.walk(handler):
        if isinstance(node, ast.Return):
            return False
        if isinstance(node, ast.Call):
            if ast.unparse(node.func).rsplit(".", 1)[-1].endswith("_ref"):
                return False
    return True


def _module_flags(mod: ModuleInfo) -> Set[str]:
    flags: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            v = node.value
            env = any(
                (mod.resolved_chain(s.func if isinstance(s, ast.Call) else s)
                 or "").startswith(_ENV_READS)
                for s in ast.walk(v) if isinstance(s, (ast.Call, ast.Attribute)))
            if env or (isinstance(v, ast.Constant) and
                       isinstance(v.value, bool)):
                flags |= {t.id for t in node.targets
                          if isinstance(t, ast.Name)}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Global):
            flags |= set(node.names)
    return flags


def _route_reads(mod: ModuleInfo, test: ast.AST, flags: Set[str]):
    for sub in ast.walk(test):
        if isinstance(sub, ast.Name) and sub.id in flags:
            return f"module flag `{sub.id}`"
        if isinstance(sub, (ast.Attribute, ast.Call)):
            d = mod.resolved_chain(sub.func if isinstance(sub, ast.Call)
                                   else sub) or ""
            if d in _ENV_READS:
                return f"`{d}`"
    return None


@rule("KW001", "kernel wrapper hides its kernel (fallback or off-device route)")
def check_kw001(project: Project) -> Iterator[Finding]:
    for mod in project.iter_modules():
        if not _in_scope(mod):
            continue
        launchers = _launchers(mod)
        flags = _module_flags(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ExceptHandler):
                fn = mod.enclosing_function(node)
                if fn is not None and fn.name in launchers and \
                        not _reraises(node):
                    yield Finding(
                        mod.relpath, node.lineno, "KW001",
                        f"`except` in `{fn.name}`, which builds or launches "
                        "a kernel, does not re-raise — a failed build or "
                        "launch would turn into another route's answer",
                        "let the error propagate (re-raise); the plain "
                        "version runs only for CPU tensors")
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
                why = _route_reads(mod, node.test, flags)
                if why is not None:
                    yield Finding(
                        mod.relpath, node.test.lineno, "KW001",
                        f"kernel route picked by {why} — the route must "
                        "follow the tensor's device, dtype or shape alone",
                        "dispatch on t.is_cuda / kernel_route(t); raise "
                        "where the kernel cannot run")
