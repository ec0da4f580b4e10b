"""RC001 (CUDA-graph capture hazards) and RC002 (host syncs) inside step
regions.

Both rules only look *inside* the step-region set computed by
``Project`` — host-side scheduler/engine code may branch on numpy values
and read tokens back freely; the hazard is doing it in code that runs
once for each step, wave or call on the card, where a sync stalls the
host's dispatch every time and a CUDA-graph capture of the step breaks
or freezes a value it should not.

What the rules see as a *tensor expression* (the approximation both
rules share): an expression holding a call of a ``torch.*`` function
(not a host query such as ``torch.is_grad_enabled`` or
``torch.cuda.is_available``), or a call of a reducing or comparing
method (``.any()``, ``.sum()``, ``.eq()``, ``.item()``, ...) on a value
that is not visibly numpy. A plain name or a subscript is *not* seen as
a tensor: closure-captured ints (``page_size``, ``S``) and host dicts
(``params["w"]``) are idiomatic, and a tensor hidden behind a name is
left to ``chip_smoke.py``'s sync census, which reads the syncs the card
really makes. Host numpy (``np.asarray(temps)``) and dtype casts
(``x.to(dt)``) are silent by construction.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from .core import Finding, ModuleInfo, Project, rule

# torch.* calls that answer a host question (no tensor, no sync)
_HOST_TORCH_PREFIXES = ("torch.is_", "torch.cuda.", "torch.jit.",
                        "torch.compiler.", "torch.backends.",
                        "torch.autograd.", "torch.profiler.")
_HOST_TORCH = {"torch.finfo", "torch.iinfo", "torch.device", "torch.Size",
               "torch.dtype", "torch.get_default_dtype", "torch.promote_types",
               "torch.result_type", "torch.can_cast", "torch.no_grad",
               "torch.enable_grad", "torch.inference_mode",
               "torch.are_deterministic_algorithms_enabled"}
# methods that reduce or compare a tensor: a test on their result is a
# test on device data
_TENSOR_METHODS = {"any", "all", "item", "sum", "max", "min", "amax",
                   "amin", "mean", "norm", "eq", "ne", "gt", "lt", "ge",
                   "le", "isnan", "isinf", "isfinite", "equal", "allclose",
                   "count_nonzero", "nonzero"}
_HOST_DATA = {"torch.tensor", "torch.as_tensor", "torch.asarray",
              "torch.from_numpy"}
_HOST_DEVICES = ("cpu", "meta")
_DATA_SHAPED = {"nonzero", "argwhere", "unique", "unique_consecutive",
                "masked_select", "bincount"}
_MASK_FUNCS = {"isnan", "isinf", "isfinite", "logical_and", "logical_or",
               "logical_not", "logical_xor", "eq", "ne", "gt", "lt", "ge",
               "le"}
_NP_PULLS = {"numpy.asarray", "numpy.array", "numpy.max", "numpy.min",
             "numpy.sum", "numpy.mean", "numpy.argmax", "numpy.argmin",
             "numpy.any", "numpy.all"}
_READBACKS = {"item", "tolist", "cpu", "numpy"}


def _is_torch_call(mod: ModuleInfo, call: ast.Call) -> bool:
    if not mod.is_module_chain(call.func):
        return False
    d = mod.resolved_chain(call.func) or ""
    return d.startswith("torch.") and d not in _HOST_TORCH and \
        not d.startswith(_HOST_TORCH_PREFIXES)


def _numpy_receiver(mod: ModuleInfo, expr: ast.AST) -> bool:
    """Is ``expr`` visibly a numpy value (a call of ``numpy.*``)?"""
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    if isinstance(expr, ast.Call):
        d = mod.resolved_chain(expr.func) or ""
        if d.startswith("numpy."):
            return True
        if isinstance(expr.func, ast.Attribute):
            return _numpy_receiver(mod, expr.func.value)
    return False


def _method(mod: ModuleInfo, call: ast.Call, names) -> Optional[str]:
    """``call``'s method name when it is ``<value>.<name>(...)`` with
    ``name`` in ``names`` on a value that is not a module or numpy."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in names and \
            not mod.is_module_chain(f) and not _numpy_receiver(mod, f.value):
        return f.attr
    return None


def _is_tensor_call(mod: ModuleInfo, call: ast.Call) -> bool:
    return _is_torch_call(mod, call) or \
        _method(mod, call, _TENSOR_METHODS) is not None


def _tensor_call_in(mod: ModuleInfo, expr: ast.AST) -> Optional[ast.Call]:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and _is_tensor_call(mod, sub):
            return sub
    return None


def _own_nodes(project: Project, fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes of ``fn`` without those of nested defs that are step regions
    themselves (each is walked on its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                project.is_step(node):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# --------------------------------------------------------------------------
# RC001


def _implicit_bools(node: ast.AST) -> Iterator[ast.AST]:
    """Expressions Python converts with ``bool()`` at ``node``."""
    if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
        yield node.test
    elif isinstance(node, ast.BoolOp):
        yield from node.values[:-1]
    elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        yield node.operand
    elif isinstance(node, ast.comprehension):
        yield from node.ifs


def _device_arg(mod: ModuleInfo, call: ast.Call) -> Optional[ast.AST]:
    """The device a ``.to(...)`` / ``.cuda(...)`` call moves to (an AST
    node, ``call`` itself for ``.cuda()``), or None for a dtype cast or a
    move to the host."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "cuda":
        return call
    cands = [kw.value for kw in call.keywords if kw.arg == "device"]
    if call.args:
        a0 = call.args[0]
        d = mod.resolved_chain(a0) or ""
        is_dtype = d.startswith("torch.") and d != "torch.device" and \
            isinstance(a0, ast.Attribute)
        if not is_dtype:
            cands.append(a0)
    for c in cands:
        if isinstance(c, ast.Constant) and c.value in _HOST_DEVICES:
            continue
        if isinstance(c, ast.Call) and \
                mod.resolved_chain(c.func) == "torch.device" and \
                c.args and isinstance(c.args[0], ast.Constant) and \
                c.args[0].value in _HOST_DEVICES:
            continue
        return c
    return None


def _host_data_call(mod: ModuleInfo, expr: ast.AST) -> bool:
    return isinstance(expr, ast.Call) and \
        mod.resolved_chain(expr.func) in _HOST_DATA


def _host_names(mod: ModuleInfo, project: Project, fn: ast.AST) -> Set[str]:
    """Names ``fn`` binds to a host-data tensor (``t = torch.from_numpy(a)``)."""
    out = set()
    for node in _own_nodes(project, fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                _host_data_call(mod, node.value):
            out.add(node.targets[0].id)
    return out


def _is_mask(mod: ModuleInfo, expr: ast.AST, masks: Set[str]) -> bool:
    """Is the index ``expr`` visibly boolean (a comparison, a logical op
    or a name bound to one)? Comparisons of visible numpy are not."""
    if isinstance(expr, ast.Compare):
        return not _numpy_receiver(mod, expr.left)
    if isinstance(expr, ast.Name):
        return expr.id in masks
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return _is_mask(mod, expr.operand, masks)
    if isinstance(expr, ast.BinOp) and isinstance(
            expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_mask(mod, expr.left, masks) or \
            _is_mask(mod, expr.right, masks)
    if isinstance(expr, ast.Call):
        return _is_torch_call(mod, expr) and \
            (mod.resolved_chain(expr.func) or "").rsplit(".", 1)[-1] \
            in _MASK_FUNCS or _method(mod, expr, _MASK_FUNCS) is not None
    return False


def _mask_index(mod: ModuleInfo, sl: ast.AST, masks: Set[str]) -> bool:
    elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
    return any(_is_mask(mod, e, masks) for e in elts)


def _mask_names(mod: ModuleInfo, project: Project, fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in _own_nodes(project, fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                _is_mask(mod, node.value, out):
            out.add(node.targets[0].id)
    return out


@rule("RC001", "CUDA-graph capture hazard inside a step region")
def check_rc001(project: Project) -> Iterator[Finding]:
    """(a) Python control flow on a tensor (an implicit ``bool()``: a
    sync, and a branch a captured graph would freeze); (b) a device
    tensor made from host data (a blocking host-to-device copy each
    call, a buffer a captured graph would freeze); (c) a shape read from
    data (``nonzero``, ``unique``, ``masked_select``, ``bincount``,
    one-argument ``torch.where``, boolean-mask indexing,
    ``repeat_interleave`` of tensor repeats without ``output_size``).

    Approximations: tensors are seen only through visible tensor calls
    (module docstring); (b) sees ``torch.tensor`` / ``as_tensor`` with a
    ``device=`` that is not the host, and ``.to(<device>)`` /
    ``.cuda()`` of a host-data constructor or of a name bound to one in
    the same function — a ``.to(x)`` with one name argument counts as a
    device move, a ``torch.<dtype>`` argument as a cast; (c) sees a mask
    only as a comparison, a logical op or a name bound to one."""
    for mod, fn in project.step_functions():
        hosts = _host_names(mod, project, fn)
        masks = _mask_names(mod, project, fn)
        for node in _own_nodes(project, fn):
            for test in _implicit_bools(node):
                sub = _tensor_call_in(mod, test)
                if sub is not None:
                    yield Finding(
                        mod.relpath, sub.lineno, "RC001",
                        f"Python {type(node).__name__} on a tensor inside "
                        f"step region `{fn.name}` — an implicit bool(): a "
                        "device sync, and a branch a CUDA-graph capture "
                        "would freeze",
                        "use torch.where, or decide on the host from host "
                        "data before the step")
            if isinstance(node, ast.Subscript) and \
                    _mask_index(mod, node.slice, masks):
                yield Finding(
                    mod.relpath, node.lineno, "RC001",
                    f"boolean-mask indexing inside step region "
                    f"`{fn.name}` — the result's shape is read from data "
                    "(a sync; no capture)",
                    "use torch.where over the full shape")
            if not isinstance(node, ast.Call):
                continue
            d = mod.resolved_chain(node.func) or ""
            tail = d.rsplit(".", 1)[-1]
            if d in ("torch.tensor", "torch.as_tensor", "torch.asarray"):
                dev = [kw.value for kw in node.keywords if kw.arg == "device"]
                if dev and not (isinstance(dev[0], ast.Constant) and
                                dev[0].value in _HOST_DEVICES):
                    yield _upload(mod, node, fn, f"{d}(..., device=...)")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("to", "cuda") and \
                    _device_arg(mod, node) is not None and \
                    (_host_data_call(mod, node.func.value) or
                     node.func.attr == "cuda" or
                     (isinstance(node.func.value, ast.Name) and
                      node.func.value.id in hosts)):
                yield _upload(mod, node, fn, f".{node.func.attr}(<device>) "
                              "of host data")
            shaped = (tail in _DATA_SHAPED and
                      (_is_torch_call(mod, node) or
                       _method(mod, node, _DATA_SHAPED))) or \
                (d == "torch.where" and len(node.args) == 1 and
                 not node.keywords) or \
                (tail == "repeat_interleave" and _tensor_repeats(mod, node))
            if shaped:
                yield Finding(
                    mod.relpath, node.lineno, "RC001",
                    f"`{tail}` inside step region `{fn.name}` — its "
                    "output shape is read from data (a sync; no capture)",
                    "keep a fixed shape (a mask, a sort, a scatter into a "
                    "padded buffer), or pass output_size")


def _tensor_repeats(mod: ModuleInfo, call: ast.Call) -> bool:
    """``repeat_interleave`` whose repeats are a tensor expression and
    that has no ``output_size``."""
    if any(kw.arg == "output_size" for kw in call.keywords):
        return False
    args = list(call.args)
    if isinstance(call.func, ast.Attribute) and mod.is_module_chain(
            call.func):
        args = args[1:]                     # torch.repeat_interleave(x, r)
    reps = [kw.value for kw in call.keywords if kw.arg == "repeats"] + \
        args[:1]
    return any(_tensor_call_in(mod, r) is not None for r in reps)


def _upload(mod: ModuleInfo, node: ast.Call, fn, what: str) -> Finding:
    return Finding(
        mod.relpath, node.lineno, "RC001",
        f"{what} inside step region `{fn.name}` — a blocking "
        "host-to-device copy every call (pageable memory: a sync), and a "
        "buffer a CUDA-graph capture would freeze",
        "fill on the device (torch.full / arange), or stage through a "
        "pinned buffer the captured step reads")


# --------------------------------------------------------------------------
# RC002


@rule("RC002", "host sync inside a step region")
def check_rc002(project: Project) -> Iterator[Finding]:
    """Explicit reads back to the host: ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``,
    any ``.synchronize()`` (events, streams), ``int()`` / ``float()`` /
    ``bool()`` of a tensor expression and ``np.asarray`` / ``np.array`` /
    numpy reductions of one.

    Approximations: a method read-back on a value that is visibly numpy
    (``np.asarray(a).tolist()``) is silent; ``int(x)`` of a plain name
    is silent (module docstring), so ``np.asarray(temps)`` of the host's
    slot arrays stays quiet; a CPU tensor read back (no device involved)
    still counts — baseline it with its reason."""
    for mod, fn in project.step_functions():
        for node in _own_nodes(project, fn):
            if not isinstance(node, ast.Call):
                continue
            d = mod.resolved_chain(node.func) or ""
            what = None
            m = _method(mod, node, _READBACKS)
            if m is not None:
                what = f".{m}()"
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "to" and _to_host(node):
                what = '.to("cpu")'
            elif d == "torch.cuda.synchronize" or (
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr == "synchronize"):
                what = f"{mod.raw_chain(node.func) or '.synchronize'}()"
            elif isinstance(node.func, ast.Name) and \
                    node.func.id in ("int", "float", "bool") and \
                    node.args and \
                    _tensor_call_in(mod, node.args[0]) is not None:
                what = f"{node.func.id}() of a tensor expression"
            elif d in _NP_PULLS and node.args and \
                    _tensor_call_in(mod, node.args[0]) is not None:
                what = f"np.{d.rsplit('.', 1)[1]} of a tensor expression"
            if what is not None:
                yield Finding(
                    mod.relpath, node.lineno, "RC002",
                    f"{what} inside step region `{fn.name}` — a "
                    "device-to-host sync every call (and no capture)",
                    "keep the value on the device; read it after the "
                    "step returns, on the host side")


def _to_host(call: ast.Call) -> bool:
    vals = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu"
               for v in vals)
