"""Fixture suite for the port's checker, repro_torch.analysis.staticcheck.

Every port rule fires on its known-bad snippet (in PyTorch idiom) and
stays silent on the known-good twin, mirroring tests/test_staticcheck.py
test for test; the step-region resolver (step factories and their
narrowing, autograd Functions, partials, cross-module closure); the
port's own tree against staticcheck-torch-baseline.txt; the CLI; and the
rules the port keeps from the JAX package's checker (PG001, AS001,
SH001) held against that checker on its own fixtures, baselines loading
both ways.

Stdlib-only and no JAX compile: the checkers parse ASTs.
"""
import importlib.util
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro.analysis import staticcheck as ref_sc  # noqa: E402
from repro.analysis.staticcheck.cli import main as ref_cli  # noqa: E402
from repro_torch.analysis.staticcheck import (RULES, Project,  # noqa: E402
                                              run_rules)
from repro_torch.analysis.staticcheck import baseline as bl  # noqa: E402
from repro_torch.analysis.staticcheck.cli import main as cli_main  # noqa: E402

BASELINE = REPO / "staticcheck-torch-baseline.txt"
PORT = REPO / "src" / "repro_torch"


def _write(tmp_path, name, source):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def _scan(tmp_path, name, source, select=None):
    project = Project([str(_write(tmp_path, name, source))])
    return run_rules(project, select={select} if select else None)


def _rules_of(findings):
    return {f.rule for f in findings}


def _ref_module():
    """tests/test_staticcheck.py, for its fixtures."""
    spec = importlib.util.spec_from_file_location(
        "_ref_staticcheck_fixtures", REPO / "tests" / "test_staticcheck.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- registry ----------------------------------------------------------------

def test_registry_has_the_port_rules():
    assert set(RULES) == {"RC001", "RC002", "PG001", "AS001", "KW001",
                          "SH001"}
    for rid, r in RULES.items():
        assert rid == r.rule_id and r.summary
    for rid in ("RC001", "RC002"):      # the port's own: approximations
        assert "Approximations" in RULES[rid].check.__doc__


def test_package_imports_no_torch_jax_or_reference():
    code = ("import sys, repro_torch.analysis.staticcheck\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'numpy', 'repro')))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         env={"PYTHONPATH": str(REPO / "src")})
    assert res.returncode == 0 and res.stdout.strip() == "[]", \
        res.stdout + res.stderr


# -- RC001: capture hazards --------------------------------------------------

STEP = """
    import numpy as np
    import torch

    def make_step_fn(device):
        def step(x, a, mask_src, counts):
{body}
        return step
"""


def _step(body):
    return STEP.format(body=textwrap.indent(textwrap.dedent(body),
                                            " " * 12))


BAD_RC001 = {
    "branch": "if torch.any(x > 0):\n    return x\nreturn -x\n",
    "method_branch": "while x.sum() > 0:\n    x = x - 1\nreturn x\n",
    "assert": "assert torch.isfinite(x).all()\nreturn x\n",
    "ifexp": "return x if x.max() > 0 else -x\n",
    "tensor_ctor": "return x + torch.tensor([1.0, 2.0], device=x.device)\n",
    "as_tensor": "return torch.as_tensor(a, device=device)\n",
    "from_numpy_to": "return torch.from_numpy(a).to(device, torch.long)\n",
    "bound_then_to": "t = torch.from_numpy(a)\nreturn t.to(device)\n",
    "cuda": "return x.cuda()\n",
    "nonzero": "return torch.nonzero(x)\n",
    "unique": "return x.unique()\n",
    "mask_index": "return x[x > 0]\n",
    "mask_name": "keep = torch.isfinite(x) & (x > 0)\nreturn x[:, keep]\n",
    "mask_store": "x[torch.isnan(x)] = 0.0\nreturn x\n",
    "where_one_arg": "return torch.where(x > 0)\n",
    "repeat_tensor": "return x.repeat_interleave(torch.bincount(counts))\n",
}

GOOD_RC001 = {
    "where": "return torch.where(torch.any(x > 0), x + 1, x - 1)\n",
    "host_branch": "if np.any(np.asarray(a) > 0):\n    return x\nreturn -x\n",
    "static_branch": "if x.dtype == torch.bfloat16 and x.is_cuda:\n"
                     "    return x.float()\nreturn x\n",
    "fill": "return x + torch.full((), 2.0, device=x.device)\n",
    "dtype_cast": "dt = torch.bfloat16\nreturn x.to(dt) + x.to(torch.float32)\n",
    "from_numpy_cast": "return torch.from_numpy(a).to(torch.long)\n",
    "host_tensor": "return torch.tensor(2.0, dtype=torch.float32)\n",
    "repeat_int": "S = x.shape[1]\nreturn x.repeat_interleave(S)\n",
    "repeat_sized": "return x.repeat_interleave(counts, output_size=8)\n",
    "index_int": "return x[torch.arange(4, device=x.device)]\n",
}


@pytest.mark.parametrize("case", sorted(BAD_RC001))
def test_rc001_catches_capture_hazard(tmp_path, case):
    findings = _scan(tmp_path, "mod.py", _step(BAD_RC001[case]),
                     select="RC001")
    assert _rules_of(findings) == {"RC001"}, case


@pytest.mark.parametrize("case", sorted(GOOD_RC001))
def test_rc001_silent_on_capture_safe_code(tmp_path, case):
    assert _scan(tmp_path, "mod.py", _step(GOOD_RC001[case]),
                 select="RC001") == [], case


def test_rc001_ignores_host_side_code(tmp_path):
    host = """
        import torch

        def host_loop(x, a):
            if torch.any(x > 0):          # not a step region: fine
                return torch.from_numpy(a).to("cuda")
            return x[x > 0].nonzero()
    """
    assert _scan(tmp_path, "mod.py", host, select="RC001") == []


# -- RC002: host syncs -------------------------------------------------------

BAD_RC002 = {
    "item": "return x.max().item()\n",
    "tolist": "return x.tolist()\n",
    "cpu": "return x.cpu()\n",
    "numpy": "return x.detach().numpy()\n",
    "to_cpu": 'return x.to("cpu")\n',
    "cuda_sync": "torch.cuda.synchronize()\nreturn x\n",
    "event_sync": "ev = torch.cuda.Event()\nev.synchronize()\nreturn x\n",
    "float": "return float(torch.sum(x))\n",
    "bool": "return bool(x.any())\n",
    "np_asarray": "return np.asarray(torch.argmax(x))\n",
}

GOOD_RC002 = {
    # launch/steps.py's any_sampled: host numpy of the slot arrays
    "host_numpy": "any_sampled = bool(np.any(np.asarray(a) > 0.0))\n"
                  "return x if any_sampled else -x\n",
    "numpy_item": "return np.max(np.asarray(a)).item()\n",
    # models/mlp.py: dtype casts stay on the device
    "dtype_cast": "dt = torch.bfloat16\nreturn (x.to(dt) @ x.to(dt).t()).to(torch.float32)\n",
    "static_int": "n = int(x.shape[0])\nreturn x[:n]\n",
}


@pytest.mark.parametrize("case", sorted(BAD_RC002))
def test_rc002_catches_host_sync(tmp_path, case):
    findings = _scan(tmp_path, "mod.py", _step(BAD_RC002[case]),
                     select="RC002")
    assert _rules_of(findings) == {"RC002"}, case


@pytest.mark.parametrize("case", sorted(GOOD_RC002))
def test_rc002_silent_on_host_numpy_and_casts(tmp_path, case):
    assert _scan(tmp_path, "mod.py", _step(GOOD_RC002[case]),
                 select="RC002") == [], case


def test_rc002_silent_on_host_side_pulls(tmp_path):
    src = """
        import numpy as np
        import torch

        def make_step_fn():
            def step(x):
                return torch.sum(x)
            return step

        def host_caller(step, x):
            return float(np.asarray(step(x).cpu()))   # host side: fine
    """
    assert _scan(tmp_path, "mod.py", src, select="RC002") == []


# -- PG001 and AS001: the reference's rules, PyTorch idiom -------------------

BAD_PG001 = """
    class Scheduler:
        def admit(self, n):
            pages = self.backend.alloc_view(n)
            if pages is None:
                return None                 # alloc failed: fine
            if bool(self.busy.any()):
                return None                 # LEAK: pages never released
            return pages
"""

GOOD_PG001 = """
    class Scheduler:
        def admit(self, n):
            pages = self.backend.alloc_view(n)
            if pages is None:
                return None
            if bool(self.busy.any()):
                self.backend.release(pages)
                return None
            return pages
"""


def test_pg001_catches_leaked_pages(tmp_path):
    findings = _scan(tmp_path, "scheduler.py", BAD_PG001, select="PG001")
    assert _rules_of(findings) == {"PG001"}


@pytest.mark.parametrize("name,src", [("scheduler.py", GOOD_PG001),
                                      ("kv_pages.py", BAD_PG001)])
def test_pg001_silent_when_released_or_out_of_scope(tmp_path, name, src):
    assert _scan(tmp_path, name, src, select="PG001") == []


def test_as001_catches_serve_assert_and_ignores_kernels(tmp_path):
    src = "def fill(self, slot):\n    assert slot >= 0\n    return slot\n"
    findings = _scan(tmp_path, "serve/scheduler.py", src, select="AS001")
    assert _rules_of(findings) == {"AS001"}
    assert _scan(tmp_path, "kernels/kern.py", src, select="AS001") == []


def _ref_cases():
    ref = _ref_module()
    cases = []
    for attr, names in (("BAD_PG001", ("scheduler.py", "kv_pages.py")),
                        ("GOOD_PG001", ("scheduler.py",)),
                        ("BAD_PG001_FORK_PARTIAL", ("scheduler.py",)),
                        ("GOOD_PG001_FORK_PARTIAL", ("scheduler.py",)),
                        ("BAD_AS001", ("serve/scheduler.py",
                                       "kernels/kern.py"))):
        cases += [(attr, name, getattr(ref, attr)) for name in names]
    return cases


@pytest.mark.parametrize("attr,name,src", _ref_cases(),
                         ids=lambda v: v if isinstance(v, str) and
                         "\n" not in v else "src")
def test_pg001_as001_match_the_reference_checker(tmp_path, attr, name, src):
    """The reference's own PG001 / AS001 fixtures: both registries give
    the same (line, rule) findings."""
    path = str(_write(tmp_path, name, src))
    rules = {"PG001", "AS001"}
    ours = {(f.line, f.rule) for f in run_rules(Project([path]),
                                                select=rules)}
    theirs = {(f.line, f.rule) for f in ref_sc.run_rules(
        ref_sc.Project([path]), select=rules)}
    assert ours == theirs
    in_scope = "kv_pages" not in name and "kernels" not in name
    assert bool(ours) == (attr.startswith("BAD") and in_scope)


# -- SH001: sharding-axis drift ---------------------------------------------

AXES = {"batch", "layers", "heads", "mlp", "kv_seq", "pages", "seq"}

BAD_SH001 = """
    import torch

    from repro_torch.parallel.sharding import resolve_axis, spec_for

    _STATE_AXES = {("h", 4): (None, "batch", "mpl", None)}

    def layout(cfg, mesh, rows):
        ax = resolve_axis("layer", cfg, mesh)
        return ax, spec_for(("batch", "sqe"), cfg, mesh, (rows, 16))
"""

GOOD_SH001 = """
    from repro_torch.parallel.sharding import resolve_axis, spec_for

    _STATE_AXES = {("h", 4): (None, "batch", "mlp", None)}

    def layout(cfg, mesh, rows, pre):
        ax = resolve_axis("layers", cfg, mesh)
        return ax, spec_for(pre + ("batch", "seq"), cfg, mesh)
"""


def _scan_axes(tmp_path, source):
    project = Project([str(_write(tmp_path, "mod.py", source))],
                      known_axes=AXES)
    return run_rules(project, select={"SH001"})


def test_sh001_catches_axis_typos_in_calls_and_tables(tmp_path):
    findings = _scan_axes(tmp_path, BAD_SH001)
    assert _rules_of(findings) == {"SH001"}
    assert sorted(f.message.split("`")[1] for f in findings) == \
        ["layer", "mpl", "sqe"]


def test_sh001_silent_on_known_axes_and_concat(tmp_path):
    assert _scan_axes(tmp_path, GOOD_SH001) == []


def test_sh001_vocabulary_extracted_from_the_ports_tree():
    """ShardingConfig's string fields (configs/base.py) and the alias
    keys of parallel/sharding.py's ``_ALIASES``; the port's own tree is
    clean under it (no baseline entry)."""
    from repro_torch.analysis.staticcheck.rules_sharding import _known_axes
    project = Project([str(PORT)])
    known = _known_axes(project)
    for ax in ("batch", "layers", "heads", "kv_seq", "pages", "fsdp",
               "kv_heads", "seq", "head_dim", "state", "conv"):
        assert ax in known, ax
    assert "compress_grads" not in known
    assert run_rules(project, select={"SH001"}) == []


@pytest.mark.parametrize("attr", ["BAD_SH001", "GOOD_SH001"])
def test_sh001_matches_the_reference_checker(tmp_path, attr):
    """The reference's own SH001 fixtures under its vocabulary: both
    registries give the same (line, rule) findings."""
    ref = _ref_module()
    path = str(_write(tmp_path, "mod.py", getattr(ref, attr)))
    ours = {(f.line, f.rule) for f in run_rules(
        Project([path], known_axes=ref.AXES), select={"SH001"})}
    theirs = {(f.line, f.rule) for f in ref_sc.run_rules(
        ref_sc.Project([path], known_axes=ref.AXES), select={"SH001"})}
    assert ours == theirs
    assert bool(ours) == attr.startswith("BAD")


# -- KW001: kernel wrappers --------------------------------------------------

WRAPPER = """
    import ctypes
    import os

    import torch

    from repro_torch.kernels import build

    _USE_KERNEL = True
    _LIB = None


    def _lib():
        return build.load("mykernel")


    def mykernel_ref(x):
        return x * 2


    def mykernel(x):
{body}
"""


def _wrapper(body):
    return WRAPPER.format(body=textwrap.indent(textwrap.dedent(body),
                                               " " * 8))


BAD_KW001 = {
    "except_ref": "try:\n    return _lib().launch(x)\n"
                  "except OSError:\n    return mykernel_ref(x)\n",
    "except_return": "try:\n    _lib().launch(x)\nexcept Exception:\n"
                     "    return None\nreturn x\n",
    "except_pass": "try:\n    build.build(['mykernel'])\nexcept RuntimeError:\n"
                   "    pass\nreturn x\n",
    "environ": "if os.environ.get('USE_PLAIN') == '1':\n"
               "    return mykernel_ref(x)\nreturn _lib().launch(x)\n",
    "getenv": "return mykernel_ref(x) if os.getenv('PLAIN') else x\n",
    "is_available": "if not torch.cuda.is_available():\n"
                    "    return mykernel_ref(x)\nreturn _lib().launch(x)\n",
    "module_flag": "if _USE_KERNEL and x.is_cuda:\n"
                   "    return _lib().launch(x)\nreturn mykernel_ref(x)\n",
    "global_flag": "global _LIB\n_LIB = _LIB or _lib()\n"
                   "if _LIB:\n    return _LIB.launch(x)\nreturn x\n",
}

GOOD_KW001 = {
    "reraise": "try:\n    return _lib().launch(x)\nexcept OSError as e:\n"
               "    raise RuntimeError('mykernel: build failed') from e\n",
    "device_route": "if x.is_cuda:\n    return _lib().launch(x)\n"
                    "if x.is_meta:\n    return torch.empty_like(x)\n"
                    "return mykernel_ref(x)\n",
    "dtype_shape": "if x.dtype not in (torch.float32, torch.bfloat16) or "
                   "x.shape[-1] % 8:\n"
                   "    raise ValueError('unsupported')\n"
                   "return _lib().launch(x)\n",
    "host_except": "try:\n    n = int(os.cpu_count())\nexcept TypeError:\n"
                   "    n = 1\nreturn x * n\n",
}


@pytest.mark.parametrize("case", sorted(BAD_KW001))
def test_kw001_catches_hidden_kernel(tmp_path, case):
    findings = _scan(tmp_path, "kernels/mykernel.py",
                     _wrapper(BAD_KW001[case]), select="KW001")
    assert _rules_of(findings) == {"KW001"}, case


@pytest.mark.parametrize("case", sorted(GOOD_KW001))
def test_kw001_silent_on_device_dispatch(tmp_path, case):
    assert _scan(tmp_path, "kernels/mykernel.py", _wrapper(GOOD_KW001[case]),
                 select="KW001") == [], case


def test_kw001_scope_is_kernels_only(tmp_path):
    src = _wrapper(BAD_KW001["environ"])
    assert _scan(tmp_path, "models/mykernel.py", src, select="KW001") == []


def test_kw001_silent_on_the_ports_dispatch():
    """kernels/ops.py routes by ``t.is_cuda`` / ``kernel_route``."""
    project = Project([str(PORT / "kernels")])
    assert run_rules(project, select={"KW001"}) == []


# -- step-region resolver ----------------------------------------------------

def test_resolver_marks_step_factory_inner_defs(tmp_path):
    src = """
        import torch

        def make_serve_fn(cfg):
            def serve_step(x):
                if torch.any(x > 0):          # step region: must flag
                    return x
                return -x
            return serve_step
    """
    findings = _scan(tmp_path, "steps.py", src, select="RC001")
    assert _rules_of(findings) == {"RC001"}


def test_resolver_narrows_host_factories(tmp_path):
    """``make_*`` factories without the ``_fn`` / ``_step`` suffix build
    host objects (``make_pipeline``, ``make_backend``): their inner defs
    stay host code."""
    src = """
        import torch

        def make_pipeline(rcfg, seed):
            def batch_at(step):
                return torch.from_numpy(seed_batch(step)).to("cuda")
            def loss_of(t):
                return t.item()
            return batch_at, loss_of
    """
    project = Project([str(_write(tmp_path, "pipeline.py", src))])
    assert project.step_functions() == []
    assert run_rules(project) == []


def test_resolver_follows_cross_module_references(tmp_path):
    _write(tmp_path, "helpers.py", """
        import torch

        def inner(x):
            if torch.any(x > 0):            # reached from steps.py's step
                return x
            return -x
    """)
    _write(tmp_path, "steps.py", """
        from helpers import inner

        def make_train_fn(rcfg):
            def train_step(x):
                return inner(x)
            return train_step
    """)
    project = Project([str(tmp_path)])
    names = {fn.name for _, fn in project.step_functions()}
    assert {"train_step", "inner"} <= names
    assert _rules_of(run_rules(project, select={"RC001"})) == {"RC001"}


def test_resolver_marks_autograd_functions_and_partials(tmp_path):
    _write(tmp_path, "kern.py", """
        import torch

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, g):
                return g * float(g.abs().max())   # a sync in backward

        def helper(x, scale):
            return x.item() * scale               # reached via partial
    """)
    _write(tmp_path, "backend.py", """
        import functools

        import kern

        def decode_fn():
            return functools.partial(kern.helper, scale=2)
    """)
    project = Project([str(tmp_path)])
    names = {fn.name for _, fn in project.step_functions()}
    assert {"forward", "backward", "helper"} <= names
    lines = {(pathlib.Path(f.path).name, f.rule)
             for f in run_rules(project, select={"RC002"})}
    assert lines == {("kern.py", "RC002")}
    assert len(run_rules(project, select={"RC002"})) == 2


def _tree_project():
    return Project([str(PORT)])


def test_resolver_on_the_ports_tree():
    project = _tree_project()
    step = {(pathlib.Path(m.relpath).name, fn.name)
            for m, fn in project.step_functions()}
    for want in (("steps.py", "paged_serve_step"),
                 ("steps.py", "paged_verify_step"),
                 ("steps.py", "draft_wave"), ("steps.py", "train_step"),
                 ("steps.py", "serve_step"), ("steps.py", "up"),
                 ("lp.py", "forward"), ("lp.py", "backward"),
                 ("ops.py", "forward"), ("moe.py", "backward"),
                 ("flash_attention.py", "backward"),
                 ("transformer.py", "paged_decode_step"),
                 ("mgrit.py", "mgrit_solve")):
        assert want in step, want
    for host in (("cache.py", "_apply"), ("cache.py", "make_backend"),
                 ("trainer.py", "train"), ("trainer.py", "_probe"),
                 ("pipeline.py", "make_pipeline"),
                 ("scheduler.py", "step"), ("engine.py", "generate")):
        assert host not in step, host
    steps_py = "src/repro_torch/launch/steps.py"
    line = next(i for i, t in enumerate(
        (PORT / "launch" / "steps.py").read_text().splitlines(), 1)
        if "torch.from_numpy(np.ascontiguousarray(a)).to(device" in t)
    assert project.step_region_at(steps_py.split("src/")[1], line) == "up"
    cache = (PORT / "serve" / "cache.py").read_text().splitlines()
    line = next(i for i, t in enumerate(cache, 1) if "nxt.cpu().numpy()" in t)
    assert project.step_region_at("serve/cache.py", line) is None


# -- the port's tree ---------------------------------------------------------

def test_all_rules_silent_on_serve_cache():
    """serve/cache.py alone (host half and the backends' step wiring)."""
    assert run_rules(Project([str(PORT / "serve" / "cache.py")])) == []


def test_host_numpy_and_dtype_casts_stay_silent_on_the_tree():
    """launch/steps.py's ``any_sampled = bool(np.any(np.asarray(temps) >
    0.0))`` and models/mlp.py's dtype casts: no finding."""
    findings = run_rules(_tree_project())
    src = (PORT / "launch" / "steps.py").read_text().splitlines()
    host = {i for i, t in enumerate(src, 1) if "np.asarray(temps)" in t}
    assert len(host) == 3
    assert not [f for f in findings
                if f.path.endswith("launch/steps.py") and f.line in host]
    assert not [f for f in findings if f.path.endswith("models/mlp.py")]


def test_tree_is_clean_under_its_baseline():
    """Every finding of the port's tree is baselined with a reason, and
    no baseline entry is stale."""
    project = Project([str(PORT)])
    rel = {m.relpath: m.relpath.split(str(REPO) + "/", 1)[-1]
           for m in project.iter_modules()}
    findings = run_rules(project)
    lines = {rel[m.relpath]: m.lines for m in project.iter_modules()}
    findings = [type(f)(rel[f.path], f.line, f.rule, f.message, f.hint)
                for f in findings]
    reasons = bl.load_reasons(str(BASELINE))
    fresh, held, stale = bl.split(findings, lines, set(reasons))
    assert fresh == [], [f.render() for f in fresh]
    assert stale == set()
    assert held and all(reasons.values()), reasons


# -- baseline + CLI ----------------------------------------------------------

def _bad_serve(tmp_path):
    bad = tmp_path / "serve" / "scheduler.py"
    bad.parent.mkdir()
    bad.write_text("def f(x):\n    assert x\n    return x\n")
    return bad


def test_cli_baseline_roundtrip(tmp_path, capsys):
    bad = _bad_serve(tmp_path)
    baseline = tmp_path / "baseline.txt"
    assert cli_main([str(bad)]) == 1                 # finding, no baseline
    assert cli_main([str(bad), "--write-baseline",
                     "--baseline", str(baseline)]) == 0
    assert cli_main([str(bad), "--baseline", str(baseline)]) == 0
    # editing the flagged line invalidates its fingerprint
    bad.write_text("def f(x):\n    assert x is not None\n    return x\n")
    assert cli_main([str(bad), "--baseline", str(baseline)]) == 1
    # fixing the finding makes the old entry stale (warned, still green)
    bad.write_text("def f(x):\n    return x\n")
    capsys.readouterr()
    assert cli_main([str(bad), "--baseline", str(baseline)]) == 0
    assert "stale baseline entry" in capsys.readouterr().err


@pytest.mark.parametrize("writer,reader", [(cli_main, ref_cli),
                                           (ref_cli, cli_main)])
def test_baseline_loads_in_the_other_checker(tmp_path, writer, reader):
    bad = _bad_serve(tmp_path)
    baseline = tmp_path / "baseline.txt"
    assert writer([str(bad), "--write-baseline", "--baseline",
                   str(baseline)]) == 0
    assert reader([str(bad), "--select", "AS001",
                   "--baseline", str(baseline)]) == 0


def test_cli_default_baseline_is_the_ports_own(tmp_path, monkeypatch):
    """``staticcheck-torch-baseline.txt`` in the working directory is
    read; the JAX package's ``staticcheck-baseline.txt`` never is."""
    bad = _bad_serve(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert ref_cli([str(bad), "--write-baseline"]) == 0
    assert (tmp_path / "staticcheck-baseline.txt").exists()
    assert cli_main([str(bad)]) == 1
    (tmp_path / "staticcheck-baseline.txt").rename(
        tmp_path / "staticcheck-torch-baseline.txt")
    assert cli_main([str(bad)]) == 0


@pytest.mark.parametrize("args,rc", [
    (["--select", "PG001"], 0), (["--ignore", "AS001"], 0),
    (["--select", "AS001"], 1), (["--select", "NOPE"], 2),
    (["--ignore", "DN001"], 2)])
def test_cli_select_and_ignore(tmp_path, args, rc):
    assert cli_main([str(_bad_serve(tmp_path)), *args]) == rc


def test_cli_missing_path():
    assert cli_main(["/no/such/path"]) == 2


def test_cli_github_summary(tmp_path):
    bad = _bad_serve(tmp_path)
    summary = tmp_path / "summary.md"
    assert cli_main([str(bad), "--github-summary", str(summary)]) == 1
    text = summary.read_text()
    assert "AS001" in text and "| location |" in text


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULES:
        assert rid in out


def test_cli_on_the_ports_tree_exits_0(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert cli_main(["src/repro_torch"]) == 0
    assert "clean" in capsys.readouterr().out


# -- README's catalog --------------------------------------------------------

def test_readme_port_rule_catalog_matches_registry():
    """The first column of README's port rule catalog names exactly the
    registered rules (the mirror of tests/test_docs.py's catalog test)."""
    body = (REPO / "README.md").read_text(encoding="utf-8")
    port = body[body.index("## PyTorch port"):]
    port = port[:port.index("\n## ", 1)]
    head = port.index("| Port rule |")
    rows = port[head:].split("\n\n", 1)[0].splitlines()[2:]
    named = {m.group(1) for r in rows
             if (m := re.match(r"\s*\|\s*`([A-Z]{2}\d{3})`\s*\|", r))}
    assert named == set(RULES), (named, sorted(RULES))
