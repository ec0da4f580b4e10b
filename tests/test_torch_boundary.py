"""Import boundary of the port: ``repro_torch`` imports torch, numpy and
the stdlib — never ``jax`` and nothing of the JAX package ``repro``, not
even its jax-free modules (the port keeps its own copies)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    names = [name for _, name in modules()]
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_imports_jax_or_repro():
    offenders = []
    for path, _ in modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(ROOT)}: {n}")
    assert not offenders, offenders


def test_module_list_covers_both_slices():
    """The walk above reaches the serving and the training modules (a
    package directory without ``__init__.py`` would drop out of it)."""
    names = {name for _, name in modules()}
    for mod in ("repro_torch.serve.engine", "repro_torch.kernels.sampling",
                "repro_torch.kernels.paged_attention",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.rmsnorm", "repro_torch.core.mgrit",
                "repro_torch.core.lp", "repro_torch.core.adaptive",
                "repro_torch.optim.optimizers", "repro_torch.data.pipeline",
                "repro_torch.launch.train", "repro_torch.train.trainer",
                "repro_torch.tree"):
        assert mod in names, mod
    for path, _ in modules():
        pkg = path.parent
        while pkg != PKG.parent:
            assert (pkg / "__init__.py").exists(), pkg
            pkg = pkg.parent
