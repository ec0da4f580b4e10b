"""repro_torch.analysis.staticcheck — the port's AST checker.

Stdlib-only: no torch, no jax, nothing of the JAX package. Importing the
package registers every rule module; the registry (``RULES``) is the
single source of truth for rule ids — ``tests/test_torch_staticcheck.py``
holds README's port rule catalog against it.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.staticcheck src/repro_torch
"""
from .core import RULES, Finding, Project, Rule, rule, run_rules
from . import (rules_jit, rules_kernels, rules_pages,  # noqa: F401
               rules_serve, rules_sharding)

__all__ = ["RULES", "Finding", "Project", "Rule", "rule", "run_rules"]
