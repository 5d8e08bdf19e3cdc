"""Numerical-health and debug tooling (JAX ``utils/debugging.py``).

The reference's only runtime guards are
``torch.autograd.set_detect_anomaly(True)`` (training.py:109) and
scattered asserts; the counterparts here:

* ``enable_nan_checks``: autograd's anomaly detection, so that a backward
  that makes a NaN raises and names its forward op (JAX's debug_nans /
  debug_infs);
* ``checked``: a wrapper that raises on the host when a function's
  floating outputs are not finite, or when the function's own checks fail
  (JAX's checkify with its float checks);
* ``assert_finite_tree``: a finite check over dicts, lists and tuples of
  tensors (params, grads, state_dicts);
* ``set_deterministic``: deterministic algorithms and cuBLAS's fixed
  workspace, for reproducible runs.
"""

from __future__ import annotations

import os
from typing import Any

import torch

def enable_nan_checks(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError naming every floating tensor of ``tree``
    that holds a NaN or an infinity."""
    bad = [path for path, leaf in _leaves(tree)
           if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
           and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}: {bad[:10]}"
            + (f" (+{len(bad) - 10} more)" if len(bad) > 10 else ""))


def checked(fn):
    """Wrap ``fn`` so that a failed check raises on the host: an exception
    of ``fn`` itself, or non-finite floating outputs."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite_tree(out, getattr(fn, "__name__", "output"))
        return out

    return wrapper


def set_deterministic(enable: bool = True) -> None:
    """Deterministic algorithms (an op without one raises), and cuBLAS's
    fixed workspace, which they need on the card; set before the first
    cuBLAS call."""
    if enable:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(enable)
