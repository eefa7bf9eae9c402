"""Numerical sanitizers (counterpart of ``srcdsp_tpu/debug.py``).

The hazards are numerical: a NaN or Inf escaping a chain step. This module
provides the numeric guards:

- `checked(fn)`: wrap a chain step so every float or complex leaf of its
  output is checked finite; the error names the first bad leaf's path.
- `assert_finite(tree)`: host-side check for tests and debugging.

The reference raises ``checkify.JaxRuntimeError`` from `checked`; here it is
`NonFiniteError`, a ``FloatingPointError``. The check is one finiteness
reduction per leaf, stacked, and one host read per call; it uses no
device-side assert, which would leave the CUDA context unusable.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from srcdsp_tpu_torch import tree


class NonFiniteError(FloatingPointError):
    """A NaN or Inf in an output leaf of a `checked` function."""


def _inexact(x) -> bool:
    return isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex())


def checked(fn: Callable) -> Callable:
    """Wrap `fn` so every float or complex tensor leaf of its output is
    checked finite. Returns a function with the same signature; raises
    `NonFiniteError` naming the first leaf (in the reference's leaf order
    and ``keystr`` form, e.g. ``['y']``, ``.fir``, ``[0]``) that holds a NaN
    or Inf."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        pairs = [(p, x) for p, x in tree.flatten_with_path(out)[0] if _inexact(x)]
        if not pairs:
            return out
        first = pairs[0][1].device
        finite = torch.stack([torch.isfinite(x).all().to(first) for _, x in pairs]).tolist()
        if not all(finite):
            raise NonFiniteError(
                f"non-finite value in output leaf {pairs[finite.index(False)][0]}")
        return out

    return wrapper


def assert_finite(tree_: Any, name: str = "tree") -> None:
    """Host-side eager check (copies values to the host: tests/debug only)."""
    for path, leaf in tree.flatten_with_path(tree_)[0]:
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.inexact) and not np.all(np.isfinite(
                np.abs(arr) if np.iscomplexobj(arr) else arr)):
            raise FloatingPointError(f"non-finite values in {name}{path}")
