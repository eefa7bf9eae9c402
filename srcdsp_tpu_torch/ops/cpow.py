"""Integer power of complex samples held as planes.

XLA's integer power, which the reference uses (``sym ** order``), multiplies;
``torch.pow`` on complex tensors goes through exp and log instead. One
helper for the PSK chains and the bank kernel's plain epilogue.
"""

from __future__ import annotations

import torch


def cpow(yr: torch.Tensor, yi: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(yr + j yi)^n for an integer n >= 1 by binary exponentiation, low bit
    first (XLA's order): for a power of two, repeated squaring
    (re, im) -> (re^2 - im^2, 2 re im), which the CUDA K13 epilogue mirrors."""
    if n < 1:
        raise ValueError(f"exponent must be >= 1, got {n}")
    acc = None
    xr, xi = yr, yi
    while True:
        if n & 1:
            acc = (xr, xi) if acc is None else (acc[0] * xr - acc[1] * xi,
                                                acc[0] * xi + acc[1] * xr)
        n >>= 1
        if n == 0:
            return acc
        xr, xi = xr * xr - xi * xi, 2.0 * xr * xi
