"""Signal generators (counterpart of ``srcdsp_tpu/testing/signals.py``).

numpy with float64 phase and an explicit ``np.random.Generator``: the same
seed gives the same data on any host. Callers move the result to a device.
"""

from __future__ import annotations

import numpy as np


def tone(n: int, freq: float, phase0: float = 0.0, amplitude: float = 1.0) -> np.ndarray:
    """Complex exponential at `freq` cycles/sample: a*exp(j*2pi*(f*n + p0))."""
    k = np.arange(n, dtype=np.float64)
    return (amplitude * np.exp(2j * np.pi * ((freq * k + phase0) % 1.0))).astype(np.complex64)


def random_bits(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    """Fair random bits {0, 1} as int32."""
    return rng.integers(0, 2, size=shape, dtype=np.int32)


def fsk_baseband(bits, sps: int, dev: float) -> np.ndarray:
    """CPFSK baseband: frequency +/-dev (cycles/sample) per bit, phase-continuous.

    bits: [..., Nsym] of {0,1} -> [..., Nsym*sps] complex64.
    """
    f = (2.0 * np.asarray(bits, np.float64) - 1.0) * dev     # [..., Nsym]
    f = np.repeat(f, sps, axis=-1)                            # [..., N]
    ph = np.cumsum(f, axis=-1) - f                            # phase BEFORE each step
    return np.exp(2j * np.pi * (ph % 1.0)).astype(np.complex64)
