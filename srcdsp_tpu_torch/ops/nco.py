"""NCO mixer (counterpart of ``srcdsp_tpu/ops/nco.py``).

The accumulator is fixed-point: a uint32 counting in 2^-32 turns, so
``phase[k] = phase0 + k*df`` is exact and associative across any block
split. torch has no general uint32 arithmetic, so words are carried as
int64 tensors holding values in [0, 2^32) and every sum is masked with
``& 0xFFFFFFFF``. The words are bit-exact with the JAX package's; the angle
they become is float32, as there.

    phase_u32[k] = phase0 + k * df          (mod 2^32, exact)
    w[k]         = exp(+j * 2*pi * phase_u32[k] * 2^-32)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve

TWO_PI = 6.283185307179586
MASK32 = 0xFFFFFFFF
_SCALE = 4294967296.0  # 2^32 turns per wrap
_INV_SCALE = 1.0 / _SCALE


def freq_to_word(freq) -> np.ndarray:
    """Quantize frequency (cycles/sample) to a uint32 tuning word (host, float64)."""
    f = np.asarray(freq, np.float64)
    word = np.round((f - np.floor(f)) * _SCALE) % _SCALE
    return word.astype(np.uint32)


def _mod_f32(x: torch.Tensor, m: float) -> torch.Tensor:
    """Floating modulus with the divisor's sign, as ``jnp.mod`` computes it:
    the exact ``fmod``, plus the divisor where the signs differ."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + np.float32(m), r)


def host_phase(freq: float, n: int) -> np.ndarray:
    """2 pi frac(freq k) for k < n, made exactly in float64 on the host and
    cast to float32: an unwrapped float32 ramp loses about half a radian by
    sample 16M (the APT and SSTV receivers' mixing phase)."""
    return (2 * np.pi * np.mod(freq * np.arange(n, dtype=np.float64), 1.0)).astype(np.float32)


def freq_to_word_traced(freq) -> torch.Tensor:
    """u32 tuning word (an int64 tensor) from a float32 frequency on the
    device, for loops that retune per block (``ops.afc``). The JAX package's
    contract bit for bit: the modular maths in float32, rounding half to
    even, then the word through int64."""
    f = torch.as_tensor(freq, dtype=torch.float32)
    w = _mod_f32(torch.round(_mod_f32(f, 1.0) * np.float32(_SCALE)), _SCALE)
    return w.to(torch.int64) & MASK32


def word_tensor(words, device=None) -> torch.Tensor:
    """u32 tuning/phase words as an int64 tensor in [0, 2^32).

    Accepts Python ints, numpy arrays (uint32, or int32 holding the same bits)
    and tensors; negative int32 values map to the u32 word with the same bits.
    """
    if isinstance(words, torch.Tensor):
        return words.to(device=device if device is not None else words.device,
                        dtype=torch.int64) & MASK32
    w = np.asarray(words)
    return torch.as_tensor(w.astype(np.int64) & MASK32, device=device)


class NcoState(NamedTuple):
    """Carried oscillator phase: u32 words held in int64. Shape = channel shape."""

    phase: torch.Tensor  # [...] int64 in [0, 2^32)


def nco_init(channel_shape: tuple = (), phase0: float = 0.0, device=None) -> NcoState:
    word = int(np.round((phase0 % 1.0) * _SCALE) % _SCALE)
    return NcoState(phase=torch.full(channel_shape, word, dtype=torch.int64,
                                     device=resolve(device)))


def phase_angle(words: torch.Tensor) -> torch.Tensor:
    """u32 words -> float32 angle in radians, as ``ops.nco`` computes it:
    ``float32(word) * 2^-32 * 2*pi`` (turns in [0, 1))."""
    ph = words.to(torch.float32) * np.float32(_INV_SCALE)
    return ph * np.float32(TWO_PI)


def nco_phasor(freq_word, state: NcoState, n: int) -> tuple[NcoState, torch.Tensor]:
    """n samples of exp(+j*2*pi*phase) from the u32 accumulator.

    freq_word: u32 word, scalar or per-channel ``[...]`` broadcasting against
    ``state.phase``. Returns (state, ``[..., n]`` complex64).
    """
    dev = state.phase.device
    df = word_tensor(freq_word, dev)
    k = torch.arange(n, dtype=torch.int64, device=dev)
    ph = (state.phase[..., None] + k * df[..., None]) & MASK32
    ang = phase_angle(ph)
    w = torch.polar(torch.ones_like(ang), ang)
    new_phase = (state.phase + n * df) & MASK32
    return NcoState(phase=new_phase), w


def nco_apply(freq_word, state: NcoState, x: torch.Tensor) -> tuple[NcoState, torch.Tensor]:
    """Mix: y = x * exp(+j*2*pi*phase[n]). Frequency-shifts x by +freq."""
    new_state, w = nco_phasor(freq_word, state, x.shape[-1])
    return new_state, (x * w).to(torch.complex64)
