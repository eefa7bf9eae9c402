"""Sample types and format conversions (counterpart of ``srcdsp_tpu/types.py``).

The same rules as the JAX package and the C++ oracle, so integer paths are
bit-exact across all three:

    int16 -> float:  y = x / scale                  (exact in float32)
    float -> int16:  y = clip(rint(x * scale), -32768, 32767)

``torch.round`` rounds half to even, like ``np.rint`` and ``std::nearbyint``.
"""

from __future__ import annotations

import numpy as np
import torch

CF32 = torch.complex64
F32 = torch.float32
I16 = torch.int16

#: Default full-scale for int16 IQ captures: int16 full scale maps to 1.0.
DEFAULT_SCALE = 32767.0

#: Finite float32-max sentinel for masked reductions and path metrics
#: (the JAX package's ``F32_BIG``).
F32_BIG = np.float32(3.4e38)

INT16_MIN = -32768
INT16_MAX = 32767


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on `like`'s device, so the arithmetic stays in f32."""
    return torch.tensor(np.float32(v), dtype=F32, device=like.device)


def int16_to_complex64(iq: torch.Tensor, scale: float = DEFAULT_SCALE) -> torch.Tensor:
    """Interleaved int16 IQ ``[..., 2*N]`` or split ``[..., N, 2]`` -> complex64 ``[..., N]``."""
    if iq.shape[-1] != 2:
        if iq.shape[-1] % 2 != 0:
            raise ValueError(f"interleaved IQ length must be even, got {tuple(iq.shape)}")
        iq = iq.reshape(*iq.shape[:-1], iq.shape[-1] // 2, 2)
    f = iq.to(F32) / _f32(scale, iq)
    return torch.complex(f[..., 0], f[..., 1])


def complex64_to_int16(x: torch.Tensor, scale: float = DEFAULT_SCALE,
                       interleave: bool = True) -> torch.Tensor:
    """complex64 ``[..., N]`` -> int16 IQ, saturating, round-half-even.

    Returns ``[..., 2*N]`` interleaved if `interleave` else ``[..., N, 2]``.
    """
    s = _f32(scale, x)
    i = torch.clamp(torch.round(x.real * s), INT16_MIN, INT16_MAX)
    q = torch.clamp(torch.round(x.imag * s), INT16_MIN, INT16_MAX)
    out = torch.stack([i, q], dim=-1).to(I16)
    if interleave:
        out = out.reshape(*out.shape[:-2], -1)
    return out


# numpy twins, used by file I/O and fixture generation (host side).

def np_int16_to_complex64(iq: np.ndarray, scale: float = DEFAULT_SCALE) -> np.ndarray:
    if iq.shape[-1] != 2:
        iq = iq.reshape(*iq.shape[:-1], iq.shape[-1] // 2, 2)
    f = iq.astype(np.float32) / np.float32(scale)
    return (f[..., 0] + 1j * f[..., 1]).astype(np.complex64)


def np_complex64_to_int16(x: np.ndarray, scale: float = DEFAULT_SCALE, interleave: bool = True) -> np.ndarray:
    i = np.clip(np.rint(x.real * np.float32(scale)), INT16_MIN, INT16_MAX)
    q = np.clip(np.rint(x.imag * np.float32(scale)), INT16_MIN, INT16_MAX)
    out = np.stack([i, q], axis=-1).astype(np.int16)
    if interleave:
        out = out.reshape(*out.shape[:-2], -1)
    return out
