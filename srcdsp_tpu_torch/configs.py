"""Config-1 and config-4 presets on the port (counterpart of ``srcdsp_tpu/configs.py``).

Each build_config* function returns (step fn, example inputs, samples per call, metadata),
with the same shapes, taps and tuning as the JAX presets. Config 1 makes its
input planes from the same seeded numpy generator, so both packages see the
same samples.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class BuiltConfig:
    step: Callable          # (inputs...) -> outputs
    example: tuple          # example inputs
    samples_per_call: int   # input samples consumed per step call
    meta: dict


def _rng_planes(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n).astype(np.float32)


def build_config1(n: int = 1 << 20, use_kernel: bool = False, device=None) -> BuiltConfig:
    """Single-channel 64-tap FIR lowpass + 2x decimate (+NCO mix fused).

    use_kernel=True runs K1 (``kernels.mixfir``; the JAX preset's
    use_pallas=True), else the plain plane tier (``ops.planes``).
    """
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.window import lowpass

    t, m = 64, 2
    taps = lowpass(t, 0.2)
    word = int(freq_to_word(0.11))

    if use_kernel:
        from srcdsp_tpu_torch.kernels.mixfir import make_mix_fir_kernel, mix_fir_decim
        out_tile = 512
        b_rows = min(32, max(1, n // (out_tile * m)))
        k = make_mix_fir_kernel(taps, m, out_tile=out_tile, b_rows=b_rows, device=device)
        n = (n // k.block_in()) * k.block_in()
        word0 = (-k.hist * word) % (1 << 32)
        planes = torch.as_tensor(
            np.stack([_rng_planes(k.hist + n, 1), _rng_planes(k.hist + n, 2)]), device=device)
        return BuiltConfig(lambda p: mix_fir_decim(k, word0, word, p), (planes,), n,
                           dict(taps=t, decim=m, impl="kernel"))

    from srcdsp_tpu_torch.ops.planes import (
        fused_mix_fir_decim_planes, phase_coef_matrix, plane_hist_len)
    coef = torch.as_tensor(phase_coef_matrix(taps, m), device=device)
    h = plane_hist_len(t, m)
    word0 = (-h * word) % (1 << 32)
    xr = torch.as_tensor(_rng_planes(h + n, 1), device=device)[None]
    xi = torch.as_tensor(_rng_planes(h + n, 2), device=device)[None]
    return BuiltConfig(lambda r, i: fused_mix_fir_decim_planes(coef, word0, word, r, i, m),
                       (xr, xi), n, dict(taps=t, decim=m, impl="planes"))


def build_config4(nsym: int = 2048, channels: int = 32, device=None) -> BuiltConfig:
    """FSK demod chain: mix + filter + discriminator + symbol timing.

    The JAX preset draws its bits from jax.random; here they come from a
    seeded numpy generator (returned in meta["bits"]).
    """
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone

    decim, sps, dev, center = 4, 8, 0.05, 0.11
    params = make_fsk_params(center, 64, 0.03, decim, sps, dev, device=device)
    bits = random_bits(np.random.default_rng(0), (channels, nsym))
    bb = fsk_baseband(bits, decim * sps, dev / decim)
    x = torch.as_tensor(bb * tone(bb.shape[-1], center), device=device)
    st = fsk_init(params, (channels,))
    return BuiltConfig(lambda s, xb: fsk_apply(params, s, xb), (st, x),
                       int(x.shape[-1]) * channels,
                       dict(channels=channels, impl="torch", bits=bits))
