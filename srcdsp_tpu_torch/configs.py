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


CONFIG1_SERVING = ("ctaps", "ctaps_bf16io", "preframed", "preframed_bf16io")


def build_config1_serving(n: int = 1 << 26, variant: str = "preframed_bf16io",
                          device=None) -> BuiltConfig:
    """Config 1 on the complex-taps serving kernels: the counterparts of
    bench.py's ``_make_ctaps`` (variants ``ctaps``, ``ctaps_bf16io``: K4 on raw
    planes) and ``_make_preframed`` (``preframed``, ``preframed_bf16io``: K5 on
    frames), with their taps lowpass(64, 0.2), word freq_to_word(0.11),
    decim 2, out_tile 512, b_rows 32 and seed-0 standard_normal((2, hist+n))
    input. ``_bf16io`` ships the input as bf16. The preframed variants frame
    on the host when they are built, outside the step, as bench.py does.

    step(*example) returns (yr, yi): [1, n/2] for ctaps, [NT, 512] for
    preframed, as the JAX steps do.
    """
    from srcdsp_tpu_torch.kernels.mixfir_ctaps import make_mix_fir_ctaps_kernel, mix_fir_ctaps
    from srcdsp_tpu_torch.kernels.mixfir_preframed import (
        frame_planes, make_ctaps_preframed_kernel)
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.window import lowpass

    if variant not in CONFIG1_SERVING:
        raise ValueError(f"variant {variant!r} not in {CONFIG1_SERVING}")
    t, m, out_tile, b_rows = 64, 2, 512, 32
    taps = lowpass(t, 0.2)
    word = int(freq_to_word(0.11))
    dt = torch.bfloat16 if variant.endswith("_bf16io") else torch.float32
    meta = dict(taps=t, decim=m, impl=variant)
    if variant.startswith("ctaps"):
        k = make_mix_fir_ctaps_kernel(taps, word, m, out_tile=out_tile, b_rows=b_rows,
                                      in_dtype=dt, device=device)
        hist, blk = k.hist, k.block_in()
    else:
        fn, hist, stride, span = make_ctaps_preframed_kernel(
            taps, word, m, out_tile=out_tile, b_rows=b_rows, in_dtype=dt, device=device)
        blk = b_rows * stride
    n = (n // blk) * blk
    if n == 0:
        raise ValueError(f"n smaller than one kernel block of {blk} samples")
    word0 = (-hist * word) % (1 << 32)
    planes = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, hist + n)).astype(np.float32))
    if variant.startswith("ctaps"):
        x = planes.to(dt).to(device)
        return BuiltConfig(lambda p: mix_fir_ctaps(k, word0, p), (x,), n, meta)
    fr = frame_planes(planes, stride, span).to(dt)
    xr_f, xi_f = fr[0].to(device), fr[1].to(device)
    return BuiltConfig(lambda r, i: fn(word0, r, i), (xr_f, xi_f), n, meta)


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
