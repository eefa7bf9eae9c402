"""Config-1, config-2 and config-4 presets on the port (counterpart of
``srcdsp_tpu/configs.py``, and of ``bench/run.py``'s on-chip config-2 runs).

Each build_config* function returns (step fn, example inputs, samples per call, metadata),
with the same shapes, taps and tuning as the JAX presets. Configs 1 and 2 make
their inputs from the same seeded numpy generators, so both packages see the
same samples. Every builder runs on the card unless it is given a device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve


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

    device = resolve(device)
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
    device = resolve(device)
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


C2_WORD_FREQ, C2_UP, C2_DOWN = 0.07, 3, 4


def _config2_taps() -> tuple[np.ndarray, np.ndarray]:
    """Config 2's FIR lowpass(128, 0.2) and resampler lowpass(48, 0.3)."""
    from srcdsp_tpu_torch.ops.window import lowpass

    return lowpass(128, 0.2), lowpass(48, 0.3)


def config2_step(word, device=None):
    """Config 2's plain chain, ``ops.nco`` -> ``ops.fir`` -> ``ops.resample``,
    mixing by the u32 tuning `word` (one for every channel, or [C], one each).

    step(nco_s, fir_s, rs_s, x [C, N]) -> (nco_s, fir_s, rs_s, z [C, 3N/4]).
    """
    from srcdsp_tpu_torch.ops.fir import fir_apply
    from srcdsp_tpu_torch.ops.nco import nco_apply
    from srcdsp_tpu_torch.ops.resample import resample_apply

    taps_np, rtaps = _config2_taps()
    taps = torch.as_tensor(taps_np, device=resolve(device))

    def step(nco_s, fir_s, rs_s, x):
        nco_s, m = nco_apply(word, nco_s, x)
        fir_s, y = fir_apply(taps, fir_s, m)
        rs_s, z = resample_apply(rtaps, rs_s, y, up=C2_UP, down=C2_DOWN)
        return nco_s, fir_s, rs_s, z

    return step


def build_config2(n: int = 1 << 18, channels: int = 4, device=None) -> BuiltConfig:
    """NCO mix + 128-tap FIR + rational 3/4 resample, 4 channels: the plain
    chain (`config2_step`), with the JAX preset's taps, word and seed-0
    complex input.

    step(nco_s, fir_s, rs_s, x [C, N]) -> (nco_s, fir_s, rs_s, z [C, 3N/4]).
    """
    from srcdsp_tpu_torch.ops.fir import fir_init
    from srcdsp_tpu_torch.ops.nco import freq_to_word, nco_init
    from srcdsp_tpu_torch.ops.resample import resample_init

    device = resolve(device)
    taps_np, rtaps = _config2_taps()
    n = (n // 4) * 4
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        (rng.standard_normal((channels, n)) + 1j * rng.standard_normal((channels, n)))
        .astype(np.complex64), device=device)
    st = (nco_init((channels,), device=device),
          fir_init(len(taps_np), (channels,), device=device),
          resample_init(len(rtaps), C2_UP, (channels,), device=device))
    return BuiltConfig(config2_step(freq_to_word(C2_WORD_FREQ), device), (*st, x),
                       n * channels, dict(channels=channels, impl="torch"))


CONFIG2_ONCHIP = ("fused", "fused_mc", "two_kernels", "preframed", "preframed_bf16io")


def config2_planes(channels: int, hist: int, n: int, seed: int = 0, device=None
                   ) -> torch.Tensor:
    """Config 2's on-card input: planes [C, 2, hist+N] float32, the history
    zero (the stream starts from rest) and plane p of channel c drawn by
    ``np.random.default_rng((seed, c, p)).standard_normal(N, dtype=float32)``,
    so every variant, whatever its hist and N, sees the same samples."""
    x = torch.zeros((channels, 2, hist + n), dtype=torch.float32)
    for c in range(channels):
        for p in range(2):
            x[c, p, hist:] = torch.from_numpy(
                np.random.default_rng((seed, c, p)).standard_normal(n, dtype=np.float32))
    return x.to(resolve(device))


def build_config2_onchip(n: int = 1 << 25, variant: str = "fused_mc", channels: int = 4,
                         device=None) -> BuiltConfig:
    """Config 2 on the kernels: the counterparts of ``bench/run.py``'s
    ``run_config2_onchip`` (word freq_to_word(0.07), FIR lowpass(128, 0.2),
    resampler lowpass(48, 0.3), up 3, down 4, n samples per channel, rounded
    down to whole kernel blocks). Variants:

    - ``fused``: K8 over one channel with the combined taps
      (`combine_fir_resample_taps`, 429 taps), out_tile 384, b_rows 24;
    - ``fused_mc``: K8 over `channels` channels, channel c mixed by
      word + 7919*c;
    - ``two_kernels``: K1 at decim 1 with the 128 FIR taps (out_tile 512,
      b_rows 32), then K8 with the 48 resampler taps (out_tile 384, b_rows 8)
      over K1's output, unmixed;
    - ``preframed``: K9 f32 over frames made by K6 at build time, out_tile
      1152, b_rows 32;
    - ``preframed_bf16io``: K9 over bf16 frames, out_tile 2304.

    The JAX ``fused_combined_taps_bf16`` run only sets its matrix unit's pass
    count (precision=DEFAULT); a CUDA-core kernel has no such knob, so it has
    no variant here. The input is `config2_planes` (history zero), so every
    variant computes the same stream. step(*example) returns (yr, yi) as the
    kernel lays them out: [NT, OT], [C, NT, OT] for fused_mc, [1, N'] for
    two_kernels. For the K8 variants, meta holds the kernel and its words
    (``kernel``, ``words0``, ``words``) for chunked streaming.
    """
    from srcdsp_tpu_torch.kernels.mixfir import make_mix_fir_kernel
    from srcdsp_tpu_torch.kernels.mixfir_preframed import make_frame_kernel
    from srcdsp_tpu_torch.kernels.resample_pallas import (
        combine_fir_resample_taps, make_mix_resample_kernel, make_mix_resample_kernel_mc,
        mix_resample)
    from srcdsp_tpu_torch.kernels.resample_preframed import make_resample_preframed_kernel
    from srcdsp_tpu_torch.ops.nco import freq_to_word

    if variant not in CONFIG2_ONCHIP:
        raise ValueError(f"variant {variant!r} not in {CONFIG2_ONCHIP}")
    device = resolve(device)
    h1, h2 = _config2_taps()
    hc = combine_fir_resample_taps(h1, h2, C2_UP)
    word = int(freq_to_word(C2_WORD_FREQ))
    up, down = C2_UP, C2_DOWN
    meta = dict(impl=variant, channels=channels if variant == "fused_mc" else 1)

    def blocks(blk: int) -> int:
        m = (n // blk) * blk
        if m == 0:
            raise ValueError(f"n={n} smaller than one kernel block of {blk} samples")
        return m

    if variant == "fused_mc":
        k = make_mix_resample_kernel_mc(hc, up, down, channels, out_tile=384, b_rows=24,
                                        device=device)
        m = blocks(k.block_in())
        words = [(word + 7919 * c) % (1 << 32) for c in range(channels)]
        words0 = [(-k.hist * w) % (1 << 32) for w in words]
        x = config2_planes(channels, k.hist, m, device=device)
        meta.update(kernel=k, words0=words0, words=words)
        return BuiltConfig(lambda p: k.fn(words0, words, p), (x,), channels * m, meta)
    if variant == "fused":
        k = make_mix_resample_kernel(hc, up, down, out_tile=384, b_rows=24, device=device)
        m = blocks(k.block_in())
        word0 = (-k.hist * word) % (1 << 32)
        x = config2_planes(1, k.hist, m, device=device)[0]
        meta.update(kernel=k, words0=[word0], words=[word])
        return BuiltConfig(lambda p: k.fn(word0, word, p), (x,), m, meta)
    if variant == "two_kernels":
        k1 = make_mix_fir_kernel(h1, 1, out_tile=512, b_rows=32, device=device)
        k2 = make_mix_resample_kernel(h2, up, down, out_tile=384, b_rows=8, device=device)
        m = blocks(math.lcm(k1.block_in(), k2.block_in()))
        word0 = (-k1.hist * word) % (1 << 32)
        x = config2_planes(1, k1.hist, m, device=device)[0]
        z2 = torch.zeros((2, k2.hist), dtype=torch.float32, device=device)

        def step(p):
            yr, yi = k1.fn(word0, word, p)
            xin = torch.cat([z2, torch.stack([yr.reshape(-1), yi.reshape(-1)])], dim=-1)
            return mix_resample(k2, 0, 0, xin)

        return BuiltConfig(step, (x,), m, meta)
    bf16 = variant == "preframed_bf16io"
    dt = torch.bfloat16 if bf16 else torch.float32
    b_rows = 32
    fn, hist, stride, span = make_resample_preframed_kernel(
        hc, word, up, down, out_tile=2304 if bf16 else 1152, b_rows=b_rows, in_dtype=dt,
        device=device)
    m = blocks(b_rows * stride)
    word0 = (-hist * word) % (1 << 32)
    x = config2_planes(1, hist, m, device=device)[0]
    xr_f, xi_f = make_frame_kernel(stride, span, b_rows, in_dtype=dt, device=device)(x.to(dt))
    return BuiltConfig(lambda r, i: fn(word0, r, i), (xr_f, xi_f), m, meta)


def build_config4(nsym: int = 2048, channels: int = 32, device=None) -> BuiltConfig:
    """FSK demod chain: mix + filter + discriminator + symbol timing.

    The JAX preset draws its bits from jax.random; here they come from a
    seeded numpy generator (returned in meta["bits"]).
    """
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone

    decim, sps, dev, center = 4, 8, 0.05, 0.11
    device = resolve(device)
    params = make_fsk_params(center, 64, 0.03, decim, sps, dev, device=device)
    bits = random_bits(np.random.default_rng(0), (channels, nsym))
    bb = fsk_baseband(bits, decim * sps, dev / decim)
    x = torch.as_tensor(bb * tone(bb.shape[-1], center), device=device)
    st = fsk_init(params, (channels,))
    return BuiltConfig(lambda s, xb: fsk_apply(params, s, xb), (st, x),
                       int(x.shape[-1]) * channels,
                       dict(channels=channels, impl="torch", bits=bits))
