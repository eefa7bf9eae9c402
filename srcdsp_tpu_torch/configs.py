"""Config-1 to config-5 presets and the FFT on the port (counterpart of
``srcdsp_tpu/configs.py``, and of ``bench/run.py``'s on-chip config-2,
config-3 and config-5 runs and its FFT run).

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


@dataclasses.dataclass(frozen=True)
class ConfigSpec:
    name: str
    description: str
    build: Callable[..., "BuiltConfig"]


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


def seeded_planes(channels: int, hist: int, n: int, seed: int = 0, device=None
                  ) -> torch.Tensor:
    """Configs 2 and 3's on-card input: planes [C, 2, hist+N] float32, the
    history zero (the stream starts from rest) and plane p of channel c drawn
    by ``np.random.default_rng((seed, c, p)).standard_normal(N, dtype=float32)``,
    so every variant, whatever its hist and N, sees the same stream (the
    shorter N a prefix of the longer)."""
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
    no variant here. The input is `seeded_planes` (history zero), so every
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
        x = seeded_planes(channels, k.hist, m, device=device)
        meta.update(kernel=k, words0=words0, words=words)
        return BuiltConfig(lambda p: k.fn(words0, words, p), (x,), channels * m, meta)
    if variant == "fused":
        k = make_mix_resample_kernel(hc, up, down, out_tile=384, b_rows=24, device=device)
        m = blocks(k.block_in())
        word0 = (-k.hist * word) % (1 << 32)
        x = seeded_planes(1, k.hist, m, device=device)[0]
        meta.update(kernel=k, words0=[word0], words=[word])
        return BuiltConfig(lambda p: k.fn(word0, word, p), (x,), m, meta)
    if variant == "two_kernels":
        k1 = make_mix_fir_kernel(h1, 1, out_tile=512, b_rows=32, device=device)
        k2 = make_mix_resample_kernel(h2, up, down, out_tile=384, b_rows=8, device=device)
        m = blocks(math.lcm(k1.block_in(), k2.block_in()))
        word0 = (-k1.hist * word) % (1 << 32)
        x = seeded_planes(1, k1.hist, m, device=device)[0]
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
    x = seeded_planes(1, hist, m, device=device)[0]
    xr_f, xi_f = make_frame_kernel(stride, span, b_rows, in_dtype=dt, device=device)(x.to(dt))
    return BuiltConfig(lambda r, i: fn(word0, r, i), (xr_f, xi_f), m, meta)


C3_CUTOFF = 0.1


def build_config3(n: int = 1 << 18, channels: int = 16, fft_size: int = 4096,
                  num_taps: int = 1024, device=None) -> BuiltConfig:
    """Overlap-save FFT convolution (4096-pt), 16 channels: the ``ops.fftconv``
    tier (``torch.fft``) with the JAX preset's taps lowpass(num_taps, 0.1),
    hop fft_size - num_taps + 1, and seed-0 complex input of n samples per
    channel rounded down to whole hops.

    step(st, x [C, N]) -> (st, y [C, N]).
    """
    from srcdsp_tpu_torch.ops.fftconv import (
        default_hop, fftconv_apply, fftconv_init, make_freq_response)
    from srcdsp_tpu_torch.ops.window import lowpass

    device = resolve(device)
    taps = lowpass(num_taps, C3_CUTOFF)
    hr = make_freq_response(taps, fft_size, device=device)
    hop = default_hop(num_taps, fft_size)
    n = (n // hop) * hop
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        (rng.standard_normal((channels, n)) + 1j * rng.standard_normal((channels, n)))
        .astype(np.complex64), device=device)
    st = fftconv_init(num_taps, fft_size, (channels,), device=device)
    return BuiltConfig(lambda s, xb: fftconv_apply(hr, num_taps, s, xb), (st, x), n * channels,
                       dict(channels=channels, fft=fft_size, impl="torch"))


CONFIG3_ONCHIP = ("fused", "fused_per_channel", "planes")


def build_config3_onchip(n: int = 1 << 23, variant: str = "fused", channels: int = 16,
                         b_frames: int = 16, device=None) -> BuiltConfig:
    """Config 3 on the card: the counterpart of ``bench/run.py``'s
    ``run_config3_onchip`` (taps lowpass(1024, 0.1), fft 4096, n samples per
    channel rounded down to whole blocks). Variants:

    - ``fused``: K11 with shared taps (karatsuba=True, n2 128, b_frames 16:
      hop 3072, blocks of 49,152), the serving path;
    - ``fused_per_channel``: K11 with the same taps given per channel,
      [C, T] (the same function through the per-channel response);
    - ``planes``: ``ops.fftconv_planes`` per channel (hop 2048), the
      reference's ``fused=False``.

    The input is `seeded_planes` (history zero). step(*example) returns
    (yr, yi) [C, N]. For the K11 variants meta holds the kernel (``kernel``)
    for streaming with `FftConvStream`; meta ``hop`` is the variant's hop.
    """
    from srcdsp_tpu_torch.kernels.fftconv_pallas import fftconv_pallas, make_fftconv_kernel
    from srcdsp_tpu_torch.ops.fftconv_planes import make_fftconv_planes
    from srcdsp_tpu_torch.ops.window import lowpass

    if variant not in CONFIG3_ONCHIP:
        raise ValueError(f"variant {variant!r} not in {CONFIG3_ONCHIP}")
    device = resolve(device)
    fft_size, num_taps = 4096, 1024
    taps = lowpass(num_taps, C3_CUTOFF)
    meta = dict(impl=variant, channels=channels, fft=fft_size, taps=num_taps)
    if variant == "planes":
        fn, hop = make_fftconv_planes(taps, fft_size, device=device)
        blk, hist = hop, fft_size - hop
    else:
        ktaps = np.tile(taps, (channels, 1)) if variant == "fused_per_channel" else taps
        k = make_fftconv_kernel(ktaps, fft_size, num_channels=channels, b_frames=b_frames,
                                karatsuba=True, device=device)
        blk, hist, hop = k.block_in(), k.overlap, k.hop
        meta.update(kernel=k)
    m = (n // blk) * blk
    if m == 0:
        raise ValueError(f"n={n} smaller than one block of {blk} samples")
    meta.update(hop=hop)
    x = seeded_planes(channels, hist, m, device=device)
    if variant == "planes":
        def step(xp):
            outs = [fn(xp[c, 0], xp[c, 1]) for c in range(channels)]
            return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
        return BuiltConfig(step, (x,), channels * m, meta)
    return BuiltConfig(lambda xp: fftconv_pallas(k, xp), (x,), channels * m, meta)


FFT_VARIANTS = ("kernel", "kernel_digit", "kernel_nat", "planes")


def build_fft(batch: int = 8192, n: int = 4096, variant: str = "kernel", device=None
              ) -> BuiltConfig:
    """The batched FFT: the counterpart of ``bench/run.py``'s ``run_fft``
    (seed-0 standard_normal planes [batch, n], batch rounded down to whole
    b_frames of 16). Variants: ``kernel`` (K10, natural_order=True: on the
    card the kernel stores natural order, no transpose), ``kernel_digit``
    (natural_order=False), ``kernel_nat`` (natural_order="kernel", the same
    natural store counted apart) and ``planes`` (``ops.fft_planes``).

    step(xr, xi) -> (yr, yi): [B, N], or [B*n1, n2] in digit order for
    kernel_digit. meta ``flops_5nlogn`` is 5 N log2 N per frame times B.
    """
    from srcdsp_tpu_torch.kernels.fft_pallas import make_fft_kernel
    from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes

    if variant not in FFT_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {FFT_VARIANTS}")
    device = resolve(device)
    meta = dict(impl=variant, fft=n)
    if variant == "planes":
        step = make_fft_planes(n, device=device)
    else:
        order = {"kernel": True, "kernel_digit": False, "kernel_nat": "kernel"}[variant]
        k = make_fft_kernel(n, b_frames=16, natural_order=order, device=device)
        batch = (batch // k.b_frames) * k.b_frames
        step = k.fn
        meta.update(kernel=k)
    rng = np.random.default_rng(0)
    xr = torch.as_tensor(rng.standard_normal((batch, n)).astype(np.float32), device=device)
    xi = torch.as_tensor(rng.standard_normal((batch, n)).astype(np.float32), device=device)
    meta.update(batch=batch, flops_5nlogn=5 * n * math.log2(n) * batch)
    return BuiltConfig(step, (xr, xi), batch * n, meta)


C5_SPS, C5_ORDER, C5_TAPS_PER_PHASE = 4, 4, 8


def build_config5(frames: int = 512, num_channels: int = 64, device=None,
                  mesh=None) -> BuiltConfig:
    """64-channel polyphase channelizer + per-channel QPSK demod, the complex
    tier: ``chains.channelizer.channelize_full`` then ``chains.psk.psk_apply``
    (decim 1, sps 4, RRC span 4) over the seed-0 complex input of
    frames * num_channels samples, as the JAX preset's single-device form.

    step(x [N]) -> (idx int32 [M, frames/4], soft complex64 [M, frames/4]).

    With `mesh` (``dist.make_mesh``), the distributed form: the input is
    time-sharded over the mesh's time axis (the example is the shards this
    process holds), the channelizer re-shards it to channels
    (``dist.channelize_time_sharded``), and the demod runs on each channel
    shard with no collective (``dist.mesh.map_shards``); step(shards)
    gathers the outputs onto `device`, which defaults to this process's
    first shard device. Across processes (`dist.init_multihost`) every rank
    makes the same seed-0 input, holds its shards, and gathers the outputs
    of every rank, as the reference's ``process_allgather``.
    """
    from srcdsp_tpu_torch.chains.channelizer import channelize_full, design_prototype
    from srcdsp_tpu_torch.chains.psk import make_psk_params, psk_apply, psk_init

    if mesh is not None and device is None:
        device = mesh.local_devices()[0]
    device = resolve(device)
    proto = design_prototype(num_channels, taps_per_phase=C5_TAPS_PER_PHASE)
    n = frames * num_channels
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64),
        device=device)

    def psk_for(dev):
        return make_psk_params(0.0, decim=1, sps=C5_SPS, order=C5_ORDER, rrc_span=4, device=dev)

    def demod(psk, bank):
        return psk_apply(psk, psk_init(psk, (bank.shape[0],)), bank)[1]

    if mesh is None:
        psk = psk_for(device)

        def step(xw):
            return demod(psk, channelize_full(proto, xw, num_channels))

        example = (x,)
    else:
        from srcdsp_tpu_torch.dist import channelize_time_sharded, shard
        from srcdsp_tpu_torch.dist.mesh import (
            TIME_AXIS, map_shards, per_device, process_allgather, sharding)

        psks = per_device(psk_for, mesh.local_devices())
        rows = sharding(mesh, TIME_AXIS, 0)

        def step(shards):
            bank = channelize_time_sharded(proto, shards, num_channels, mesh)
            outs = map_shards(demod, mesh, psks, bank)
            return (process_allgather([o[0] for o in outs], rows).to(device),
                    process_allgather([o[1] for o in outs], rows).to(device))

        example = (shard(x, mesh),)
    return BuiltConfig(step, example, n, dict(channels=num_channels, impl="torch",
                                              distributed=mesh is not None))


CONFIG5_ONCHIP = ("fused", "fused_std", "bank", "planes")


def build_config5_onchip(frames: int = 1 << 19, variant: str = "fused", num_channels: int = 64,
                         b_k: int = 512, device=None) -> BuiltConfig:
    """Config 5 on the card: the counterpart of ``bench/run.py``'s
    ``run_config5_onchip`` (prototype design_prototype(M, 8), QPSK, sps 4,
    offset 0.5; frames rounded down to whole b_k blocks for the kernels).
    Variants:

    - ``fused``: K13 with class_major=True, then ``psk_demod_bank_stats``
      with class_major_b_k=b_k (the serving path);
    - ``fused_std``: K13 in the standard layout, then the tail with
      interp=False;
    - ``bank``: K12, then ``psk_demod_planes``;
    - ``planes``: ``ops.channelize_planes.make_channelize_planes``, then
      ``psk_demod_planes``.

    The input is the bench's: seed-0 standard-normal phase-major planes
    [2, M, hist_cols + K] for the kernel variants, two seed-0 standard-normal
    planes [K*M] for ``planes``. The JAX run's bf16 bank (precision=DEFAULT)
    has no CUDA-core counterpart; every variant computes in float32.
    step(*example) returns (acc, (idx int32 [M, K/4], (soft_r, soft_i))); the
    kernel variants take any K that is a multiple of b_k. meta holds the
    kernel (``kernel``) and ``hist_cols`` for the kernel variants.
    """
    from srcdsp_tpu_torch.chains.channelizer import design_prototype
    from srcdsp_tpu_torch.chains.fsk_planes import make_timing_tone
    from srcdsp_tpu_torch.chains.psk import constellation_offset
    from srcdsp_tpu_torch.chains.psk_planes import psk_demod_bank_stats, psk_demod_planes
    from srcdsp_tpu_torch.kernels.bank_pallas import make_bank_kernel, make_bank_psk_kernel
    from srcdsp_tpu_torch.ops.channelize_planes import make_channelize_planes

    if variant not in CONFIG5_ONCHIP:
        raise ValueError(f"variant {variant!r} not in {CONFIG5_ONCHIP}")
    device = resolve(device)
    m, sps, order = num_channels, C5_SPS, C5_ORDER
    off = constellation_offset(order)
    proto = design_prototype(m, taps_per_phase=C5_TAPS_PER_PHASE)
    k = (frames // sps) * sps
    meta = dict(impl=variant, channels=m, b_k=b_k)
    tones = {}

    def demod_planes(yr, yi):
        kk = yr.shape[-1]
        if kk not in tones:
            tones[kk] = tuple(torch.as_tensor(t, device=device) for t in make_timing_tone(kk, sps))
        return psk_demod_planes(yr, yi, sps, order, *tones[kk], offset=off)

    rng = np.random.default_rng(0)
    if variant == "planes":
        bank = make_channelize_planes(proto, m, device=device)
        n = k * m
        xr = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
        xi = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)

        def step_planes(xr, xi):
            br, bi = bank(xr, xi)                        # [K, M]
            return demod_planes(br.T, bi.T)

        return BuiltConfig(step_planes, (xr, xi), n, meta)
    if variant == "bank":
        kb, hist_cols = make_bank_kernel(proto, m, b_k=b_k, device=device)

        def step(xp):
            y = kb(xp)                                   # [2M, K] channel-major
            return demod_planes(y[:m], y[m:])
    else:
        cm = variant == "fused"
        kb, hist_cols = make_bank_psk_kernel(proto, m, sps=sps, order=order, b_k=b_k,
                                             class_major=cm, device=device)

        def step(xp):
            y, stats = kb(xp)
            return psk_demod_bank_stats(y[:m], y[m:], stats, sps, order, offset=off,
                                        interp=cm, class_major_b_k=b_k if cm else 0)
    k = (k // b_k) * b_k
    if k == 0:
        raise ValueError(f"frames={frames} smaller than one block of b_k={b_k}")
    xp = torch.as_tensor(rng.standard_normal((2, m, hist_cols + k)).astype(np.float32),
                         device=device)
    meta.update(kernel=kb, hist_cols=hist_cols)
    return BuiltConfig(step, (xp,), k * m, meta)


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


# ---------------------------------------------------------------------------
# The coded tier: counterparts of bench/modem_onchip.py, coded_link_onchip.py,
# ldpc_onchip.py and turbo_onchip.py at their default sizes
# ---------------------------------------------------------------------------

def _awgn(rng: np.random.Generator, shape: tuple, sigma: float) -> np.ndarray:
    """Complex white noise of `sigma` per real part, complex64."""
    return (sigma * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _planes(x: torch.Tensor, hist: int) -> torch.Tensor:
    """Complex [C, N] -> float32 planes [C, 2, hist + N], the history zero."""
    out = torch.zeros((x.shape[0], 2, hist + x.shape[-1]), dtype=torch.float32, device=x.device)
    out[:, 0, hist:] = x.real
    out[:, 1, hist:] = x.imag
    return out


def build_coded_modem(channels: int = 8, words: int = 512, iters: int = 6, snr_db: float = 13.0,
                      order: int = 16, z: int = 128, out_tile: int = 512, b_rows: int = 32,
                      b_tile: int = 128, device=None) -> BuiltConfig:
    """The coherent coded modem, ``bench/modem_onchip.py``'s run: QC code
    ``make_dual_diagonal_base(4, 12, z, seed=0)`` (n 1536, k 1024 at z 128),
    `words` codewords per channel (seed-0 info bits), the bit-plane map to
    QAM`order`, ``chains.tx`` at sps 2 through ``root_raised_cosine(2, 16,
    0.35)`` (33 taps) on the device, channel c at 0.05 + 0.03*c, AWGN at
    `snr_db`; the receive gain and lag come from the tx impulse response
    convolved with the taps, as in the bench.

    step(planes [C, 2, hist+N]) -> (bits_t [n, C*words] int32, ok [C*words]);
    meta ``cw`` [C*words, n] int32 is the transmitted codewords (the gold),
    ``u`` the info bits, ``n``, ``k``; ``taps`` (gain-scaled), ``dwords``,
    ``sps``, ``out_tile`` and ``b_rows`` are the front end's K1 mc arguments.
    """
    from srcdsp_tpu_torch.chains.modem import make_coherent_modem, map_codewords_to_symbols
    from srcdsp_tpu_torch.chains.tx import linear_tx_apply, linear_tx_init, make_linear_tx, qam_map
    from srcdsp_tpu_torch.kernels.ldpc_pallas import plan_qc
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.window import root_raised_cosine
    from srcdsp_tpu_torch.qcldpc import make_dual_diagonal_base, make_qc_ldpc, qc_encode_dual_diagonal

    device = resolve(device)
    c, nw, sps, mb, nb = channels, words, 2, 4, 12
    base = make_dual_diagonal_base(mb, nb, z, seed=0)
    code = make_qc_ldpc(base, z, device=device)
    plan = plan_qc(base, z)
    n, k = nb * z, (nb - mb) * z
    spc = n // (int(order).bit_length() - 1)
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.integers(0, 2, (c * nw, k)), device=device)
    cw = qc_encode_dual_diagonal(base, z, u)
    taps = root_raised_cosine(sps, 16, beta=0.35)
    centers = np.asarray([0.05 + 0.03 * ch for ch in range(c)])
    blk = b_rows * out_tile
    nsym_pad = -(-(nw * spc + len(taps)) // blk) * blk
    sym = qam_map(map_codewords_to_symbols(cw, order).reshape(c, nw * spc), order)
    sym = torch.cat([sym, torch.zeros((c, nsym_pad - nw * spc), dtype=sym.dtype, device=device)],
                    dim=-1)
    params = make_linear_tx(centers, taps, sps, device=device)
    _, x = linear_tx_apply(params, linear_tx_init(params, (c,)), sym)
    imp = torch.zeros(64, dtype=torch.complex64, device=device)
    imp[0] = 1.0
    p0 = make_linear_tx(0.0, taps, sps, device=device)
    _, pulse = linear_tx_apply(p0, linear_tx_init(p0), imp)
    cas = np.convolve(pulse.real.cpu().numpy(), taps)
    g, lag_samp = float(cas.max()), int(cas.argmax())
    if lag_samp % sps:
        raise ValueError("cascade delay must be whole symbols")
    sigma = 10.0 ** (-snr_db / 20.0) / np.sqrt(2.0)
    x = x + torch.as_tensor(_awgn(rng, tuple(x.shape), sigma), device=device)
    dwords = np.asarray([freq_to_word(-f) for f in centers], np.uint32)
    rx_taps = (taps / g).astype(np.float32)
    pipeline, hist = make_coherent_modem(rx_taps, dwords, sps, order, code, plan, nw=nw,
                                         lag=lag_samp // sps, iters=iters, out_tile=out_tile,
                                         b_rows=b_rows, b_tile=b_tile, device=device)
    n_in = nsym_pad * sps
    return BuiltConfig(pipeline, (_planes(x, hist),), c * n_in,
                       dict(impl="modem", channels=c, words=nw, n=n, k=k, order=order,
                            iters=iters, cw=cw, u=u, code=code, plan=plan, taps=rx_taps,
                            dwords=dwords, sps=sps, out_tile=out_tile, b_rows=b_rows))


def build_coded_link(channels: int = 4, words: int = 256, iters: int = 10, snr_db: float = 14.0,
                     out_tile: int = 512, b_rows: int = 32, device=None) -> BuiltConfig:
    """The coded FSK link, ``bench/coded_link_onchip.py``'s run: the (3,6)
    regular n = 504 code (seed 0), `words` codewords per channel of seed-0
    info bits, CPFSK at sps 8 x decim 4 (dev 0.05/4 at the input rate), channel
    c at 0.05 + 0.01*c, AWGN at `snr_db`; K2 class-major (``lowpass(64,
    0.03)``), the demod lag resolved once on the hard bits (0..2), LLRs =
    -soft into K14 (`make_ldpc_decoder`, B = C*words).

    step(planes [C, 2, hist+N]) -> (bits [B, 504], info [B, k], ok [B]);
    meta ``u`` [C, words, k] is the gold info bits, ``cw`` the codewords,
    ``lag``, ``raw_ber`` (hard-bit BER before decoding).
    """
    from srcdsp_tpu_torch.kernels.fsk_fused import fsk_demod_fused, make_fsk_mc_kernel
    from srcdsp_tpu_torch.kernels.ldpc_pallas import make_ldpc_decoder, plan_edges
    from srcdsp_tpu_torch.ldpc import ldpc_encode, make_ldpc_code, make_regular_ldpc
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.window import lowpass
    from srcdsp_tpu_torch.testing.signals import fsk_baseband, tone

    device = resolve(device)
    cch, decim, sps, ncode, nw = channels, 4, 8, 504, words
    h = make_regular_ldpc(ncode, 3, 6, seed=0)
    code = make_ldpc_code(h, device=device)
    plan = plan_edges(h)
    blk_sym = b_rows * out_tile // sps
    nsym = -(-(nw * ncode + 8) // blk_sym) * blk_sym
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.integers(0, 2, (cch, nw, code.k)), device=device)
    taps = lowpass(64, 0.03)
    centers = [0.05 + 0.01 * ch for ch in range(cch)]
    words_ = np.asarray([freq_to_word(-f) for f in centers], np.uint32)
    cw = ldpc_encode(code, u.reshape(-1, code.k))
    bits_tx = cw.reshape(cch, nw * ncode).cpu().numpy()
    bits_pad = np.concatenate([bits_tx, np.zeros((cch, nsym - nw * ncode), np.int32)], axis=-1)
    n = nsym * decim * sps
    bb = fsk_baseband(bits_pad, decim * sps, 0.05 / decim)
    x = np.stack([bb[ch] * tone(n, centers[ch]) for ch in range(cch)])
    x = x + _awgn(rng, x.shape, float(10.0 ** (-snr_db / 20.0)) / np.sqrt(2.0))
    fn, hist = make_fsk_mc_kernel(taps, decim, cch, sps, out_tile=out_tile, b_rows=b_rows,
                                  class_major=True, device=device)
    planes = _planes(torch.as_tensor(x, device=device), hist)
    words0 = [(-hist * int(w)) % (1 << 32) for w in words_]
    dec = make_ldpc_decoder(code, plan, iters=iters, device=device)

    def demod(p):
        return fsk_demod_fused(fn, hist, out_tile, words0, words_, p, sps, class_major=True)[1]

    br = demod(planes)[0].cpu().numpy()
    lag, raw_ber = 0, 1.0
    for cand in range(0, 3):
        nn = nw * ncode - cand
        ber = float((br[:, cand:cand + nn] != bits_tx[:, :nn]).mean())
        if ber < raw_ber:
            lag, raw_ber = cand, ber

    def step(p):
        soft = demod(p)[1][:, lag:lag + nw * ncode]
        return dec(-soft.reshape(cch * nw, ncode))

    return BuiltConfig(step, (planes,), cch * n,
                       dict(impl="coded_link", channels=cch, words=nw, n=ncode, k=code.k,
                            iters=iters, u=u, cw=cw, lag=lag, raw_ber=raw_ber, code=code,
                            plan=plan))


LDPC_VARIANTS = ("qc", "edges")


def build_ldpc(variant: str = "qc", batch: int = 4096, iters: int | None = None,
               device=None) -> BuiltConfig:
    """A decoder alone, ``bench/ldpc_onchip.py``'s runs at `batch` codewords
    of seed-0 info bits over BPSK + AWGN, LLR = 2y/sigma^2:

    - ``qc`` (``--qc``): the 4x12 dual-diagonal code at z = 128 (n 1536,
      k 1024, seed 0), O(N) encode, sigma 0.5, K15 (`make_qc_decoder`),
      6 iterations by default;
    - ``edges`` (``--kernel``): the (3,6) regular n = 504 code (seed 0),
      sigma 0.55, K14 (`make_ldpc_decoder`), 10 iterations by default.

    step(llr [B, N]) -> (bits, info, ok); meta ``cw`` / ``u`` are the gold,
    ``code`` and ``plan`` the code (``z`` for qc).
    """
    from srcdsp_tpu_torch.kernels.ldpc_pallas import (
        make_ldpc_decoder, make_qc_decoder, plan_edges, plan_qc)
    from srcdsp_tpu_torch.ldpc import ldpc_encode, make_ldpc_code, make_regular_ldpc
    from srcdsp_tpu_torch.qcldpc import make_dual_diagonal_base, make_qc_ldpc, qc_encode_dual_diagonal

    if variant not in LDPC_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {LDPC_VARIANTS}")
    device = resolve(device)
    rng = np.random.default_rng(0)
    meta = dict(impl=variant, batch=batch)
    if variant == "qc":
        z = 128
        base = make_dual_diagonal_base(4, 12, z, seed=0)
        code, plan = make_qc_ldpc(base, z, device=device), plan_qc(base, z)
        u = torch.as_tensor(rng.integers(0, 2, (batch, code.k)), device=device)
        cw = qc_encode_dual_diagonal(base, z, u)
        sigma, iters = 0.5, 6 if iters is None else iters
        dec = make_qc_decoder(code, plan, iters=iters, device=device)
        meta.update(z=z)
    else:
        h = make_regular_ldpc(504, 3, 6, seed=0)
        code, plan = make_ldpc_code(h, device=device), plan_edges(h)
        u = torch.as_tensor(rng.integers(0, 2, (batch, code.k)), device=device)
        cw = ldpc_encode(code, u)
        sigma, iters = 0.55, 10 if iters is None else iters
        dec = make_ldpc_decoder(code, plan, iters=iters, device=device)
    y = (1.0 - 2.0 * cw.cpu().numpy()) + sigma * rng.standard_normal(tuple(cw.shape))
    llr = torch.as_tensor((2.0 / sigma ** 2 * y).astype(np.float32), device=device)
    meta.update(cw=cw, u=u, code=code, plan=plan, iters=iters, n=code.n, k=code.k)
    return BuiltConfig(dec, (llr,), batch * code.n, meta)


TURBO_LAYOUTS = ("kernel", "batch")


def build_turbo(t: int = 512, iters: int = 4, batch: int = 256, snr_db: float = 1.5,
                layout: str = "kernel", device=None) -> BuiltConfig:
    """Turbo decoding, ``bench/turbo_onchip.py``'s run: `make_turbo(t,
    seed=0)` (LTE constituent code), `batch` blocks of seed-0 info bits,
    BPSK + AWGN at `snr_db` (sigma = 10^(-snr/20)), LLR = 2y/sigma^2 for the
    systematic, parity-1 and parity-2 streams in that order. Layouts:
    ``kernel`` = `turbo_decode_pallas` (K16, ``--layout pallas``), ``batch``
    = the plain `turbo_decode_batch`.

    step(llr_sys, llr_par1, llr_par2) -> (bits [B, t] int32, posterior);
    meta ``u`` [B, t] is the gold, ``n_coded`` the coded bits per block.
    """
    from srcdsp_tpu_torch.kernels.bcjr_pallas import turbo_decode_pallas
    from srcdsp_tpu_torch.turbo import make_turbo, turbo_decode_batch, turbo_encode

    if layout not in TURBO_LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {TURBO_LAYOUTS}")
    device = resolve(device)
    tc = make_turbo(t, seed=0)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, (batch, t))
    streams = turbo_encode(tc, u)
    sigma = float(10.0 ** (-snr_db / 20.0))
    llrs = tuple(torch.as_tensor((2.0 / sigma ** 2 * ((1.0 - 2.0 * s.numpy())
                                                       + sigma * rng.standard_normal(s.shape))
                                  ).astype(np.float32), device=device) for s in streams)
    if layout == "kernel":
        def step(a, b, c):
            return turbo_decode_pallas(tc, a, b, c, iters=iters, b_tile=min(128, batch))
    else:
        def step(a, b, c):
            return turbo_decode_batch(tc, a, b, c, iters=iters)
    return BuiltConfig(step, llrs, batch * t,
                       dict(impl=layout, tc=tc, u=torch.as_tensor(u, device=device),
                            iters=iters, n_coded=sum(s.shape[-1] for s in streams)))


# the reference's registry (srcdsp_tpu/configs.py CONFIGS): the same names and
# descriptions; each build function takes the port's arguments (use_kernel, device)
CONFIGS = {
    "config1": ConfigSpec(
        "config1",
        "single-channel 64-tap FIR + 2x decimate (+fused NCO), 1M samples",
        build_config1),
    "config2": ConfigSpec(
        "config2", "NCO + 128-tap FIR + 3/4 resample, 4 channels",
        build_config2),
    "config3": ConfigSpec(
        "config3", "overlap-save FFT conv 4096-pt, 16 channels",
        build_config3),
    "config4": ConfigSpec(
        "config4", "FSK demod chain, 32 channels", build_config4),
    "config5": ConfigSpec(
        "config5", "64-ch polyphase channelizer + PSK demods", build_config5),
}
