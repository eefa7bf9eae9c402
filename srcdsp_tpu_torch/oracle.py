"""ctypes binding of the C++ golden oracle ``cpp/oracle/oracle.cc``: the
port's own copy of the functions of ``srcdsp_tpu/oracle.py`` that the ported
slices are held to, with the same arguments and results: the int16
conversions (`i16_to_f32`, `f32_to_i16`); `nco_phasor`, `nco_mix`; `fir` with
real taps and `fir_stream`; `resample`, `resample_stream`, `fft`; the
channelizer and synthesis banks (`channelize`, `channelize_stream`,
`channelize_os2`, `synthesize`, `synthesize_os2`); the streaming IIR
(`iir_stream`); the discriminator and the
symbol timing (`discriminate`, `timing_estimate`, `timing_sample`); the FSK
and PSK chains composed from them (`fsk_demod`, `psk_demod`); and the CPM
transmitter (`cpm_tx`).

The library is built at first use by the repository's own Makefile into
``build/srcdsp_tpu_torch/oracle/<hash of oracle.cc and the Makefile>/``
(``_native.MakeLibrary``: a temporary directory and an atomic rename, so that
concurrent test workers can build it at once); it never writes
``cpp/oracle/build/``. A failed build raises.

Complex buffers are numpy complex64, passed as interleaved float32 views.
"""

from __future__ import annotations

import ctypes

import numpy as np

from srcdsp_tpu_torch._native import MakeLibrary

_P, _L, _I, _U, _F = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_SIGNATURES = {
    "orc_i16_to_f32": [_P, _P, _L, _F],
    "orc_f32_to_i16": [_P, _P, _L, _F],
    "orc_nco_phasor": [_U, _U, _L, _P],
    "orc_discriminate": [_P, _L, _P],
    "orc_fir_stream": [_P, _L, _P, _L, _I, _P, _P],
    "orc_cpm_tx": [_P, _L, _P, _I, _I, ctypes.c_int32, _P, _P, _P],
    "orc_fir": [_P, _L, _P, _L, _I, _P],
    "orc_nco_mix": [_P, _L, _U, _U, _P, _P],
    "orc_resample": [_P, _L, _P, _L, _I, _I, _P],
    "orc_resample_stream": [_P, _L, _P, _L, _I, _I, _P, _P, _P],
    "orc_fft": [_P, _P, _L, _I],
    "orc_channelize": [_P, _L, _P, _L, _I, _P],
    "orc_channelize_stream": [_P, _L, _P, _L, _I, _P, _P],
    "orc_channelize_os2": [_P, _L, _P, _L, _I, _P],
    "orc_synthesize": [_P, _I, _L, _P, _L, _P],
    "orc_synthesize_os2": [_P, _I, _L, _P, _L, _P],
    "orc_timing_estimate": [_P, _L, _I, _F, _P, _P],
    "orc_timing_sample_c": [_P, _P, _L, _I, _F, _P],
    "orc_iir_stream": [_P, _L, _P, _P, _L, _P, _P],
}


_LIB = MakeLibrary("oracle", "oracle.cc", "oracle", _SIGNATURES, None)
BUILD_ROOT = _LIB.build_root
library_path, build, load = _LIB.path, _LIB.build, _LIB.load


def _cf(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.complex64)


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32)


def i16_to_f32(x: np.ndarray, scale: float = 32767.0) -> np.ndarray:
    """int16 -> float32 by division by `scale` (the same shape)."""
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.shape, np.float32)
    load().orc_i16_to_f32(x.ctypes.data, out.ctypes.data, x.size, scale)
    return out


def f32_to_i16(x: np.ndarray, scale: float = 32767.0) -> np.ndarray:
    """float32 -> int16: x*scale rounded half to even, saturated."""
    x = _f32(x)
    out = np.empty(x.shape, np.int16)
    load().orc_f32_to_i16(x.ctypes.data, out.ctypes.data, x.size, scale)
    return out


def nco_phasor(word0: int, dword: int, n: int) -> np.ndarray:
    """n samples of e^{j 2 pi (word0 + k*dword) / 2^32}, computed in double."""
    out = np.empty(n, np.complex64)
    load().orc_nco_phasor(word0 % (1 << 32), dword % (1 << 32), n, out.ctypes.data)
    return out


def discriminate(x: np.ndarray) -> np.ndarray:
    """d[i] = angle(x[i] conj(x[i-1])) / 2pi with x[-1] = 0: [N] -> [N] float32."""
    x = _cf(x)
    out = np.empty(x.size, np.float32)
    load().orc_discriminate(x.ctypes.data, x.size, out.ctypes.data)
    return out


def fir_stream(x: np.ndarray, taps: np.ndarray, hist: np.ndarray, decim: int = 1
               ) -> tuple[np.ndarray, np.ndarray]:
    """Streaming FIR with a carried delay line. hist: [T-1] complex64 (zeros
    at stream start). Returns (y [N/decim], new_hist); outputs concatenated
    over blocks equal one `fir` call."""
    x = _cf(x)
    taps = _f32(taps)
    hist = _cf(hist).copy()
    if hist.size != taps.size - 1:
        raise ValueError(f"hist holds {hist.size} samples, expected {taps.size - 1}")
    out = np.empty(x.size // decim, np.complex64)
    load().orc_fir_stream(x.ctypes.data, x.size, taps.ctypes.data, taps.size, decim,
                          hist.ctypes.data, out.ctypes.data)
    return out, hist


def iir_stream(x: np.ndarray, b: np.ndarray, a: np.ndarray, z: np.ndarray | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Streaming IIR b(z)/a(z), direct form II transposed with double
    accumulation. z: the carried delay line [p] complex64 (zeros at stream
    start, p = max(len(a), len(b)) - 1). Returns (y [N], new_z); outputs
    concatenated over blocks equal one whole-signal run."""
    x = _cf(x)
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b, a = b / a[0], a / a[0]
    p = max(a.size, b.size) - 1
    b = np.ascontiguousarray(np.concatenate([b, np.zeros(p + 1 - b.size)]))
    a = np.ascontiguousarray(np.concatenate([a, np.zeros(p + 1 - a.size)]))
    z = np.zeros(p, np.complex64) if z is None else _cf(z).copy()
    if z.size != p:
        raise ValueError(f"z holds {z.size} samples, expected {p}")
    out = np.empty(x.size, np.complex64)
    load().orc_iir_stream(x.ctypes.data, x.size, b.ctypes.data, a.ctypes.data, p,
                          z.ctypes.data, out.ctypes.data)
    return out, z


def fsk_demod(x: np.ndarray, center_freq: float, taps: np.ndarray, decim: int, sps: int
              ) -> np.ndarray:
    """The FSK chain from oracle primitives: mix -> FIR (+decim) ->
    discriminator -> O&M timing on d^2 -> sample -> slice. Returns bits int32."""
    word = int(np.round(((-center_freq) % 1.0) * 4294967296.0) % 4294967296.0)
    mixed, _ = nco_mix(x, 0, word)
    d = discriminate(fir(mixed, taps, decim=decim))
    _, tau = timing_estimate(d * d, sps)
    soft = timing_sample(np.zeros(sps + 1, np.complex64), d.astype(np.complex64), tau, sps)
    return (soft.real > 0).astype(np.int32)


def cpm_tx(bits: np.ndarray, words: np.ndarray, sps: int, phase0: int = 0
           ) -> tuple[np.ndarray, np.ndarray]:
    """CPM transmitter over the same int32 phase-increment words [nspan, sps]
    as ``chains.tx``: returns (baseband complex64 [nsym*sps], phase words int32
    [nsym*sps], the phase before each sample)."""
    bits = np.ascontiguousarray(bits, np.uint8)
    words = np.ascontiguousarray(words, np.int32)
    nspan = words.shape[0]
    if words.shape[1] != sps:
        raise ValueError(f"words {words.shape} do not have sps={sps} columns")
    n = bits.size * sps
    ph = np.empty(n, np.int32)
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    load().orc_cpm_tx(bits.ctypes.data, bits.size, words.ctypes.data, nspan, sps, phase0,
                      ph.ctypes.data, re.ctypes.data, im.ctypes.data)
    return (re + 1j * im).astype(np.complex64), ph


def fir(x: np.ndarray, taps: np.ndarray, decim: int = 1) -> np.ndarray:
    """Causal FIR from rest with real taps, keeping every decim-th output:
    [N] -> [N/decim]."""
    x = _cf(x)
    taps = np.ascontiguousarray(taps, np.float32)
    out = np.empty(x.size // decim, np.complex64)
    load().orc_fir(x.ctypes.data, x.size, taps.ctypes.data, taps.size, decim, out.ctypes.data)
    return out


def nco_mix(x: np.ndarray, word0: int, dword: int) -> tuple[np.ndarray, int]:
    """x * e^{j 2 pi (word0 + k*dword) / 2^32}; returns (mixed, the next word)."""
    x = _cf(x)
    out = np.empty(x.size, np.complex64)
    end = ctypes.c_uint32(0)
    load().orc_nco_mix(x.ctypes.data, x.size, word0 % (1 << 32), dword % (1 << 32),
                       out.ctypes.data, ctypes.addressof(end))
    return out, int(end.value)


def resample(x: np.ndarray, taps: np.ndarray, up: int, down: int) -> np.ndarray:
    """Rational L/M resample from rest: y[j] = sum_k h[k] u[j*down - k]."""
    x = _cf(x)
    taps = np.ascontiguousarray(taps, np.float32)
    out = np.empty((x.size * up) // down, np.complex64)
    load().orc_resample(x.ctypes.data, x.size, taps.ctypes.data, taps.size, up, down,
                        out.ctypes.data)
    return out


def resample_stream(x: np.ndarray, taps: np.ndarray, up: int, down: int, hist: np.ndarray,
                    offset: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Streaming rational resampler with a carried input tail and output phase.

    hist: [ceil((T-1)/up)] complex64 (zeros at start); offset: input samples
    consumed so far (0 at start). Returns (y, new_hist, new_offset); outputs
    concatenated over blocks equal one `resample` call.
    """
    x = _cf(x)
    taps = np.ascontiguousarray(taps, np.float32)
    h = (taps.size - 1 + up - 1) // up
    hist = _cf(hist).copy()
    if hist.size != h:
        raise ValueError(f"hist holds {hist.size} samples, expected {h}")
    j0 = (offset * up) // down
    jend = ((offset + x.size) * up) // down
    out = np.empty(jend - j0, np.complex64)
    off = ctypes.c_long(offset)
    load().orc_resample_stream(x.ctypes.data, x.size, taps.ctypes.data, taps.size, up, down,
                               hist.ctypes.data, ctypes.addressof(off), out.ctypes.data)
    return out, hist, int(off.value)


def fft(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Radix-2 DFT in double precision of a power-of-two length, rounded to
    complex64; the inverse carries the 1/N."""
    x = _cf(x)
    n = x.size
    if n & (n - 1):
        raise ValueError(f"oracle fft needs power-of-two length, got {n}")
    out = np.empty(n, np.complex64)
    load().orc_fft(x.ctypes.data, out.ctypes.data, n, 1 if inverse else 0)
    return out


def timing_estimate(metric: np.ndarray, sps: int, acc: complex = 0.0,
                    forget: float = 0.5) -> tuple[complex, float]:
    """O&M timing from a real metric [N]: returns (new accumulator, tau in [0, sps))."""
    metric = _f32(metric)
    acc_io = np.asarray([acc.real, acc.imag], np.float32)
    tau = ctypes.c_float(0.0)
    load().orc_timing_estimate(metric.ctypes.data, metric.size, sps, forget,
                               acc_io.ctypes.data, ctypes.addressof(tau))
    return complex(acc_io[0], acc_io[1]), float(tau.value)


def timing_sample(last: np.ndarray, x: np.ndarray, tau: float, sps: int) -> np.ndarray:
    """One complex value per symbol at offset tau by linear interpolation over
    [last | x] (last: sps + 1 samples): [N] -> [N/sps]."""
    last, x = _cf(last), _cf(x)
    if last.size != sps + 1:
        raise ValueError(f"last holds {last.size} samples, expected {sps + 1}")
    out = np.empty(x.size // sps, np.complex64)
    load().orc_timing_sample_c(last.ctypes.data, x.ctypes.data, x.size, sps, tau,
                               out.ctypes.data)
    return out


def channelize(x: np.ndarray, proto: np.ndarray, m: int) -> np.ndarray:
    """Analysis bank from rest: [N] -> [m, N/m], channel m at +m/M."""
    x, proto = _cf(x), _f32(proto)
    out = np.empty((m, x.size // m), np.complex64)
    load().orc_channelize(x.ctypes.data, x.size, proto.ctypes.data, proto.size, m,
                          out.ctypes.data)
    return out


def channelize_stream(x: np.ndarray, proto: np.ndarray, m: int, hist: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Streaming analysis bank with a carried tail. hist: [T-1] complex64 (T =
    the prototype padded to a multiple of m). Returns (y [m, N/m], new_hist)."""
    x, proto = _cf(x), _f32(proto)
    t = ((proto.size + m - 1) // m) * m
    hist = _cf(hist).copy()
    if hist.size != t - 1:
        raise ValueError(f"hist holds {hist.size} samples, expected {t - 1}")
    out = np.empty((m, x.size // m), np.complex64)
    load().orc_channelize_stream(x.ctypes.data, x.size, proto.ctypes.data, proto.size, m,
                                 hist.ctypes.data, out.ctypes.data)
    return out, hist


def channelize_os2(x: np.ndarray, proto: np.ndarray, m: int) -> np.ndarray:
    """2x-oversampled analysis bank from rest: frames advance by m/2, per-frame
    twiddle (-1)^{ch*k}: [N] -> [m, 2N/m]."""
    x, proto = _cf(x), _f32(proto)
    out = np.empty((m, x.size // (m // 2)), np.complex64)
    load().orc_channelize_os2(x.ctypes.data, x.size, proto.ctypes.data, proto.size, m,
                              out.ctypes.data)
    return out


def _synth(fn, y: np.ndarray, proto: np.ndarray, m: int, hop: int) -> np.ndarray:
    y, proto = _cf(y), _f32(proto)
    mm, k = y.shape
    if mm != m:
        raise ValueError(f"y has {mm} channels, expected {m}")
    out = np.empty(k * hop, np.complex64)
    fn(y.ctypes.data, m, k, proto.ctypes.data, proto.size, out.ctypes.data)
    return out


def synthesize(y: np.ndarray, proto: np.ndarray, m: int) -> np.ndarray:
    """Polyphase synthesis bank from rest: y [m, K] -> x [K*m]."""
    return _synth(load().orc_synthesize, y, proto, m, m)


def synthesize_os2(y: np.ndarray, proto: np.ndarray, m: int) -> np.ndarray:
    """2x-oversampled synthesis bank from rest: y [m, K] -> x [K*m/2]."""
    return _synth(load().orc_synthesize_os2, y, proto, m, m // 2)


def psk_demod(x: np.ndarray, center_freq: float, taps: np.ndarray, decim: int, sps: int,
              order: int) -> np.ndarray:
    """The M-PSK chain from oracle primitives: mix -> matched filter (+decim)
    -> O&M timing -> V&V carrier -> slicer. Returns symbol indices (with the
    chain's M-fold phase ambiguity)."""
    word = int(np.round(((-center_freq) % 1.0) * 4294967296.0) % 4294967296.0)
    mixed, _ = nco_mix(x, 0, word)
    bb = fir(mixed, taps, decim=decim)
    power = (bb.real ** 2 + bb.imag ** 2).astype(np.float32)
    _, tau = timing_estimate(power, sps)
    sym = timing_sample(np.zeros(sps + 1, np.complex64), bb, tau, sps)
    s = sym / np.sqrt(np.mean(np.abs(sym) ** 2) + 1e-12)
    off = 0.5 if order == 4 else 0.0
    acc = np.sum(s ** order * np.exp(-2j * np.pi * off))
    y = s * np.exp(-1j * np.angle(acc) / order)
    return np.mod(np.round(np.angle(y) * order / (2 * np.pi) - off), order).astype(np.int32)
