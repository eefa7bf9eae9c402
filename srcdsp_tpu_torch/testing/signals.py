"""Signal generators (counterpart of ``srcdsp_tpu/testing/signals.py``).

numpy with float64 phase and an explicit ``np.random.Generator``: the same
seed gives the same data on any host. Callers move the result to a device.
"""

from __future__ import annotations

import numpy as np
import torch


def tone(n: int, freq: float, phase0: float = 0.0, amplitude: float = 1.0,
         channel_shape: tuple = ()) -> np.ndarray:
    """Complex exponential at `freq` cycles/sample: a*exp(j*2pi*(f*n + p0)),
    the same in every channel of [*channel_shape, n]."""
    k = np.arange(n, dtype=np.float64)
    x = (amplitude * np.exp(2j * np.pi * ((freq * k + phase0) % 1.0))).astype(np.complex64)
    return np.broadcast_to(x, (*channel_shape, n)).copy() if channel_shape else x


def np_tone(n: int, freq: float, phase0: float = 0.0, amplitude: float = 1.0) -> np.ndarray:
    """The reference's numpy tone, which the CLI's `gen` and `scan` call; the
    port's `tone` is numpy already, so it is the same samples."""
    return tone(n, freq, phase0, amplitude)


def complex_awgn(rng: np.random.Generator, shape: tuple, power: float = 1.0) -> np.ndarray:
    """Circular complex white Gaussian noise with total power `power`, complex64."""
    s = np.sqrt(power / 2.0)
    return (s * rng.standard_normal(shape) + 1j * s * rng.standard_normal(shape)).astype(np.complex64)


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


def psk_symbols(rng: np.random.Generator, nsym: int, order: int = 4,
                channel_shape: tuple = ()) -> tuple[np.ndarray, np.ndarray]:
    """Random M-PSK symbols. Returns (indices int32 [..., nsym], complex64 symbols):
    symbol m is exp(j*2pi*(m + off)/M), off = 0.5 for QPSK, else 0."""
    idx = rng.integers(0, order, size=(*channel_shape, nsym), dtype=np.int32)
    off = 0.5 if order == 4 else 0.0
    sym = np.exp(2j * np.pi * (idx.astype(np.float64) + off) / order).astype(np.complex64)
    return idx, sym


def upsample_pulse(symbols, sps: int, pulse) -> np.ndarray | torch.Tensor:
    """Zero-stuff symbols by sps and pulse-shape (linear modulation TX), with
    the port's resampler from rest. A tensor stays on its device; a numpy
    array is shaped on the CPU and comes back as numpy complex64."""
    from srcdsp_tpu_torch.ops.resample import resample_full

    if isinstance(symbols, torch.Tensor):
        return resample_full(pulse, symbols, up=sps, down=1)
    x = torch.from_numpy(np.ascontiguousarray(symbols, np.complex64))
    return resample_full(pulse, x, up=sps, down=1).numpy()


def psk_wideband(rng: np.random.Generator, num_channels: int, nsym: int, order: int = 4,
                 sps: int = 4, taps_per_phase: int = 8, device=None):
    """A wideband of `num_channels` M-PSK channels, channel m centred at m/M.

    Per channel: random data, differentially encoded, RRC-shaped at sps
    samples/symbol of the channel rate (span 4, beta 0.35); then the plain
    synthesis bank (``chains.channelizer.synthesize_apply`` from rest, the
    prototype design_prototype(M, taps_per_phase)) puts every channel in its
    place. Returns (data int32 numpy [M, nsym], prototype, x complex64 tensor
    [nsym * sps * M] on `device`, the card unless it says otherwise).
    """
    from srcdsp_tpu_torch.chains.channelizer import (
        design_prototype, synthesize_apply, synthesizer_init)
    from srcdsp_tpu_torch.chains.psk import constellation_offset, diff_encode
    from srcdsp_tpu_torch.device import resolve
    from srcdsp_tpu_torch.ops.window import root_raised_cosine

    device = resolve(device)
    m = num_channels
    data = rng.integers(0, order, size=(m, nsym), dtype=np.int32)
    tx = diff_encode(torch.from_numpy(data), order).numpy()
    sym = np.exp(2j * np.pi * (tx + constellation_offset(order)) / order).astype(np.complex64)
    bb = upsample_pulse(torch.as_tensor(sym, device=device), sps, root_raised_cosine(sps, 4))
    proto = design_prototype(m, taps_per_phase=taps_per_phase)
    _, x = synthesize_apply(proto, synthesizer_init(proto, m, device=device), bb, m)
    return data, proto, x


def zadoff_chu(root: int, length: int) -> np.ndarray:
    """Zadoff-Chu CAZAC sequence (LTE/NR sync-style preambles).

    x[n] = exp(-j*pi*root*n*(n + N%2) / N). With gcd(root, N) == 1 the
    sequence has constant modulus and zero cyclic autocorrelation at every
    nonzero lag: the SC-FDE pilot (``chains.scfde``).
    """
    if np.gcd(root, length) != 1:
        raise ValueError(f"gcd(root={root}, N={length}) must be 1")
    n = np.arange(length, dtype=np.float64)
    ph = root * n * (n + (length % 2)) / length
    return np.exp(-1j * np.pi * ph).astype(np.complex64)


def chirp(n: int, f0: float, f1: float, amplitude: float = 1.0) -> np.ndarray:
    """Linear FM (LFM) chirp sweeping f0 -> f1 cycles/sample over n samples,
    complex64, from the float64 host phase f0*k + (f1-f0)*k^2/(2n): the
    pulse-compression waveform of ``ops.radar`` (bit for bit the
    reference's)."""
    k = np.arange(n, dtype=np.float64)
    ph = f0 * k + (f1 - f0) * k * k / (2.0 * n)
    return (amplitude * np.exp(2j * np.pi * ph)).astype(np.complex64)


def ook_baseband(bits, sps: int, depth: float = 1.0, rise: int = 0) -> np.ndarray:
    """OOK/ASK baseband: bits [..., Nbit] {0,1} -> [..., Nbit*sps] complex64
    with on-level 1 and off-level (1-depth) (depth 1 is pure on-off keying).
    rise > 1 smooths the edges with a length-rise boxcar (edge-filtered
    transmitters)."""
    bits = np.asarray(bits)
    amp = (1.0 - depth) + depth * bits.astype(np.float64)
    env = np.repeat(amp, sps, axis=-1)
    if rise > 1:
        k = np.ones(rise) / rise
        pad = np.concatenate([env[..., :1]] * (rise - 1) + [env], axis=-1)
        env = np.apply_along_axis(lambda v: np.convolve(v, k, mode="valid"), -1, pad)
    return env.astype(np.complex64)


def manchester_encode(bits) -> np.ndarray:
    """IEEE-convention Manchester line code: 1 -> (1,0), 0 -> (0,1).
    bits [..., Nbit] -> chips [..., 2*Nbit] {0,1} int64."""
    bits = np.asarray(bits).astype(np.int64)
    chips = np.stack([bits, 1 - bits], axis=-1)
    return chips.reshape(*bits.shape[:-1], 2 * bits.shape[-1])


def gmsk_baseband(bits, sps: int, bt: float | None = 0.3, span: int = 3) -> np.ndarray:
    """GMSK/MSK baseband: Gaussian-filtered CPM with h = 1/2.

    bits: [..., Nsym] of {0,1} -> [..., Nsym*sps] complex64, constant
    envelope. Each bit steps the phase by +-pi/2 in total (+-0.25 cycles),
    spread over `span` bit periods by the Gaussian frequency pulse with the
    given BT product (bt=None selects the rectangular pulse = pure MSK, where
    the step completes within its own bit).
    """
    from srcdsp_tpu_torch.ops.window import gaussian_freq_pulse

    bits = np.asarray(bits)
    nrz = 2.0 * bits.astype(np.float64) - 1.0
    if bt is None:
        p = np.ones(sps) / sps * 0.25            # MSK: rect pulse
    else:
        p = gaussian_freq_pulse(sps, bt, span)   # integrates to h/2 cycles
    up = np.zeros((*nrz.shape[:-1], nrz.shape[-1] * sps))
    up[..., ::sps] = nrz
    freq = np.empty_like(up)                     # cycles/sample
    pad = np.zeros((*up.shape[:-1], p.size - 1))
    full = np.concatenate([up, pad], axis=-1)
    for idx0 in np.ndindex(*up.shape[:-1]):
        freq[idx0] = np.convolve(full[idx0], p)[: up.shape[-1]]  # causal
    phase = np.cumsum(freq, axis=-1) - freq
    return np.exp(2j * np.pi * phase).astype(np.complex64)
