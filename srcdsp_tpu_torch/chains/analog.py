"""Analog demodulation chains: FM, AM, SSB and FM stereo (counterpart of
``srcdsp_tpu/chains/analog.py``).

Each receiver composes the port's primitives (NCO mix, streaming FIR
decimator, quadrature discriminator, block state-space IIR) as a
`(state, block) -> (state, block)` function with carried state:

- FM discrimination reuses ``chains.fsk.discriminate`` (angle of the
  conjugate product, seam-correct across blocks); de-emphasis is the
  one-pole RC lowpass through ``ops.iir``'s exact block form;
- AM: |x| envelope, then the ``ops.iir`` DC blocker;
- SSB: a one-sided complex-tap channel filter (the analytic band select)
  in the FIR's complex-tap path, then a product detector (Re);
- stereo: the pilot from a one-sided complex bandpass, squared to the 38 kHz
  carrier, the mono and L-R paths delayed to match.

Rates: input blocks at the capture rate; the channel FIR decimates by
`decim`, the audio FIR by `audio_decim`; de-emphasis runs at the audio rate.
N % decim == 0, (N/decim) % audio_decim == 0, and for FM the audio-rate block
length must be a multiple of the de-emphasis IIR block (default 128). The
parameter factories take a `device` (None = the card); the inits put their
state where the params live.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.fsk import discriminate
from srcdsp_tpu_torch.device import as_tensor_on, resolve
from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.ops.iir import (IirParams, IirState, dc_block_coeffs, iir_apply,
                                      iir_init, make_iir_params)
from srcdsp_tpu_torch.ops.nco import NcoState, freq_to_word, nco_apply, nco_init, word_tensor
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.types import CF32, F32

__all__ = [
    "deemphasis_coeffs", "onesided_taps",
    "FmParams", "FmState", "make_fm_params", "fm_init", "fm_apply",
    "AmParams", "AmState", "make_am_params", "am_init", "am_apply",
    "SsbParams", "SsbState", "make_ssb_params", "ssb_init", "ssb_apply",
    "fm_modulate", "am_modulate", "ssb_modulate",
    "StereoParams", "StereoState", "make_fm_stereo_params", "fm_stereo_init",
    "fm_stereo_apply", "fm_stereo_mpx",
    "FmStereoRxParams", "FmStereoRxState", "make_fm_stereo_rx", "fm_stereo_rx_init",
    "fm_stereo_rx_apply",
]

TWO_PI = float(2.0 * np.pi)


# ---------- coefficient helpers ----------

def deemphasis_coeffs(tau_samples: float) -> tuple[np.ndarray, np.ndarray]:
    """One-pole de-emphasis H(z) = (1-a)/(1 - a z^-1), a = exp(-1/tau); tau
    in samples at the audio rate. Unity gain at DC."""
    a = float(np.exp(-1.0 / float(tau_samples)))
    return np.array([1.0 - a]), np.array([1.0, -a])


def onesided_taps(num_taps: int, bandwidth: float, lower: bool = False,
                  window: str = "hamming") -> np.ndarray:
    """Complex taps passing [0, +bandwidth) (USB) or (-bandwidth, 0] (LSB):
    a real lowpass of cutoff bandwidth/2 heterodyned by +/-bandwidth/2."""
    proto = lowpass(num_taps, bandwidth / 2.0, window=window)
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    sign = -1.0 if lower else 1.0
    return (proto * np.exp(1j * sign * np.pi * bandwidth * n)).astype(np.complex64)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _deemph(deemph_tau, iir_block: int, device) -> IirParams | None:
    if deemph_tau is None:
        return None
    b, a = deemphasis_coeffs(deemph_tau)
    return make_iir_params(b, a, block=iir_block, device=device)


# ---------- FM ----------

@dataclasses.dataclass(frozen=True)
class FmParams:
    freq_word: torch.Tensor     # int64 u32 NCO word (mixes the channel to baseband)
    chan_taps: torch.Tensor     # real lowpass, channel select
    audio_taps: torch.Tensor    # real lowpass, audio select
    deemph: IirParams | None    # one-pole de-emphasis at the audio rate
    decim: int
    dev: float                  # cycles/sample at the decimated rate
    audio_decim: int


class FmState(NamedTuple):
    nco: NcoState
    chan: FirState
    disc_last: torch.Tensor
    audio: FirState
    deemph: IirState | None


def make_fm_params(center_freq: float, decim: int, dev: float, audio_decim: int = 4,
                   num_taps: int = 128, audio_taps: int = 64, cutoff: float | None = None,
                   deemph_tau: float | None = None, iir_block: int = 128,
                   device=None) -> FmParams:
    """center_freq in cycles/sample at the input rate; dev in cycles/sample
    at the decimated rate; deemph_tau in samples at the audio rate (None
    disables de-emphasis)."""
    device = resolve(device)
    cut = cutoff if cutoff is not None else 0.4 / decim
    return FmParams(freq_word=word_tensor(freq_to_word(-center_freq), device),
                    chan_taps=_f32(lowpass(num_taps, cut), device),
                    audio_taps=_f32(lowpass(audio_taps, 0.4 / audio_decim), device),
                    deemph=_deemph(deemph_tau, iir_block, device),
                    decim=int(decim), dev=float(dev), audio_decim=int(audio_decim))


def fm_init(params: FmParams, channel_shape: tuple = ()) -> FmState:
    dev = params.chan_taps.device
    return FmState(
        nco=nco_init(channel_shape, device=dev),
        chan=fir_init(int(params.chan_taps.shape[-1]), channel_shape, device=dev),
        disc_last=torch.zeros((*channel_shape, 1), dtype=CF32, device=dev),
        audio=fir_init(int(params.audio_taps.shape[-1]), channel_shape, dtype=CF32, device=dev),
        deemph=(iir_init(params.deemph, channel_shape, dtype=F32, device=dev)
                if params.deemph is not None else None))


def fm_apply(params: FmParams, state: FmState, x: torch.Tensor
             ) -> tuple[FmState, torch.Tensor]:
    """x: [..., N] complex IQ -> audio [..., N/(decim*audio_decim)] float32,
    normalized so a full-deviation tone peaks at +-1."""
    nco_s, mixed = nco_apply(params.freq_word, state.nco, x)
    chan_s, bb = fir_apply(params.chan_taps, state.chan, mixed, decim=params.decim)
    disc_last, d = discriminate(state.disc_last, bb)      # cycles/sample
    audio_in = d * np.float32(1.0 / params.dev)
    aud_s, a = fir_apply(params.audio_taps, state.audio, audio_in, decim=params.audio_decim)
    a = a.real.to(F32)
    de_s = state.deemph
    if params.deemph is not None:
        de_s, a = iir_apply(params.deemph, state.deemph, a)
        a = a.real.to(F32)
    return FmState(nco=nco_s, chan=chan_s, disc_last=disc_last, audio=aud_s, deemph=de_s), a


# ---------- AM ----------

@dataclasses.dataclass(frozen=True)
class AmParams:
    freq_word: torch.Tensor
    chan_taps: torch.Tensor
    audio_taps: torch.Tensor
    dcblock: IirParams
    decim: int
    audio_decim: int


class AmState(NamedTuple):
    nco: NcoState
    chan: FirState
    dc: IirState
    audio: FirState


def make_am_params(center_freq: float, decim: int, audio_decim: int = 4, num_taps: int = 128,
                   audio_taps: int = 64, cutoff: float | None = None, dc_alpha: float = 0.999,
                   iir_block: int = 128, device=None) -> AmParams:
    device = resolve(device)
    cut = cutoff if cutoff is not None else 0.4 / decim
    b, a = dc_block_coeffs(dc_alpha)
    return AmParams(freq_word=word_tensor(freq_to_word(-center_freq), device),
                    chan_taps=_f32(lowpass(num_taps, cut), device),
                    audio_taps=_f32(lowpass(audio_taps, 0.4 / audio_decim), device),
                    dcblock=make_iir_params(b, a, block=iir_block, device=device),
                    decim=int(decim), audio_decim=int(audio_decim))


def am_init(params: AmParams, channel_shape: tuple = ()) -> AmState:
    dev = params.chan_taps.device
    return AmState(nco=nco_init(channel_shape, device=dev),
                   chan=fir_init(int(params.chan_taps.shape[-1]), channel_shape, device=dev),
                   dc=iir_init(params.dcblock, channel_shape, dtype=F32, device=dev),
                   audio=fir_init(int(params.audio_taps.shape[-1]), channel_shape, device=dev))


def am_apply(params: AmParams, state: AmState, x: torch.Tensor
             ) -> tuple[AmState, torch.Tensor]:
    """Envelope detector: |baseband| -> DC block -> audio decimate (carrier
    phase and small CFO do not matter). x: [..., N] complex IQ -> audio
    [..., N/(decim*audio_decim)] float32."""
    nco_s, mixed = nco_apply(params.freq_word, state.nco, x)
    chan_s, bb = fir_apply(params.chan_taps, state.chan, mixed, decim=params.decim)
    env = torch.abs(bb).to(F32)
    dc_s, ac = iir_apply(params.dcblock, state.dc, env)
    aud_s, a = fir_apply(params.audio_taps, state.audio, ac.real.to(F32),
                         decim=params.audio_decim)
    return AmState(nco=nco_s, chan=chan_s, dc=dc_s, audio=aud_s), a.real.to(F32)


# ---------- SSB ----------

@dataclasses.dataclass(frozen=True)
class SsbParams:
    freq_word: torch.Tensor
    chan_taps: torch.Tensor     # complex one-sided band select
    decim: int


class SsbState(NamedTuple):
    nco: NcoState
    chan: FirState


def make_ssb_params(center_freq: float, decim: int, bandwidth: float, lower: bool = False,
                    num_taps: int = 192, device=None) -> SsbParams:
    """center_freq: suppressed-carrier frequency (cycles/sample, input rate);
    bandwidth: audio bandwidth in cycles/sample at the input rate; lower=True
    selects LSB."""
    device = resolve(device)
    return SsbParams(freq_word=word_tensor(freq_to_word(-center_freq), device),
                     chan_taps=torch.as_tensor(onesided_taps(num_taps, 2.0 * bandwidth,
                                                             lower=lower), device=device),
                     decim=int(decim))


def ssb_init(params: SsbParams, channel_shape: tuple = ()) -> SsbState:
    dev = params.chan_taps.device
    return SsbState(nco=nco_init(channel_shape, device=dev),
                    chan=fir_init(int(params.chan_taps.shape[-1]), channel_shape, device=dev))


def ssb_apply(params: SsbParams, state: SsbState, x: torch.Tensor
              ) -> tuple[SsbState, torch.Tensor]:
    """Product detector: mix the suppressed carrier to 0, select one sideband
    with the complex-tap filter, emit Re. x: [..., N] complex IQ -> audio
    [..., N/decim] float32."""
    nco_s, mixed = nco_apply(params.freq_word, state.nco, x)
    chan_s, an = fir_apply(params.chan_taps, state.chan, mixed, decim=params.decim)
    return SsbState(nco=nco_s, chan=chan_s), (2.0 * an.real).to(F32)


# ---------- modulators (test fixtures) ----------

def fm_modulate(audio, dev: float, center: float = 0.0, device=None) -> torch.Tensor:
    """Audio in [-1, 1] -> complex FM baseband at the same rate, on audio's
    device (a non-tensor goes to `device`, None = the card): exp(j 2 pi
    cumsum(center + dev * audio)) with the float32 phase sum of the
    reference."""
    inst = center + dev * as_tensor_on(audio, device, F32)
    ph = torch.cumsum(inst, dim=-1)
    return torch.exp(1j * (TWO_PI * ph)).to(CF32)


def am_modulate(audio, depth: float = 0.5, center: float = 0.0, device=None) -> torch.Tensor:
    """(1 + depth*audio) * carrier. audio in [-1, 1], depth < 1; on audio's
    device (a non-tensor goes to `device`, None = the card)."""
    audio = as_tensor_on(audio, device, F32)
    k = torch.arange(audio.shape[-1], dtype=F32, device=audio.device)
    carrier = torch.exp(1j * (TWO_PI * center * k)).to(CF32)
    return ((1.0 + depth * audio) * carrier).to(CF32)


def ssb_modulate(audio: np.ndarray, center: float, lower: bool = False) -> np.ndarray:
    """USB/LSB fixture (host numpy): analytic signal of audio (one-sided
    spectrum by FFT masking) shifted to `center`."""
    a = np.asarray(audio, np.float64)
    n = a.shape[-1]
    spec = np.fft.fft(a)
    mask = np.zeros(n)
    mask[0] = 1.0
    if n % 2 == 0:
        mask[n // 2] = 1.0
        mask[1:n // 2] = 2.0
    else:
        mask[1:(n + 1) // 2] = 2.0
    analytic = np.fft.ifft(spec * mask)
    if lower:
        analytic = np.conj(analytic)
    k = np.arange(n)
    return (analytic * np.exp(2j * np.pi * center * k)).astype(np.complex64)


# ---------- FM stereo (MPX) ----------

@dataclasses.dataclass(frozen=True)
class StereoParams:
    """FM stereo multiplex decoder: L/R from the composite MPX (mono (L+R)/2
    at baseband, a pilot at f_p, the (L-R)/2 DSB subcarrier at 2 f_p). The
    pilot comes from a one-sided complex bandpass, so squaring its unit
    phasor regenerates the 38 kHz carrier in phase; the mono and demux paths
    run through a pure-delay FIR matching the pilot filter's group delay."""

    pilot_taps: torch.Tensor      # [Tp] complex one-sided bandpass at +f_p
    delay_taps: torch.Tensor      # [Tp] delta at the pilot filter's delay
    audio_taps: torch.Tensor      # [Ta] real lowpass for mono / L-R
    audio_decim: int


class StereoState(NamedTuple):
    pilot: FirState
    delay: FirState
    mono: FirState
    lr: FirState


def make_fm_stereo_params(f_pilot: float, audio_bw: float, audio_decim: int,
                          pilot_ntaps: int = 257, audio_ntaps: int = 128,
                          device=None) -> StereoParams:
    """f_pilot / audio_bw in cycles/sample at the MPX rate; pilot_ntaps odd
    (exact integer group delay)."""
    if pilot_ntaps % 2 == 0:
        raise ValueError("pilot_ntaps must be odd")
    device = resolve(device)
    proto = lowpass(pilot_ntaps, f_pilot * 0.15)
    n = np.arange(pilot_ntaps) - (pilot_ntaps - 1) / 2.0
    pil = (proto * np.exp(2j * np.pi * f_pilot * n)).astype(np.complex64)
    delta = np.zeros(pilot_ntaps, np.float32)
    delta[(pilot_ntaps - 1) // 2] = 1.0
    return StereoParams(pilot_taps=torch.as_tensor(pil, device=device),
                        delay_taps=torch.as_tensor(delta, device=device),
                        audio_taps=_f32(lowpass(audio_ntaps, audio_bw), device),
                        audio_decim=int(audio_decim))


def fm_stereo_init(params: StereoParams, channel_shape: tuple = ()) -> StereoState:
    tp = int(params.pilot_taps.shape[-1])
    ta = int(params.audio_taps.shape[-1])
    dev = params.pilot_taps.device
    return StereoState(pilot=fir_init(tp, channel_shape, device=dev),
                       delay=fir_init(tp, channel_shape, device=dev),
                       mono=fir_init(ta, channel_shape, device=dev),
                       lr=fir_init(ta, channel_shape, device=dev))


def fm_stereo_apply(params: StereoParams, state: StereoState, mpx: torch.Tensor
                    ) -> tuple[StereoState, torch.Tensor]:
    """mpx: [..., N] real composite -> [..., 2, N/audio_decim] float32 (L, R).
    carrier38 = (pilot / |pilot|)^2: squaring the unit phasor doubles its
    frequency and phase (no PLL)."""
    x = mpx.to(CF32)
    p_s, pil = fir_apply(params.pilot_taps, state.pilot, x)
    d_s, xd = fir_apply(params.delay_taps, state.delay, x)
    u = pil / (torch.abs(pil) + np.float32(1e-12))
    c38 = u * u                                      # e^{j 2 theta}
    demux = 2.0 * (xd * torch.conj(c38)).real
    m_s, mono = fir_apply(params.audio_taps, state.mono, xd.real, decim=params.audio_decim)
    l_s, lr = fir_apply(params.audio_taps, state.lr, demux, decim=params.audio_decim)
    mono = mono.real.to(F32)
    lr = lr.real.to(F32)
    out = torch.stack([mono + lr, mono - lr], dim=-2)
    return StereoState(pilot=p_s, delay=d_s, mono=m_s, lr=l_s), out


def fm_stereo_mpx(left: np.ndarray, right: np.ndarray, f_pilot: float,
                  pilot_level: float = 0.1) -> np.ndarray:
    """Composite MPX fixture (host numpy): (L+R)/2 + pilot + (L-R)/2 *
    cos(2*pi*2fp*n), phase-coherent pilot/subcarrier."""
    left = np.asarray(left, np.float64)
    right = np.asarray(right, np.float64)
    n = np.arange(left.size)
    return ((left + right) / 2.0
            + pilot_level * np.cos(2 * np.pi * f_pilot * n)
            + (left - right) / 2.0 * np.cos(2 * np.pi * 2 * f_pilot * n)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FmStereoRxParams:
    """Full broadcast-FM stereo receiver: the FM front end (NCO + channel
    select + discriminator) feeding the MPX stereo decoder, with optional
    per-channel de-emphasis."""

    freq_word: torch.Tensor
    chan_taps: torch.Tensor
    stereo: StereoParams
    deemph: IirParams | None
    decim: int
    dev: float


class FmStereoRxState(NamedTuple):
    nco: NcoState
    chan: FirState
    disc_last: torch.Tensor
    stereo: StereoState
    deemph: IirState | None     # stacked [..., 2] channel axis when present


def make_fm_stereo_rx(center_freq: float, decim: int, dev: float, pilot: float,
                      audio_decim: int = 4, num_taps: int = 128, cutoff: float | None = None,
                      deemph_tau: float | None = None, iir_block: int = 128,
                      device=None) -> FmStereoRxParams:
    """pilot in cycles/sample at the post-decim (MPX) rate; dev at the
    decimated rate; deemph_tau in samples at the audio rate."""
    device = resolve(device)
    cut = cutoff if cutoff is not None else 0.4 / decim
    return FmStereoRxParams(
        freq_word=word_tensor(freq_to_word(-center_freq), device),
        chan_taps=_f32(lowpass(num_taps, cut), device),
        stereo=make_fm_stereo_params(pilot, audio_bw=pilot * 0.75, audio_decim=audio_decim,
                                     device=device),
        deemph=_deemph(deemph_tau, iir_block, device), decim=int(decim), dev=float(dev))


def fm_stereo_rx_init(params: FmStereoRxParams, channel_shape: tuple = ()) -> FmStereoRxState:
    dev = params.chan_taps.device
    return FmStereoRxState(
        nco=nco_init(channel_shape, device=dev),
        chan=fir_init(int(params.chan_taps.shape[-1]), channel_shape, device=dev),
        disc_last=torch.zeros((*channel_shape, 1), dtype=CF32, device=dev),
        stereo=fm_stereo_init(params.stereo, channel_shape),
        deemph=(iir_init(params.deemph, (*channel_shape, 2), dtype=F32, device=dev)
                if params.deemph is not None else None))


def fm_stereo_rx_apply(params: FmStereoRxParams, state: FmStereoRxState, x: torch.Tensor
                       ) -> tuple[FmStereoRxState, torch.Tensor]:
    """x: [..., N] complex IQ -> [..., 2, N/(decim*audio_decim)] float32 L/R."""
    nco_s, mixed = nco_apply(params.freq_word, state.nco, x)
    chan_s, bb = fir_apply(params.chan_taps, state.chan, mixed, decim=params.decim)
    disc_last, d = discriminate(state.disc_last, bb)
    st_s, lr = fm_stereo_apply(params.stereo, state.stereo, d * np.float32(1.0 / params.dev))
    de_s = state.deemph
    if params.deemph is not None:
        de_s, lr = iir_apply(params.deemph, state.deemph, lr)
        lr = lr.real.to(F32)
    return FmStereoRxState(nco=nco_s, chan=chan_s, disc_last=disc_last, stereo=st_s,
                           deemph=de_s), lr
