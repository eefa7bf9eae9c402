"""Transmit chains: streaming modulators (counterpart of
``srcdsp_tpu/chains/tx.py``), with the receive chains' (state, block) ->
(state, block) contract.

- **Linear modulations** (PSK / QAM / any complex symbols): zero-stuff
  polyphase interpolation through the pulse (``ops.resample``, carried tail)
  and the u32-phase NCO upconversion.
- **CPM** (CPFSK / MSK / GMSK): the frequency pulse is quantized to int32
  phase-increment words at design time; the per-sample word is a shift-and-add
  over the NRZ bits (exact integers) and the phase a wrapping 32-bit running
  sum with a carried accumulator, so streaming joins are bit-exact under any
  block split.

Constellation conventions match the receive chains (chains.psk, chains.qam).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.psk import constellation_offset
from srcdsp_tpu_torch.chains.qam import qam_constellation
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.nco import TWO_PI, NcoState, freq_to_word, nco_apply, nco_init, word_tensor
from srcdsp_tpu_torch.ops.resample import ResampleState, resample_apply, resample_init
from srcdsp_tpu_torch.ops.window import gaussian_freq_pulse
from srcdsp_tpu_torch.types import CF32, F32


# ---------------------------------------------------------------------------
# Symbol mappers (conventions shared with the receive slicers)
# ---------------------------------------------------------------------------

def psk_map(idx: torch.Tensor, order: int) -> torch.Tensor:
    """Index m -> exp(j*2*pi*(m+off)/M), off as in chains.psk's slicer."""
    ph = (idx.to(F32) + np.float32(constellation_offset(order))) / np.float32(order)
    return torch.polar(torch.ones_like(ph), ph * np.float32(TWO_PI))


def qam_map(idx: torch.Tensor, order: int) -> torch.Tensor:
    """Gray symbol index -> unit-average-power square-QAM point."""
    return torch.as_tensor(qam_constellation(order), device=idx.device)[idx.to(torch.int64)]


def bits_to_indices(bits: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """Pack bits MSB-first into symbol indices: [..., N*b] -> [..., N] int32."""
    n = bits.shape[-1]
    if n % bits_per_symbol != 0:
        raise ValueError(f"{n} bits not divisible by {bits_per_symbol}")
    b = bits.to(torch.int32).reshape(*bits.shape[:-1], -1, bits_per_symbol)
    w = torch.as_tensor(2 ** np.arange(bits_per_symbol - 1, -1, -1), dtype=torch.int32,
                        device=bits.device)
    return torch.sum(b * w, dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Linear TX: symbols -> pulse-shaped, upconverted IQ
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinearTxParams:
    """Pulse-shaping interpolator + upconverter: `taps` is the pulse at `sps`
    samples/symbol, `freq_word` the +center tuning word(s)."""

    freq_word: torch.Tensor
    taps: torch.Tensor
    sps: int


class LinearTxState(NamedTuple):
    rs: ResampleState
    nco: NcoState


def make_linear_tx(center_freq, taps, sps: int, device=None) -> LinearTxParams:
    """center_freq: one frequency, or one per channel (an array). taps: numpy,
    a list or a tensor on any device (a receiver's, e.g. `PskParams.taps`)."""
    device = resolve(device)
    return LinearTxParams(freq_word=word_tensor(freq_to_word(center_freq), device),
                          taps=torch.as_tensor(taps, dtype=torch.float32, device=device),
                          sps=sps)


def linear_tx_init(params: LinearTxParams, channel_shape: tuple = ()) -> LinearTxState:
    dev = params.taps.device
    return LinearTxState(rs=resample_init(int(params.taps.shape[-1]), params.sps, channel_shape,
                                          device=dev),
                         nco=nco_init(channel_shape, device=dev))


def linear_tx_apply(params: LinearTxParams, state: LinearTxState, symbols: torch.Tensor
                    ) -> tuple[LinearTxState, torch.Tensor]:
    """Modulate one block: symbols [..., Nsym] complex -> [..., Nsym*sps]."""
    rs, shaped = resample_apply(params.taps, state.rs, symbols.to(CF32), up=params.sps, down=1)
    nco, out = nco_apply(params.freq_word, state.nco, shaped)
    return LinearTxState(rs=rs, nco=nco), out


# ---------------------------------------------------------------------------
# CPM TX: bits -> frequency pulse -> exact fixed-point phase integration
# ---------------------------------------------------------------------------

_SCALE = float(1 << 32)
_INV_SCALE = float(2.0 ** -32)


def _pulse_words(pulse: np.ndarray, sps: int) -> np.ndarray:
    """A frequency pulse as int32 phase-increment words [nspan, sps]; the
    largest tap is nudged so each bit advances exactly round(sum(p) * 2^32)."""
    p = np.asarray(pulse, np.float64)
    nspan = -(-p.size // sps)
    p = np.pad(p, (0, nspan * sps - p.size))
    w = np.round(p * _SCALE).astype(np.int64)
    w[np.argmax(np.abs(w))] += np.round(p.sum() * _SCALE).astype(np.int64) - w.sum()
    if np.abs(w).max() >= 2 ** 31:
        raise ValueError("pulse too large: |tap| must stay below 0.5 cycles")
    return w.reshape(nspan, sps).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class CpmTxParams:
    """`words`: the frequency pulse as int32 phase-increment words [nspan,
    sps] (2^-32 turns per sample); `freq_word` upconverts."""

    freq_word: torch.Tensor
    words: torch.Tensor
    sps: int


class CpmTxState(NamedTuple):
    hist: torch.Tensor    # [..., nspan-1] int32 NRZ history (+-1)
    phase: torch.Tensor   # [...] int32 accumulated phase word (2^-32 turns)
    nco: NcoState


def make_cpfsk_tx(center_freq: float, sps: int, dev: float, device=None) -> CpmTxParams:
    """Square-pulse CPFSK at +/-dev cycles/sample."""
    device = resolve(device)
    return CpmTxParams(freq_word=word_tensor(freq_to_word(center_freq), device),
                       words=torch.as_tensor(_pulse_words(np.full(sps, dev), sps), device=device),
                       sps=sps)


def make_gmsk_tx(center_freq: float, sps: int, bt: float = 0.3, span: int = 3,
                 device=None) -> CpmTxParams:
    device = resolve(device)
    return CpmTxParams(freq_word=word_tensor(freq_to_word(center_freq), device),
                       words=torch.as_tensor(_pulse_words(gaussian_freq_pulse(sps, bt, span),
                                                          sps), device=device),
                       sps=sps)


def cpm_tx_init(params: CpmTxParams, channel_shape: tuple = ()) -> CpmTxState:
    dev = params.words.device
    nspan = int(params.words.shape[0])
    return CpmTxState(hist=torch.zeros((*channel_shape, nspan - 1), dtype=torch.int32, device=dev),
                      phase=torch.zeros(channel_shape, dtype=torch.int32, device=dev),
                      nco=nco_init(channel_shape, device=dev))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits (two's complement)."""
    return (torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)


def cpm_tx_apply(params: CpmTxParams, state: CpmTxState, bits: torch.Tensor
                 ) -> tuple[CpmTxState, torch.Tensor]:
    """Modulate one block: bits [..., Nsym] {0,1} -> [..., Nsym*sps].

    word[m*sps + r] = sum_j nrz[m-j] * words[j, r] (every product +-words),
    summed with wrap-around from the carried phase: the phase words equal the
    reference's int32 arithmetic under any block split.
    """
    nsym = bits.shape[-1]
    nspan = int(params.words.shape[0])
    words = params.words.to(torch.int64)
    nrz = 2 * bits.to(torch.int32) - 1
    ext = torch.cat([state.hist, nrz], dim=-1)
    e64 = ext.to(torch.int64)
    w = sum(e64[..., nspan - 1 - j:nspan - 1 - j + nsym, None] * words[j] for j in range(nspan))
    w = _wrap32(w.reshape(*w.shape[:-2], nsym * params.sps)).to(torch.int64)
    csum = torch.cumsum(w, dim=-1)
    ph_words = _wrap32(state.phase.to(torch.int64)[..., None] + csum - w)   # phase before step
    ph = ph_words.to(F32) * np.float32(_INV_SCALE)
    bb = torch.polar(torch.ones_like(ph), ph * np.float32(TWO_PI))
    nco, out = nco_apply(params.freq_word, state.nco, bb)
    return CpmTxState(hist=ext[..., ext.shape[-1] - (nspan - 1):],
                      phase=_wrap32(state.phase.to(torch.int64) + csum[..., -1]),
                      nco=nco), out
