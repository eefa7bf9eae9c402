"""OFDM transmit and receive path (counterpart of ``srcdsp_tpu/chains/ofdm.py``).

The whole receiver is reshapes, batched FFTs (``torch.fft``, whose default
norm is ``jnp.fft``'s) and elementwise algebra:

- **Symbol framing**: [S*(N+CP)] -> [S, N+CP] is one reshape; CP removal a
  slice.
- **Coarse timing (Schmidl-Cox)**: the two-identical-halves preamble metric
  P(d) = sum y[d+m] conj(y[d+m+N/2]) over a sliding window, by cumsums.
- **Fractional CFO from the CP**: angle of the CP-to-tail correlation,
  averaged over symbols.
- **Channel estimate + equalizer**: LS one-tap H = Y_p / X_p from a known
  pilot symbol; QAM slicing by ``chains.qam.qam_slice``.

Subcarrier convention: `active` holds FFT-bin indices (DC = 0, negative
frequencies as N-k); the default layout uses bins +-1..+-n_active/2 (DC
nulled). The Schmidl-Cox preamble draws its QPSK points from a
``numpy.random.Generator`` where the reference takes a JAX key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from srcdsp_tpu_torch.chains.qam import qam_constellation, qam_slice
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32, F32


class OfdmSpec(NamedTuple):
    nfft: int
    cp: int
    active: np.ndarray     # [n_active] FFT-bin indices carrying data
    order: int             # QAM order per subcarrier


def make_ofdm_spec(nfft: int = 64, cp: int = 16, n_active: int = 52,
                   order: int = 16) -> OfdmSpec:
    """Default band layout: bins +-1..+-n_active/2, DC and band edges null."""
    if n_active % 2 or n_active >= nfft:
        raise ValueError("n_active must be even and < nfft")
    half = n_active // 2
    act = np.concatenate([np.arange(1, half + 1), np.arange(nfft - half, nfft)])
    return OfdmSpec(nfft=int(nfft), cp=int(cp), active=act, order=int(order))


def sym_len(spec: OfdmSpec) -> int:
    return spec.nfft + spec.cp


def _active(spec: OfdmSpec, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(spec.active, np.int64), device=device)


def ofdm_grid(spec: OfdmSpec, points: torch.Tensor) -> torch.Tensor:
    """QAM points [S, n_active] on their bins of the [S, nfft] grid (the
    transmitter's symbol map)."""
    grid = torch.zeros((points.shape[0], spec.nfft), dtype=CF32, device=points.device)
    grid[:, _active(spec, points.device)] = points.to(CF32)
    return grid


def _ifft_scaled(spec: OfdmSpec, grid: torch.Tensor) -> torch.Tensor:
    """ifft (1/N) times sqrt(N): unit subcarrier power -> time-domain power
    n_active/N."""
    return torch.fft.ifft(grid, dim=-1) * float(np.float32(np.sqrt(spec.nfft)))


def ofdm_modulate(spec: OfdmSpec, points: torch.Tensor) -> torch.Tensor:
    """QAM points [S, n_active] -> time-domain samples [S*(N+CP)] complex64."""
    td = _ifft_scaled(spec, ofdm_grid(spec, points))
    return torch.cat([td[:, td.shape[-1] - spec.cp:], td], dim=-1).reshape(-1).to(CF32)


def ofdm_modulate_windowed(spec: OfdmSpec, points: torch.Tensor, window: int) -> torch.Tensor:
    """WOLA transmit shaping: each symbol gets a `window`-sample cyclic
    suffix and raised-cosine edge ramps, overlap-added with its neighbours;
    the receiver's FFT window still sees a pure cyclic extension while
    window <= cp//4 (ofdm_rx's timing-bias margin).

    points: [S, n_active] -> [S*(N+CP) + window] samples.
    """
    if window <= 0:
        return ofdm_modulate(spec, points)
    if window > spec.cp // 4:
        raise ValueError(f"window {window} exceeds the rx margin cp//4 = {spec.cp // 4}")
    dev = points.device
    td = _ifft_scaled(spec, ofdm_grid(spec, points))                  # [S, N]
    l = spec.nfft + spec.cp
    ext = torch.cat([td[:, spec.nfft - spec.cp:], td, td[:, :window]], dim=-1)
    ramp = 0.5 * (1 - torch.cos(math.pi * (torch.arange(window, dtype=F32, device=dev) + 0.5)
                                / window))
    taper = torch.cat([ramp, torch.ones(l - window, dtype=F32, device=dev), ramp.flip(0)])
    ext = ext * taper
    # overlap-add at stride L: each symbol's window-sample tail onto the
    # next symbol's head
    bodies = ext[:, :l].reshape(-1)
    tails = F.pad(ext[:, l:], (0, l - window)).reshape(-1)
    zw = torch.zeros(window, dtype=CF32, device=dev)
    out = torch.cat([bodies, zw])
    shifted = torch.cat([torch.zeros(l, dtype=CF32, device=dev), tails])[: out.shape[0]]
    return (out + shifted).to(CF32)


def preamble_from_angles(spec: OfdmSpec, ang: torch.Tensor) -> torch.Tensor:
    """The Schmidl-Cox preamble (with CP) from its QPSK angle indices
    (float32 [n_even] in 0..3) on the even active bins."""
    act_even = spec.active[spec.active % 2 == 0]
    pts = torch.exp(1j * (2 * math.pi) * (ang + 0.5) / 4) * float(
        np.float32(np.sqrt(spec.active.size / act_even.size)))
    grid = torch.zeros((spec.nfft,), dtype=CF32, device=ang.device)
    grid[torch.as_tensor(act_even, device=ang.device)] = pts.to(CF32)
    td = _ifft_scaled(spec, grid)
    return torch.cat([td[spec.nfft - spec.cp:], td]).to(CF32)


def schmidl_cox_preamble(spec: OfdmSpec, rng: np.random.Generator, device=None) -> torch.Tensor:
    """Two-identical-halves preamble symbol (even bins only), with CP: QPSK
    boosted so that preamble power = data power. The points come from `rng`
    (the reference draws them from a JAX key)."""
    act_even = spec.active[spec.active % 2 == 0]
    if act_even.size == 0:
        raise ValueError("need at least one even active bin")
    ang = rng.integers(0, 4, size=act_even.size).astype(np.float32)
    return preamble_from_angles(spec, torch.as_tensor(ang, device=resolve(device)))


def ofdm_tx_frame(spec: OfdmSpec, points: torch.Tensor, pilot: torch.Tensor,
                  rng: np.random.Generator, window: int = 0) -> torch.Tensor:
    """[S&C preamble | pilot | data] transmit frame, optionally WOLA-windowed
    (the counterpart of ofdm_rx), on the points' device."""
    sym = torch.cat([pilot[None].to(CF32), points.to(CF32)], dim=0)
    body = ofdm_modulate_windowed(spec, sym, window) if window else ofdm_modulate(spec, sym)
    pre = schmidl_cox_preamble(spec, rng, device=points.device)
    return torch.cat([pre, body]).to(CF32)


def papr_db(x: torch.Tensor) -> torch.Tensor:
    p = torch.abs(x) ** 2
    return 10.0 * torch.log10(torch.max(p) / torch.mean(p))


def papr_reduce(spec: OfdmSpec, x: torch.Tensor, clip_db: float = 4.0,
                iters: int = 2) -> torch.Tensor:
    """Iterative clip-and-filter PAPR reduction of a stream made by
    ofdm_modulate (whole CP-extended symbols).

    Each pass soft-clips the envelope at clip_db above the mean power, then
    refilters each symbol by zeroing its inactive bins, and rebuilds the CP
    from the filtered body.
    """
    l = spec.nfft + spec.cp
    if x.ndim != 1:
        raise ValueError("papr_reduce takes one [S*(N+CP)] stream")
    if x.shape[-1] % l != 0:
        raise ValueError(f"length {x.shape[-1]} is not whole CP-extended symbols of {l} "
                         f"(windowed/preamble frames must be reduced per ofdm_modulate "
                         f"segment)")
    s = x.shape[-1] // l
    act = torch.zeros((spec.nfft,), dtype=F32, device=x.device)
    act[_active(spec, x.device)] = 1.0
    y = x.reshape(s, l)
    for _ in range(iters):
        p_mean = torch.mean(torch.abs(y) ** 2)
        a_max = torch.sqrt(p_mean * 10.0 ** (clip_db / 10.0))
        mag = torch.abs(y)
        y = torch.where(mag > a_max, y * (a_max / (mag + 1e-12)), y)
        body = torch.fft.ifft(torch.fft.fft(y[:, spec.cp:], dim=-1) * act, dim=-1)
        y = torch.cat([body[:, spec.nfft - spec.cp:], body], dim=-1)
    return y.reshape(-1).to(CF32)


def _sliding_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """s[d] = sum x[d .. d+w-1], length len(x)-w+1, via one cumsum."""
    c = torch.cumsum(x, dim=0)
    return c[w - 1:] - torch.cat([torch.zeros((1,), dtype=c.dtype, device=c.device),
                                  c[: c.shape[0] - w]])


def schmidl_cox_metric(y: torch.Tensor, nfft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Timing metric M(d) = |P(d)|^2 / R(d)^2 via sliding sums.

    P(d) sums the lag-N/2 self-correlation over a window of N/2; R(d) is half
    the energy of the full N window (the Minn variant, which keeps M <= ~1
    past the preamble's trailing edge). Returns (P [D], M [D]) with
    D = len(y) - nfft; the preamble start is the plateau argmax of M.
    """
    h = nfft // 2
    d = y.shape[-1] - nfft
    c = y[: y.shape[-1] - h] * torch.conj(y[h:])
    p = _sliding_sum(c, h)[:d]
    r = 0.5 * _sliding_sum(torch.abs(y) ** 2, nfft)[:d]
    m = (torch.abs(p) ** 2) / (r ** 2 + 1e-12)
    return p, m


def coarse_start(m: torch.Tensor, cp: int) -> torch.Tensor:
    """Plateau-robust start pick: argmax of M smoothed over the CP width
    (the metric plateaus over [s0, s0+cp]; the smoothed argmax returns ~s0)."""
    k = torch.full((1, 1, cp), np.float32(1.0 / cp), dtype=F32, device=m.device)
    m = m.to(F32)
    pin_f32(m)
    sm = F.conv1d(m[None, None], k)[0, 0]
    return torch.argmax(sm)


def cfo_from_preamble_p(p_at_start: torch.Tensor, nfft: int) -> torch.Tensor:
    """Fractional CFO (in subcarrier spacings) from P at the metric peak:
    over the lag N/2 a CFO of eps spacings rotates by -pi*eps."""
    return -torch.angle(p_at_start) / math.pi


def cfo_correct(y: torch.Tensor, eps, nfft: int) -> torch.Tensor:
    """Remove a CFO of `eps` subcarrier spacings: y * exp(-j 2 pi eps n / N).
    eps: a Python float or a float32 tensor."""
    n = torch.arange(y.shape[-1], dtype=F32, device=y.device)
    w = (float(np.float32(-2 * math.pi * eps)) if not isinstance(eps, torch.Tensor)
         else float(np.float32(-2 * math.pi)) * eps.to(F32))
    ang = w * n / nfft
    return (y * torch.complex(torch.cos(ang), torch.sin(ang))).to(CF32)


def cfo_estimate_cp(y: torch.Tensor, spec: OfdmSpec, margin: int | None = None) -> torch.Tensor:
    """Fractional CFO from the CP correlation over all symbols of y
    [S*(N+CP)]. Only CP positions >= `margin` (default cp/2) enter: the CP
    head carries the previous symbol's delay spread and the receiver's early
    timing bias."""
    m0 = spec.cp // 2 if margin is None else int(margin)
    l = sym_len(spec)
    s = y.shape[-1] // l
    sym = y[: s * l].reshape(s, l)
    c = torch.sum(sym[:, m0:spec.cp] * torch.conj(sym[:, spec.nfft + m0: spec.nfft + spec.cp]))
    return -torch.angle(c) / (2 * math.pi)


def ofdm_fft(spec: OfdmSpec, y: torch.Tensor) -> torch.Tensor:
    """[S*(N+CP)] aligned samples -> active-bin symbols [S, n_active]."""
    l = sym_len(spec)
    s = y.shape[-1] // l
    sym = y[: s * l].reshape(s, l)[:, spec.cp:]
    grid = torch.fft.fft(sym, dim=-1) / float(np.float32(np.sqrt(spec.nfft)))
    return grid[:, _active(spec, y.device)]


def ls_channel_estimate(rx_pilot: torch.Tensor, tx_pilot: torch.Tensor) -> torch.Tensor:
    """One-tap LS estimate H = Y/X per active bin."""
    return (rx_pilot / (tx_pilot + 1e-12)).to(CF32)


def ofdm_demod(spec: OfdmSpec, y: torch.Tensor, tx_pilot: torch.Tensor,
               cpe: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Demodulate aligned samples whose first symbol is the known pilot.

    y: [(1+S)*(N+CP)] time samples (pilot + S data symbols), CFO removed.
    Returns (sym_idx [S, n_active] int32, soft [S, n_active] complex64).
    `cpe` adds a decision-directed common-phase pass: one slice and one LS
    complex gain per symbol.
    """
    f = ofdm_fft(spec, y)
    h = ls_channel_estimate(f[0], tx_pilot)
    soft = (f[1:] / (h + 1e-12)).to(CF32)
    if cpe:
        pts = torch.as_tensor(qam_constellation(spec.order), device=y.device)
        s_hat = pts[qam_slice(soft, spec.order).to(torch.int64)]
        num = torch.sum(soft * torch.conj(s_hat), dim=-1, keepdim=True)
        den = torch.sum(torch.abs(s_hat) ** 2, dim=-1, keepdim=True) + 1e-12
        g = num / den
        soft = (soft * torch.conj(g) / (torch.abs(g) + 1e-12)).to(CF32)
    return qam_slice(soft, spec.order), soft


def ofdm_rx(spec: OfdmSpec, y: torch.Tensor, preamble_len: int, tx_pilot: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Full receive: S&C timing -> CFO (preamble P + CP refine) -> demod.

    y: raw capture holding [garbage][preamble][pilot][data...]. Returns
    (idx, soft, info) with the estimated start and CFO. The start pick is
    data-dependent, so this function runs on the host's side (it reads the
    start and the CFO back); callers with a known start use the pieces.
    """
    p, m = schmidl_cox_metric(y, spec.nfft)
    start = int(coarse_start(m, spec.cp))
    eps = float(cfo_from_preamble_p(p[start], spec.nfft))
    # slice a quarter-CP early: a late FFT window leaks into the next symbol,
    # an early one only circular-shifts within the CP guard
    guard = spec.cp // 4
    frame = y[start + preamble_len - guard:]
    y_c = cfo_correct(frame, eps, spec.nfft)
    eps2 = float(cfo_estimate_cp(y_c, spec))
    y_c = cfo_correct(y_c, eps2, spec.nfft)
    idx, soft = ofdm_demod(spec, y_c, tx_pilot)
    return idx, soft, {"start": start, "cfo": eps + eps2}
