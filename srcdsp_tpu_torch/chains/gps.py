"""GPS C/A code generation, acquisition and feedforward tracking
(counterpart of ``srcdsp_tpu/chains/gps.py``).

The C/A search is a 2-D search (code phase x Doppler): every Doppler
hypothesis derotates the same millisecond blocks, and all code phases at
once are one product against the all-shifts matrix of the sampled replica
(N = 1023 * sps). The port runs each search as ONE real float32 matmul,
[2 * D * NB, N] @ [N, N] (real and imaginary rows stacked), with TF32 off
(`ops.fir.pin_f32`): the reference's products are complex64 (`acquire_ca`)
or DEFAULT-precision planes (`acquire_ca_planes`, one bf16 pass on a TPU);
float32 is the accurate side of both. The median of the metric is the
midpoint of the two middle values, as `jnp.median` takes it (`torch.median`
returns the lower one); the fine Doppler wraps with `torch.remainder`, the
floor-mod of `jnp.mod`.

`make_gps_acq` builds the shifts matrix on the device from the replica by a
gather (column p = the replica delayed p samples, numpy's `roll`); the
tracker's code-Doppler replicas stay host-built, as in the reference.

Code generator: G1 = x^10 + x^3 + 1, G2 = x^10 + x^9 + x^8 + x^6 + x^3 + x^2
+ 1 with the per-PRN two-tap phase selector; chips +1/-1, period 1023.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on, resolve, to_host
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32, F32

__all__ = ["ca_code", "sample_ca", "GpsAcq", "make_gps_acq", "acquire_ca", "acquire_ca_planes",
           "fine_acquire", "track_ca", "nav_preamble_detect", "NAV_PREAMBLE", "median_midpoint"]

_G2_TAPS = {
    1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9), 6: (2, 10),
    7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3), 11: (3, 4),
    12: (5, 6), 13: (6, 7), 14: (7, 8), 15: (8, 9), 16: (9, 10),
    17: (1, 4), 18: (2, 5), 19: (3, 6), 20: (4, 7), 21: (5, 8),
    22: (6, 9), 23: (1, 3), 24: (4, 6), 25: (5, 7), 26: (6, 8),
    27: (7, 9), 28: (8, 10), 29: (1, 6), 30: (2, 7), 31: (3, 8),
    32: (4, 9),
}
_TWO_PI = float(np.float32(2.0 * np.pi))    # 2 pi as a float32 constant


def ca_code(prn: int) -> np.ndarray:
    """C/A code for PRN 1..32: [1023] chips in {+1.0, -1.0} (bit 0 -> +1)."""
    if prn not in _G2_TAPS:
        raise ValueError(f"PRN must be 1..32, got {prn}")
    t1, t2 = _G2_TAPS[prn]
    g1 = [1] * 10
    g2 = [1] * 10
    out = []
    for _ in range(1023):
        out.append(g1[9] ^ (g2[t1 - 1] ^ g2[t2 - 1]))
        f1 = g1[2] ^ g1[9]
        f2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = [f1] + g1[:9]
        g2 = [f2] + g2[:9]
    return (1.0 - 2.0 * np.asarray(out, np.float32)).astype(np.float32)


def sample_ca(code: np.ndarray, sps: int) -> np.ndarray:
    """[1023] chips -> [1023 * sps] replica (rectangular chips)."""
    return np.repeat(np.asarray(code, np.float32), sps)


class GpsAcq(NamedTuple):
    shifts_t: torch.Tensor  # [N, N] float32, column p = replica delayed p samples
    n: int                  # 1023 * sps
    sps: int
    prn: int


def make_gps_acq(prn: int, sps: int = 2, device=None) -> GpsAcq:
    """The all-shifts acquisition operator of one PRN on `device` (the card
    unless it says otherwise): shifts_t[i, p] = replica[(i - p) mod N]."""
    cs = torch.as_tensor(sample_ca(ca_code(prn), sps), device=resolve(device))
    n = cs.shape[0]
    i = torch.arange(n, device=cs.device)
    return GpsAcq(shifts_t=cs[torch.remainder(i[:, None] - i[None, :], n)], n=n, sps=sps,
                  prn=prn)


def median_midpoint(t: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the mean of the two middle ones for an even
    count (`jnp.median`: (lo + hi) * 0.5)."""
    s = torch.sort(t.reshape(-1)).values
    k = s.shape[0]
    return (s[(k - 1) // 2] + s[k // 2]) * 0.5


def _search(acq: GpsAcq, yr: torch.Tensor, yi: torch.Tensor, dop: torch.Tensor) -> dict:
    """Derotated planes [D, NB, N] -> the search result (one matmul)."""
    d, nb, n = yr.shape
    sh = acq.shifts_t.to(yr.device)
    pin_f32(yr)
    z = torch.cat([yr.reshape(d * nb, n), yi.reshape(d * nb, n)]) @ sh
    zr, zi = z[: d * nb].reshape(d, nb, n), z[d * nb:].reshape(d, nb, n)
    metric = (zr * zr + zi * zi).sum(dim=1)
    flat = torch.argmax(metric)
    d_idx, p_idx = flat // n, flat % n
    return {"metric": metric, "d_idx": d_idx, "p_idx": p_idx,
            "ratio": metric[d_idx, p_idx] / median_midpoint(metric), "doppler": dop[d_idx],
            "corr_planes": (zr[d_idx, :, p_idx], zi[d_idx, :, p_idx])}


def acquire_ca(acq: GpsAcq, x, dopplers) -> dict:
    """2-D C/A search, noncoherent over milliseconds. x: [NB * N] complex
    baseband (a numpy array goes to the operator's device; a tensor stays
    where it is). Returns {metric [D, N], d_idx, p_idx, ratio (peak over the
    median), corr [NB] complex64 per-ms correlators at the peak, doppler}."""
    x = as_tensor_on(x, acq.shifts_t.device, CF32)
    n = acq.n
    nb = x.shape[-1] // n
    xb = x[: nb * n].reshape(nb, n)
    dop = torch.as_tensor(np.asarray(dopplers, np.float32), device=x.device)
    t = torch.arange(n, dtype=F32, device=x.device)
    ang = (-_TWO_PI * dop)[:, None] * t[None, :]
    y = xb[None, :, :] * torch.polar(torch.ones_like(ang), ang)[:, None, :]
    res = _search(acq, y.real, y.imag, dop)
    zr, zi = res.pop("corr_planes")
    res["corr"] = torch.complex(zr, zi)
    return res


def acquire_ca_planes(acq: GpsAcq, xr, xi, dopplers) -> dict:
    """Plane-form search: xr, xi [NB * N] float32 planes (numpy goes to the
    operator's device); the same result with the correlators as a plane pair
    under "corr_planes"."""
    xr = as_tensor_on(xr, acq.shifts_t.device, F32)
    xi = as_tensor_on(xi, xr.device, F32)
    n = acq.n
    nb = xr.shape[-1] // n
    xbr = xr[: nb * n].reshape(1, nb, n)
    xbi = xi[: nb * n].reshape(1, nb, n)
    dop = torch.as_tensor(np.asarray(dopplers, np.float32), device=xr.device)
    t = torch.arange(n, dtype=F32, device=xr.device)
    ang = (_TWO_PI * dop)[:, None] * t[None, :]
    c = torch.cos(ang)[:, None, :]
    s = torch.sin(ang)[:, None, :]
    return _search(acq, xbr * c + xbi * s, xbi * c - xbr * s, dop)


def fine_acquire(acq: GpsAcq, res: dict) -> dict:
    """Refine the coarse cell: sub-sample code phase by a parabola through
    the metric row, fine Doppler from the phase slope of the squared per-ms
    correlators (nav-bit flips cancel), the hypothesis phase subtracted and
    the residual wrapped to (-pi/2, pi/2]."""
    n = acq.n
    m = res["metric"][res["d_idx"]]
    p = res["p_idx"]
    ym, y0, yp = m[torch.remainder(p - 1, n)], m[p], m[torch.remainder(p + 1, n)]
    denom = ym - 2 * y0 + yp
    frac = torch.where(torch.abs(denom) > 1e-20, 0.5 * (ym - yp) / denom, torch.zeros_like(denom))
    if "corr" in res:
        z = res["corr"]
    else:
        z = torch.complex(*res["corr_planes"])
    prod = (z[1:] * torch.conj(z[:-1])) ** 2
    ph = torch.angle(torch.sum(prod)) / 2.0
    hyp = 2.0 * np.pi * res["doppler"] * n
    derr = torch.remainder(ph - hyp + np.pi / 2, np.pi) - np.pi / 2
    return {"code_phase": p.to(F32) + frac, "doppler": res["doppler"] + derr / (2 * np.pi * n)}


def track_ca(acq: GpsAcq, x, res: dict, fine: dict, nav_rate_ms: int = 20,
             code_doppler: float = 0.0) -> dict:
    """Feedforward tracking and nav-bit extraction: the fine-Doppler wipe and
    every millisecond's prompt correlator at once, the residual rotation out
    (squared-prompt slope, then a constant phase), bit sync by transition
    energy per residue, majority over nav_rate_ms blocks. x: [NB * N] complex
    (numpy goes to the operator's device). code_doppler: code drift in
    samples per block; its per-block rolled replicas are built on the host.
    Returns {prompt [NB] complex64, bits [NB // nav_rate_ms] int32,
    bit_phase, cn0_db_hz}; bits carry the BPSK polarity ambiguity."""
    x = as_tensor_on(x, acq.shifts_t.device, CF32)
    dev = x.device
    n = acq.n
    nb = x.shape[-1] // n
    xb = x[: nb * n].reshape(nb, n)
    t = torch.arange(n, dtype=F32, device=dev)
    blk = torch.arange(nb, dtype=F32, device=dev)[:, None]
    f = torch.as_tensor(fine["doppler"], dtype=F32, device=dev)
    ph = 2.0 * np.pi * f * (blk * n + t[None, :])
    rot = torch.complex(torch.cos(ph), -torch.sin(ph))
    cs = sample_ca(ca_code(acq.prn), acq.sps)
    p0 = int(res["p_idx"])
    if code_doppler:
        shifts = np.round(np.arange(nb) * code_doppler).astype(int)
        rep = np.stack([np.roll(cs, p0 + int(s)) for s in shifts])
    else:
        rep = np.roll(cs, p0)[None, :]
    z = torch.sum(xb * rot * torch.as_tensor(rep, device=dev), dim=-1)
    resid = torch.angle(torch.sum((z[1:] * torch.conj(z[:-1])) ** 2)) / 2.0
    k = torch.arange(nb, dtype=F32, device=dev)
    zc = z * torch.polar(torch.ones_like(k), -resid * k)
    phi0 = torch.angle(torch.sum(zc * zc)) / 2.0
    zc = zc * torch.polar(torch.ones_like(phi0), -phi0)
    s = torch.real(zc)
    diffs = torch.abs(s[1:] - s[:-1])
    pad = (-diffs.shape[0]) % nav_rate_ms
    dpad = torch.cat([diffs, torch.zeros(pad, dtype=diffs.dtype, device=dev)])
    best = int(torch.argmax(dpad.reshape(-1, nav_rate_ms).sum(dim=0)))
    start = (best + 1) % nav_rate_ms
    sb = s[start: start + ((nb - start) // nav_rate_ms) * nav_rate_ms]
    bits = (sb.reshape(-1, nav_rate_ms).sum(dim=-1) < 0).to(torch.int32)
    pwr = torch.mean(torch.abs(zc) ** 2)
    nvar = torch.var(torch.imag(zc), correction=0)
    cn0 = 10.0 * torch.log10(torch.clamp(pwr / (2 * nvar + 1e-12), min=1e-9) * 1000.0)
    return {"prompt": zc, "bits": bits, "bit_phase": start, "cn0_db_hz": cn0}


NAV_PREAMBLE = np.asarray([1, 0, 0, 0, 1, 0, 1, 1], np.int32)


def nav_preamble_detect(bits) -> list[tuple[int, int]]:
    """TLM preamble (10001011) in a nav bit stream (any device), either
    polarity: [(index, polarity)], polarity +1 as-is, -1 inverted."""
    b = to_host(bits).astype(np.int32).reshape(-1)
    if b.size < 8:
        return []
    win = np.lib.stride_tricks.sliding_window_view(b, 8)
    hits = []
    for pol, pat in ((1, NAV_PREAMBLE), (-1, 1 - NAV_PREAMBLE)):
        hits += [(int(i), pol) for i in np.flatnonzero((win == pat).all(axis=1))]
    return sorted(hits)
