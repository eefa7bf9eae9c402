"""Feedforward (open-loop) block-parallel tracking (counterpart of
``srcdsp_tpu/chains/feedforward.py``): the serving-rate alternative to the
per-symbol closed loops of ``chains.tracking_planes``.

The classic estimate-then-correct receiver: every block's parameters are
estimated at once, the per-symbol timing and phase trajectories are
interpolated, and the correction is one batched pick and derotation:

    matched-filtered planes [C, K]
      -> per-block O&M timing DFT          (reshape + two reductions)
      -> unwrap tau across blocks          (one cumsum)
      -> per-symbol tau by linear interp   (shifted copies, static
                                            per-slot weights)
      -> fractional symbol pick            (one gather + lerp)
      -> per-block V&V phase, unwrap, per-symbol interp, derotate
      -> slice

The reference selects each pick from a bounded window with a one-hot
reduce and runs its prefix sums as a triangular matmul, because gathers and
cumsum were slow or missing on its TPU backend. Here the pick is one
``gather`` of the same sample pair (the one-hot reduce returns that sample
exactly) and the prefix sum is ``torch.cumsum``.

Limits (the standard open-loop ones): clock and phase quasi-static over one
`block`; the bounded forms need the unwrapped timing excursion of one call
within the window, |tau - min(tau)| < w - sps samples (w = window_syms*sps);
a net ppm offset needs the ragged forms, which relabel each block by an
integer symbol count and emit a validity mask (the
``tracking.compact_ragged`` contract).
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.ops.cpow import cpow
from srcdsp_tpu_torch.ops.nco import TWO_PI, _mod_f32
from srcdsp_tpu_torch.types import F32

__all__ = ["ff_psk_demod_planes", "ff_fsk_demod_planes", "ff_psk_demod_ragged",
           "ff_fsk_demod_ragged"]

# host-built constants, copied to each device once
_CONSTS: dict = {}


def _const(device, key: tuple, build) -> torch.Tensor:
    k = (str(device), *key)
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = torch.as_tensor(build(), device=device)
    return t


def _om_tone(device, block: int, sps: int) -> torch.Tensor:
    """[2, block] O&M tone cos / -sin(2*pi*(n mod sps)/sps), float32."""
    def build():
        n = np.arange(block)
        return np.stack([np.cos(TWO_PI * (n % sps) / sps),
                         -np.sin(TWO_PI * (n % sps) / sps)]).astype(np.float32)

    return _const(device, ("tone", block, sps), build)


def _om_tau(met: torch.Tensor, sps: int) -> torch.Tensor:
    """Per-block O&M timing of the metric planes [C, NB, block] -> tau [C, NB]
    in [0, sps)."""
    tone = _om_tone(met.device, met.shape[-1], sps)
    cr = torch.sum(met * tone[0], dim=-1)
    ci = torch.sum(met * tone[1], dim=-1)
    return _mod_f32(np.float32(-sps / TWO_PI) * torch.atan2(ci, cr), np.float32(sps))


def _unwrap_blocks(vals: torch.Tensor, period: float) -> torch.Tensor:
    """[C, NB] wrapped block estimates -> unwrapped (nearest-wrap
    continuation, the prefix sum as one cumsum)."""
    p = float(np.float32(period))
    d = vals[:, 1:] - vals[:, :-1]
    d = d - p * torch.round(d / p)
    cums = torch.cumsum(d, dim=-1)
    return torch.cat([vals[:, :1], vals[:, :1] + cums], dim=1)


def _lerp3(traj: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[C, NB] block-centre values and weights w [3, S] for the previous,
    this and the next centre (edges clamped) -> [C, NB, S]."""
    prev = torch.cat([traj[:, :1], traj[:, :-1]], dim=1)
    nxt = torch.cat([traj[:, 1:], traj[:, -1:]], dim=1)
    return prev[:, :, None] * w[0] + traj[:, :, None] * w[1] + nxt[:, :, None] * w[2]


def _weights(g: np.ndarray) -> np.ndarray:
    """Static lerp weights [3, S] (prev, cur, next) at block fractions g
    relative to the centre (float32, as the reference builds them)."""
    w_prev = np.where(g < 0, -g, 0.0).astype(np.float32)
    w_next = np.where(g > 0, g, 0.0).astype(np.float32)
    w_cur = (1.0 - w_prev - w_next).astype(np.float32)
    return np.stack([w_prev, w_cur, w_next])


def _interp_to_slots(traj: torch.Tensor, spb: int) -> torch.Tensor:
    """Per-block trajectory [C, NB] (values at block centres) -> per-symbol
    values [C, NB*spb] by exact linear interpolation: slot s sits at block
    fraction (s + 0.5)/spb, between centres (b-1, b) or (b, b+1)."""
    def build():
        return _weights((np.arange(spb, dtype=np.float32) + 0.5) / spb - 0.5)

    c, nb = traj.shape
    return _lerp3(traj, _const(traj.device, ("slots", spb), build)).reshape(c, nb * spb)


def _pick(y: torch.Tensor, start: torch.Tensor, frac: torch.Tensor, pad: int) -> torch.Tensor:
    """Linear pick between samples start and start + 1 of y [C, K] (zeros
    past the end, `pad` of them): start int64, frac float32, same shape."""
    c = y.shape[0]
    ypad = torch.cat([y, torch.zeros((c, pad), dtype=y.dtype, device=y.device)], dim=-1)
    s = start.reshape(c, -1)
    g = torch.gather(ypad, 1, torch.cat([s, s + 1], dim=-1)).reshape(c, 2, *start.shape[1:])
    return g[:, 0] * (1.0 - frac) + g[:, 1] * frac


def _bounded_picks(tau_u: torch.Tensor, sps: int, spb: int, w: int):
    """Per-symbol sample start and fraction of the bounded forms: tau on the
    nominal grid, rebased by a whole number of symbol periods so the pick
    offset lies in [0, w-1), then offset by each slot's nominal start."""
    base = np.float32(sps) * torch.floor(torch.min(tau_u, dim=-1, keepdim=True).values
                                         / np.float32(sps))
    tau_k = _interp_to_slots(tau_u, spb) - base
    j = torch.clamp(torch.floor(tau_k), 0.0, w - 2.0)
    frac = torch.clamp(tau_k - j, 0.0, 1.0)
    slot = torch.arange(tau_k.shape[-1], device=tau_k.device) * sps
    return slot + j.to(torch.int64), frac


def ff_fsk_demod_planes(d: torch.Tensor, sps: int, block: int = 512, window_syms: int = 4):
    """Open-loop tracked binary-FSK slicer on discriminator planes.

    The noncoherent sibling of `ff_psk_demod_planes`: the timing metric is
    the squared discriminator, there is no carrier stage, and the decision
    is the sign. d: [C, K] discriminator output (cycles/sample). Returns
    (bits [C, K//sps] int32, soft [C, K//sps], diag)."""
    c, k = d.shape
    if k % block or block % sps:
        raise ValueError(f"K={k} % block={block} or block % sps={sps}")
    nb = k // block
    spb = block // sps
    w = window_syms * sps
    tau_u = _unwrap_blocks(_om_tau((d * d).reshape(c, nb, block), sps), float(sps))
    start, frac = _bounded_picks(tau_u, sps, spb, w)
    soft = _pick(d, start, frac, w)
    bits = (soft > 0).to(torch.int32)
    return bits, soft, {"tau_blocks": tau_u}


def _vv_block_phase(sr, si, order: int, offset: float, maskf=None):
    """Per-block V&V carrier phase [C, NB] of symbols [C, NB, S] normalised
    per block (over the valid ones when `maskf` is given)."""
    if maskf is None:
        scale = torch.sqrt(torch.mean(sr * sr + si * si, dim=-1, keepdim=True) + 1e-12)
    else:
        cnt = torch.sum(maskf, dim=-1, keepdim=True) + np.float32(1e-6)
        pw = (sr * sr + si * si) * maskf
        scale = torch.sqrt(torch.sum(pw, dim=-1, keepdim=True) / cnt + 1e-12)
    pr, pi = cpow(sr / scale, si / scale, order)
    co = float(np.float32(np.cos(-TWO_PI * offset)))
    so = float(np.float32(np.sin(-TWO_PI * offset)))
    qr, qi = pr * co - pi * so, pr * so + pi * co
    if maskf is not None:
        qr, qi = qr * maskf, qi * maskf
    phi_b = torch.atan2(torch.sum(qi, dim=-1), torch.sum(qr, dim=-1)) / order
    return _unwrap_blocks(phi_b, float(TWO_PI / order))


def _derotate_slice(sr, si, phi, order: int, offset: float):
    """s * e^{-j phi}, then the nearest M-PSK index (int32)."""
    cp, sp = torch.cos(phi), torch.sin(phi)
    dr = sr * cp + si * sp
    di = si * cp - sr * sp
    idx = torch.round(torch.atan2(di, dr) * np.float32(order / TWO_PI) - np.float32(offset))
    return torch.remainder(idx.to(torch.int32), order), dr, di


def ff_psk_demod_planes(yr: torch.Tensor, yi: torch.Tensor, sps: int, order: int,
                        block: int = 512, offset: float = 0.0, window_syms: int = 4):
    """Open-loop tracked M-PSK demod of matched-filtered planes.

    yr/yi: [C, K] with K % block == 0, block % sps == 0. Returns
    (idx [C, K//sps] int32, (dr, di) derotated soft symbols, diag dict with
    the tau/phi block trajectories). `offset` is the constellation offset
    of chains.psk; `window_syms` sets the pick window w = window_syms*sps.
    """
    c, k = yr.shape
    if k % block or block % sps:
        raise ValueError(f"K={k} % block={block} or block % sps={sps}")
    nb = k // block
    spb = block // sps
    w = window_syms * sps
    tau_u = _unwrap_blocks(_om_tau((yr * yr + yi * yi).reshape(c, nb, block), sps), float(sps))
    start, frac = _bounded_picks(tau_u, sps, spb, w)
    sr, si = _pick(yr, start, frac, w), _pick(yi, start, frac, w)      # [C, K/sps]
    phi_u = _vv_block_phase(sr.reshape(c, nb, spb), si.reshape(c, nb, spb), order, offset)
    idx, dr, di = _derotate_slice(sr, si, _interp_to_slots(phi_u, spb), order, offset)
    return idx, (dr, di), {"tau_blocks": tau_u, "phi_blocks": phi_u}


# ---------------------------------------------------------------------------
# Ragged feedforward: unbounded net-ppm clocks. The whole unwrapped
# trajectory tau(t) is known up front, so the number of symbols each block
# holds (e_b) and the index of its first symbol
# (n_b = ceil((b*block - tau_edge_b)/sps)) are computed in advance; each
# block's picks are rebased to its own origin, and the output is a static
# capacity grid [C, NB, spb+extra] with a validity mask i < e_b.
# ---------------------------------------------------------------------------


def _interp_capacity(traj: torch.Tensor, spb_cap: int, sps: int, block: int) -> torch.Tensor:
    """[C, NB] block-centre values -> [C, NB, spb_cap] at capacity slot
    centres (block fraction g = (i+0.5)*sps/block - 0.5 clamped to
    [-0.5, 1.0]: slots past the block end reuse the next centre's value)."""
    def build():
        g = (np.arange(spb_cap, dtype=np.float64) + 0.5) * sps / block - 0.5
        return _weights(np.clip(g, -0.5, 1.0).astype(np.float32))

    return _lerp3(traj, _const(traj.device, ("cap", spb_cap, sps, block), build))


def _ragged_relabel(met: torch.Tensor, sps: int, block: int, spb_cap: int, w: int):
    """Shared core of the ragged demods: per-block O&M on the timing metric
    met [C, NB, block] -> unwrapped tau_u [C, NB], the symbol index at each
    block edge n_edge [C, NB+1] (int32), each slot's sample start in the
    padded stream and fraction [C, NB, spb_cap], and the validity mask."""
    c, nb, _ = met.shape
    k = nb * block
    dev = met.device
    tau_u = _unwrap_blocks(_om_tau(met, sps), float(sps))
    mid = 0.5 * (tau_u[:, :-1] + tau_u[:, 1:])
    if nb > 1:
        first = 1.5 * tau_u[:, :1] - 0.5 * tau_u[:, 1:2]
        last = 1.5 * tau_u[:, -1:] - 0.5 * tau_u[:, -2:-1]
    else:
        first = last = tau_u[:, :1]
    t_edge = torch.cat([first, mid, last], dim=1)
    bpos = torch.arange(nb + 1, device=dev).to(F32) * block
    n_edge = torch.ceil((bpos[None, :] - t_edge) / np.float32(sps)).to(torch.int32)
    e_b = n_edge[:, 1:] - n_edge[:, :-1]

    tau_cap = _interp_capacity(tau_u, spb_cap, sps, block)
    db = n_edge[:, :-1].to(F32) * np.float32(sps) - bpos[None, :-1]
    delta = db[:, :, None] + tau_cap
    j = torch.clamp(torch.floor(delta), 0.0, w - 2.0)
    frac = torch.clamp(delta - j, 0.0, 1.0)
    slot = torch.arange(spb_cap, device=dev)
    start = (torch.arange(nb, device=dev)[:, None] * block + slot[None, :] * sps)
    in_count = slot[None, None, :] < e_b[:, :, None]
    in_data = (start + w <= k)[None]
    return tau_u, n_edge, start + j.to(torch.int64), frac, in_count & in_data


def _ragged_shape(k: int, sps: int, block: int, capacity_extra: int, window_syms: int):
    if k % block or block % sps:
        raise ValueError(f"K={k} % block={block} or block % sps={sps}")
    spb_cap = block // sps + capacity_extra
    w = window_syms * sps
    lk = spb_cap * sps - block + w
    if lk > block:
        raise ValueError(f"lookahead {lk} > block {block}")
    return k // block, spb_cap, w


def ff_psk_demod_ragged(yr: torch.Tensor, yi: torch.Tensor, sps: int, order: int,
                        block: int = 512, offset: float = 0.0, window_syms: int = 4,
                        capacity_extra: int = 2):
    """Open-loop M-PSK demod under unbounded sustained clock offsets.

    yr/yi: [C, K] matched-filtered planes, K % block == 0, block % sps == 0.
    Returns (idx [C, NB*spb_cap] int32, (dr, di) soft, valid [C, NB*spb_cap]
    bool, diag). Feed (idx, valid) to tracking.compact_ragged: the emitted
    count per channel follows the actual symbol clock. capacity_extra must
    be >= ceil(block*|ppm|_max / sps) + 1.
    """
    c, k = yr.shape
    nb, spb_cap, w = _ragged_shape(k, sps, block, capacity_extra, window_syms)
    tau_u, n_edge, start, frac, valid = _ragged_relabel(
        (yr * yr + yi * yi).reshape(c, nb, block), sps, block, spb_cap, w)
    sr, si = _pick(yr, start, frac, block), _pick(yi, start, frac, block)   # [C, NB, cap]
    phi_u = _vv_block_phase(sr, si, order, offset, valid.to(F32))
    idx, dr, di = _derotate_slice(sr, si, _interp_capacity(phi_u, spb_cap, sps, block),
                                  order, offset)
    ns = nb * spb_cap
    diag = {"tau_blocks": tau_u, "phi_blocks": phi_u, "count": n_edge[:, -1] - n_edge[:, 0]}
    return (idx.reshape(c, ns), (dr.reshape(c, ns), di.reshape(c, ns)),
            valid.reshape(c, ns), diag)


def ff_fsk_demod_ragged(d: torch.Tensor, sps: int, block: int = 512, window_syms: int = 4,
                        capacity_extra: int = 2):
    """Open-loop binary-FSK slicer under unbounded sustained clock offsets:
    the noncoherent twin of `ff_psk_demod_ragged` (the timing metric is the
    squared discriminator, the decision the sign, no carrier stage).

    d: [C, K] discriminator planes. Returns (bits [C, NB*cap] int32, soft,
    valid, diag)."""
    c, k = d.shape
    nb, spb_cap, w = _ragged_shape(k, sps, block, capacity_extra, window_syms)
    tau_u, n_edge, start, frac, valid = _ragged_relabel(
        (d * d).reshape(c, nb, block), sps, block, spb_cap, w)
    soft = _pick(d, start, frac, block)
    bits = (soft > 0).to(torch.int32)
    ns = nb * spb_cap
    diag = {"tau_blocks": tau_u, "count": n_edge[:, -1] - n_edge[:, 0]}
    return bits.reshape(c, ns), soft.reshape(c, ns), valid.reshape(c, ns), diag
