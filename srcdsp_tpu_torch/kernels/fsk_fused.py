"""Fully fused FSK front end, kernel K2 (counterpart of
``srcdsp_tpu/kernels/fsk_fused.py``).

One launch per block does the whole per-sample work of the config-4 chain:
NCO mix -> FIR + decimate -> frequency discriminator -> O&M timing partial
sums. Only the per-block scalar math (tau from the summed accumulator, the
symbol pick) remains outside, in `demod_tail`.

Outputs, as the JAX kernel's: d [C, NT, OT] (cycles/sample) and
st [C, NT, 128] (col 0 = the row's sum(d^2 * cos tone), col 1 = the -sin
counterpart, the rest zeros). Each call starts from rest: output 0 of each
channel has d = 0 (the one-sample seam per call). class_major=True permutes
each row's lanes to offset-class-major order, lane o*(OT/sps)+s = sample
s*sps+o, so the symbol pick reads contiguous lanes.

The CUDA kernel is ``csrc/fsk.cu`` (``srcdsp_fsk_fused``); `fsk_fused_plain`
is the plain PyTorch version the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import (
    LANE, _round_up, check_planes, cuda_or_cpu, mix_fir_plain)
from srcdsp_tpu_torch.ops.nco import TWO_PI, word_tensor
from srcdsp_tpu_torch.types import F32

PAD = 128  # extra output columns (2 used for partial sums)


def _words_i32(words, c: int, device) -> torch.Tensor:
    """u32 words as an int32 tensor [C] with the same bits, for the kernel."""
    w = word_tensor(words).reshape(-1).expand(c)
    return (w - ((w >> 31) << 32)).to(torch.int32).to(device).contiguous()


def discriminate_call(yr: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """d [C, K] of one call's filtered planes [C, K]: atan2 of
    y[J]*conj(y[J-1]) / 2pi, with output 0 at rest (d = 0, the per-call seam)."""
    pr = torch.nn.functional.pad(yr[:, :-1], (1, 0))
    pi = torch.nn.functional.pad(yi[:, :-1], (1, 0))
    zr = yr * pr + yi * pi
    zi = yi * pr - yr * pi
    d = torch.atan2(zi, zr) * np.float32(1.0 / TWO_PI)
    d[:, 0] = 0.0
    return d


def om_partials(d: torch.Tensor, sps: int, out_tile: int) -> torch.Tensor:
    """st [C, NT, PAD] from d [C, K]: per-row O&M sums against the tone of
    the call-local output index mod sps."""
    c, k = d.shape
    g = torch.arange(k, dtype=torch.int64, device=d.device) % sps
    ang = g.to(F32) * np.float32(TWO_PI / sps)
    met = (d * d).reshape(c, -1, out_tile)
    st = torch.zeros((c, met.shape[1], PAD), dtype=F32, device=d.device)
    st[:, :, 0] = torch.sum(met * torch.cos(ang).reshape(-1, out_tile), dim=-1)
    st[:, :, 1] = torch.sum(met * (-torch.sin(ang)).reshape(-1, out_tile), dim=-1)
    return st


def to_class_major(d: torch.Tensor, sps: int) -> torch.Tensor:
    """[C, NT, OT] rows -> lanes permuted to (i % sps)*(OT/sps) + i//sps."""
    c, nt, ot = d.shape
    return d.reshape(c, nt, ot // sps, sps).transpose(-1, -2).reshape(c, nt, ot)


def fsk_fused_plain(words0, dwords, x: torch.Tensor, taps: torch.Tensor, decim: int,
                    out_tile: int, hist: int, sps: int, class_major: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: x [C, 2, HK+N] -> (d [C, NT, OT], st [C, NT, PAD])."""
    yr, yi = mix_fir_plain(words0, dwords, x, taps, decim, out_tile, hist)
    c = x.shape[0]
    d = discriminate_call(yr.reshape(c, -1), yi.reshape(c, -1))
    st = om_partials(d, sps, out_tile)
    d = d.reshape(c, -1, out_tile)
    return (to_class_major(d, sps) if class_major else d), st


def make_fsk_mc_kernel(taps, decim: int, num_channels: int, sps: int,
                       out_tile: int = 512, b_rows: int = 8,
                       class_major: bool = False, device=None):
    """Build K2. Returns (fn, hist) with
    fn: (words0 [C], dwords [C], x [C, 2, HK+N]) -> (d [C, NT, OT], st [C, NT, 128]).

    Words are u32 values, or int32 holding the same bits (the JAX fn's
    ``i32[C, 1]``). The TPU version's block_cols, precision, pipelined and
    interpret options shape only the Pallas lowering and have no counterpart.
    """
    taps = np.asarray(taps, np.float32)
    if out_tile % sps != 0:
        raise ValueError(f"out_tile {out_tile} % sps {sps} != 0")
    t = taps.shape[-1]
    hist = _round_up(t - 1, LANE)
    block = b_rows * out_tile * decim
    taps_t = torch.as_tensor(taps, device=resolve(device)).contiguous()

    def fn(words0, dwords, x):
        n = check_planes(x, num_channels, hist, block)
        if x.device != taps_t.device:
            raise ValueError(f"x on {x.device}, kernel built for {taps_t.device}")
        if not cuda_or_cpu(x):
            return fsk_fused_plain(words0, dwords, x, taps_t, decim, out_tile, hist, sps,
                                   class_major)
        lib = _build.load()
        nt = n // (out_tile * decim)
        w0 = _words_i32(words0, num_channels, x.device)
        dw = _words_i32(dwords, num_channels, x.device)
        d = torch.empty((num_channels, nt, out_tile), dtype=F32, device=x.device)
        st = torch.empty((num_channels, nt, PAD), dtype=F32, device=x.device)
        rc = lib.srcdsp_fsk_fused(x.data_ptr(), w0.data_ptr(), dw.data_ptr(),
                                  taps_t.data_ptr(), d.data_ptr(), st.data_ptr(),
                                  num_channels, x.shape[-1], nt, out_tile, decim, t, hist,
                                  sps, int(class_major), _build.stream_handle(x))
        _build.check(rc, "fsk_fused")
        _build.LAUNCHES["fsk_fused"] += 1
        return d, st

    return fn, hist


def fsk_demod_fused(fn, hist: int, out_tile: int, words0, dwords, x_planes, sps: int,
                    state=None, class_major: bool = False):
    """K2 + the tail (tau + symbol pick).

    x_planes: [C, 2, HK+N]; state: (acc_r [C,1], acc_i [C,1]) or None.
    Returns (state, (bits [C, Nsym] int32, soft [C, Nsym] f32)).
    """
    dd, st = fn(words0, dwords, x_planes)
    return demod_tail(dd, st, sps, out_tile, state, class_major)


def demod_tail(dd: torch.Tensor, st: torch.Tensor, sps: int, out_tile: int, state=None,
               class_major: bool = False):
    """The tail shared by the fused-kernel wrappers: O&M tau from the
    in-kernel partial sums, then the nearest-offset symbol pick."""
    from srcdsp_tpu_torch.chains.fsk_planes import pick_symbols

    cch = dd.shape[0]
    rs_c = torch.sum(st[:, :, 0], dim=-1, keepdim=True)
    rs_s = torch.sum(st[:, :, 1], dim=-1, keepdim=True)
    if state is None:
        z = torch.zeros((cch, 1), dtype=F32, device=dd.device)
        state = (z, z)
    acc_r = np.float32(0.5) * state[0] + rs_c
    acc_i = np.float32(0.5) * state[1] + rs_s
    tau = torch.remainder(np.float32(-sps / TWO_PI) * torch.atan2(acc_i, acc_r), sps)
    if class_major:
        # lane block o of every row holds that row's samples at offset o
        off = torch.remainder(torch.round(tau), sps).to(torch.int64)[:, 0]   # [C]
        spr = out_tile // sps
        blocks = dd.reshape(cch, dd.shape[1], sps, spr)
        soft = blocks[torch.arange(cch, device=dd.device), :, off].reshape(cch, -1)
    else:
        soft = pick_symbols(dd.reshape(cch, -1), tau, sps)
    bits = (soft > 0).to(torch.int32)
    return (acc_r, acc_i), (bits, soft)
