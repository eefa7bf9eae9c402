"""Complex-taps fused FSK front end, kernel K3 (counterpart of
``srcdsp_tpu/kernels/fsk_ctaps.py``): the mix folded into the filter.

    y[J] = sum_a h[a] x[n_J - a] e^{j theta(n_J - a)}
         = e^{j theta(n_J)} * sum_a (h[a] e^{-j a dtheta}) x[n_J - a]

The tuning becomes per-channel complex taps g_c = h e^{-j a dth_c}, built on
the host in float64 exactly as the JAX make_fsk_ctaps_kernel does, and the
per-output phasor is never applied: the discriminator uses only phase
differences, so the phasor adds the constant decim*dtheta per output step,
restored as

    d[J] = wrap(atan2(y[J] conj(y[J-1]))/2pi + decim*dword/2^32)

No phase words exist at run time, so chunked streaming needs only the input
overlap and the per-call seam (output 0 of each call has d = 0, no delta).
Outputs and layouts are K2's (``kernels/fsk_fused.py``).

The CUDA kernel is ``csrc/fsk.cu`` (``srcdsp_fsk_ctaps``); `fsk_ctaps_plain`
is the plain PyTorch version the wrapper runs for CPU tensors.

bf16 ingest (``in_dtype=torch.bfloat16``): x ships as bf16, each sample is
converted to f32 once and everything after is f32. The taps stay f32, where
the JAX variant rounds its packed taps to bf16 too (a constraint of its
matrix-unit lowering, not of the method), so the port is held to the
reference's contract for this variant rather than to its bits: decisions
equal and soft values within 5e-2 of the f32 path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.fsk_fused import (
    PAD, demod_tail, discriminate_call, om_partials, to_class_major)
from srcdsp_tpu_torch.kernels.mixfir import (
    LANE, _round_up, check_in_dtype, check_planes, cuda_or_cpu)
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.ops.nco import TWO_PI, _INV_SCALE
from srcdsp_tpu_torch.types import F32

__all__ = ["ctaps_host", "make_fsk_ctaps_kernel", "fsk_demod_ctaps", "FskCtapsStream"]


def ctaps_host(taps, dwords, decim: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-channel complex taps and mix deltas, host-side, as the JAX
    make_fsk_ctaps_kernel makes them: (gr [C, T] f32, gi [C, T] f32, deltas [C] f32)."""
    taps = np.asarray(taps, np.float64)
    dwords = np.asarray(dwords, np.uint32)
    num_channels = int(dwords.shape[0])
    a_idx = np.arange(taps.shape[-1])
    gr, gi = [], []
    deltas = np.zeros(num_channels, np.float32)
    for c in range(num_channels):
        dth = TWO_PI * (np.uint32(dwords[c]) * _INV_SCALE)
        g = taps * np.exp(-1j * dth * a_idx)
        gr.append(g.real.astype(np.float32))
        gi.append(g.imag.astype(np.float32))
        # decim*dword mod 2^32 -> cycles in [0, 1)
        deltas[c] = np.float32((decim * int(dwords[c])) % (1 << 32)) * np.float32(_INV_SCALE)
    return np.stack(gr), np.stack(gi), deltas


def ctaps_fir_rows(x: torch.Tensor, gr: torch.Tensor, gi: torch.Tensor, decim: int,
                   hist: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain complex FIR + decimate per channel: x [C, 2, hist+N] (f32, or
    bf16 converted first), g [C, T] -> yr, yi [C, N/decim] f32 with
    y[J] = sum_a g[a] x[J*decim + hist - a]."""
    pin_f32(x)
    c, _, _ = x.shape
    t = gr.shape[-1]
    v = x[..., hist - (t - 1):].float().reshape(1, 2 * c, -1)
    hr, hi = gr.flip(-1), gi.flip(-1)
    # per channel: (yr, yi) = [[gr, -gi], [gi, gr]] * (xr, xi)
    w = torch.stack([torch.stack([hr, -hi], 1), torch.stack([hi, hr], 1)], 1)  # [C,2,2,T]
    y = F.conv1d(v, w.reshape(2 * c, 2, t), stride=decim, groups=c).reshape(c, 2, -1)
    return y[:, 0], y[:, 1]


def fsk_ctaps_plain(x: torch.Tensor, gr: torch.Tensor, gi: torch.Tensor,
                    deltas: torch.Tensor, decim: int, out_tile: int, hist: int, sps: int,
                    class_major: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: x [C, 2, HK+N] -> (d [C, NT, OT], st [C, NT, PAD])."""
    c = x.shape[0]
    yr, yi = ctaps_fir_rows(x, gr, gi, decim, hist)
    d = discriminate_call(yr, yi)
    d[:, 1:] += deltas[:, None]          # the seam sample stays 0
    d = d - (d > 0.5).to(F32)
    st = om_partials(d, sps, out_tile)
    d = d.reshape(c, -1, out_tile)
    return (to_class_major(d, sps) if class_major else d), st


def make_fsk_ctaps_kernel(taps, dwords, decim: int, sps: int, out_tile: int = 512,
                          b_rows: int = 32, class_major: bool = False,
                          in_dtype: torch.dtype = torch.float32, device=None):
    """Build K3 for FIXED per-channel tuning words `dwords` (u32, one per
    channel). Returns (fn, hist) with fn: (x [C, 2, HK+N] of `in_dtype`,
    float32 or bfloat16) -> (d [C, NT, OT], st [C, NT, 128]) f32; no run-time
    phase words.

    The TPU version's block_cols, precision, pipelined and interpret options
    shape only the Pallas lowering and have no counterpart here.
    """
    if out_tile % sps != 0:
        raise ValueError(f"out_tile {out_tile} % sps {sps} != 0")
    bf16 = check_in_dtype(in_dtype)
    counter = "fsk_ctaps_bf16" if bf16 else "fsk_ctaps"
    device = resolve(device)
    gr_np, gi_np, deltas_np = ctaps_host(taps, dwords, decim)
    num_channels, t = gr_np.shape
    hist = _round_up(t - 1, LANE)
    block = b_rows * out_tile * decim
    gr = torch.as_tensor(gr_np, device=device).contiguous()
    gi = torch.as_tensor(gi_np, device=device).contiguous()
    deltas = torch.as_tensor(deltas_np, device=device).contiguous()

    def fn(x):
        n = check_planes(x, num_channels, hist, block, in_dtype)
        if x.device != gr.device:
            raise ValueError(f"x on {x.device}, kernel built for {gr.device}")
        if not cuda_or_cpu(x):
            return fsk_ctaps_plain(x, gr, gi, deltas, decim, out_tile, hist, sps,
                                   class_major)
        lib = _build.load()
        nt = n // (out_tile * decim)
        d = torch.empty((num_channels, nt, out_tile), dtype=F32, device=x.device)
        st = torch.empty((num_channels, nt, PAD), dtype=F32, device=x.device)
        rc = lib.srcdsp_fsk_ctaps(x.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                                  deltas.data_ptr(), d.data_ptr(), st.data_ptr(),
                                  num_channels, x.shape[-1], nt, out_tile, decim, t, hist,
                                  sps, int(class_major), int(bf16),
                                  _build.stream_handle(x))
        _build.check(rc, counter)
        _build.LAUNCHES[counter] += 1
        return d, st

    return fn, hist


def fsk_demod_ctaps(fn, hist: int, out_tile: int, x_planes: torch.Tensor, sps: int,
                    state=None, class_major: bool = False):
    """K3 + the shared tail (tau + symbol pick).

    x_planes: [C, 2, HK+N]; state: (acc_r [C,1], acc_i [C,1]) or None.
    Returns (state, (bits [C, Nsym] int32, soft [C, Nsym] f32)).
    """
    dd, st = fn(x_planes)
    return demod_tail(dd, st, sps, out_tile, state, class_major)


class FskCtapsStream:
    """Stream class for the complex-taps serving path: keeps the history
    prefix and the demod accumulators, so callers feed raw [C, 2, N] plane
    chunks (N a multiple of b_rows*out_tile*decim) and receive bits."""

    def __init__(self, taps, dwords, decim: int, sps: int, num_channels: int,
                 out_tile: int = 512, b_rows: int = 32, class_major: bool = True,
                 device=None):
        device = resolve(device)
        self.fn, self.hist = make_fsk_ctaps_kernel(
            taps, dwords, decim, sps, out_tile=out_tile, b_rows=b_rows,
            class_major=class_major, device=device)
        self.out_tile = out_tile
        self.sps = sps
        self.class_major = class_major
        self.block_in = b_rows * out_tile * decim
        self._hist = torch.zeros((num_channels, 2, self.hist), dtype=F32, device=device)
        self._state = None

    def process(self, x_chunk: torch.Tensor):
        """x_chunk: [C, 2, N] raw planes -> (bits, soft) for this chunk."""
        xin = torch.cat([self._hist, x_chunk], dim=-1)
        self._state, out = fsk_demod_ctaps(
            self.fn, self.hist, self.out_tile, xin, self.sps,
            state=self._state, class_major=self.class_major)
        self._hist = xin[..., xin.shape[-1] - self.hist:].contiguous()
        return out
