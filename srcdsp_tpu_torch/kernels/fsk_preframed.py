"""Producer pre-framed complex-taps FSK front end, kernel K7 (counterpart of
``srcdsp_tpu/kernels/fsk_preframed.py``): K3 (``kernels/fsk_ctaps``) over
[C, NT, span] frames from `frame_planes` or the framer K6
(``kernels/mixfir_preframed``), so the kernel does no window work.

Outputs are bit-identical to K3 on the same stream: the CUDA kernels share one
body (``csrc/fsk.cu``, its ownership mirrored by ``kernels/fsk_fused.fsk_*``)
and differ only in the window source, which reads each sample from the frame
row `deframe` takes it from (``kernels/mixfir_preframed.frames_pick``); the
plain version rebuilds the stream from the frames and runs K3's plain
version. The TPU kernel carries each row's last filtered sample to the next
grid step; the CUDA kernel computes the y[J-1] of a tile's first output once
more, from the same window, in the same order. bf16 ingest is as in K3:
f32 taps, decisions equal and soft values within 5e-2 of the f32 path, where
the JAX variant also rounds its taps to bf16.
"""

from __future__ import annotations

import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.fsk_ctaps import ctaps_host, fsk_ctaps_plain
from srcdsp_tpu_torch.kernels.fsk_fused import PAD, demod_tail
from srcdsp_tpu_torch.kernels.mixfir import LANE, _round_up, check_in_dtype, cuda_or_cpu
from srcdsp_tpu_torch.kernels.mixfir_preframed import check_frames, deframe
from srcdsp_tpu_torch.types import F32

__all__ = ["make_fsk_preframed_kernel", "fsk_demod_preframed", "fsk_preframed_plain"]


def fsk_preframed_plain(xr_f: torch.Tensor, xi_f: torch.Tensor, gr: torch.Tensor,
                        gi: torch.Tensor, deltas: torch.Tensor, decim: int, out_tile: int,
                        hist: int, sps: int, class_major: bool
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K7: frames [C, NT, span] -> (d [C, NT, OT], st [C, NT, PAD])."""
    stride = out_tile * decim
    x = torch.stack([deframe(xr_f, stride), deframe(xi_f, stride)], dim=1)
    return fsk_ctaps_plain(x, gr, gi, deltas, decim, out_tile, hist, sps, class_major)


def make_fsk_preframed_kernel(taps, dwords, decim: int, sps: int, out_tile: int = 512,
                              b_rows: int = 32, class_major: bool = False,
                              in_dtype: torch.dtype = torch.float32, device=None):
    """K7, the pre-framed form of make_fsk_ctaps_kernel. Returns
    (fn, hist, stride, span) with fn(xr_f, xi_f [C, NT, span] of `in_dtype`) ->
    (d [C, NT, OT], st [C, NT, 128]) f32."""
    if out_tile % sps != 0:
        raise ValueError(f"out_tile {out_tile} % sps {sps} != 0")
    bf16 = check_in_dtype(in_dtype)
    counter = "fsk_preframed_bf16" if bf16 else "fsk_preframed"
    device = resolve(device)
    gr_np, gi_np, deltas_np = ctaps_host(taps, dwords, decim)
    num_channels, t = gr_np.shape
    hist = _round_up(t - 1, LANE)
    stride = out_tile * decim
    span = stride + hist
    gr = torch.as_tensor(gr_np, device=device).contiguous()
    gi = torch.as_tensor(gi_np, device=device).contiguous()
    deltas = torch.as_tensor(deltas_np, device=device).contiguous()

    def fn(xr_f, xi_f):
        nt = check_frames(xr_f, xi_f, (num_channels,), span, b_rows, in_dtype)
        if xr_f.device != gr.device:
            raise ValueError(f"frames on {xr_f.device}, kernel built for {gr.device}")
        if not cuda_or_cpu(xr_f):
            return fsk_preframed_plain(xr_f, xi_f, gr, gi, deltas, decim, out_tile, hist,
                                       sps, class_major)
        lib = _build.load()
        d = torch.empty((num_channels, nt, out_tile), dtype=F32, device=xr_f.device)
        st = torch.empty((num_channels, nt, PAD), dtype=F32, device=xr_f.device)
        rc = lib.srcdsp_fsk_preframed(xr_f.data_ptr(), xi_f.data_ptr(), gr.data_ptr(),
                                      gi.data_ptr(), deltas.data_ptr(), d.data_ptr(),
                                      st.data_ptr(), num_channels, nt, span, out_tile,
                                      decim, t, hist, sps, int(class_major), int(bf16),
                                      _build.stream_handle(xr_f))
        _build.check(rc, counter)
        _build.LAUNCHES[counter] += 1
        return d, st

    return fn, hist, stride, span


def fsk_demod_preframed(fn, out_tile: int, xr_f: torch.Tensor, xi_f: torch.Tensor,
                        sps: int, state=None, class_major: bool = False):
    """K7 + the shared tail (tau + symbol pick). state: (acc_r [C,1],
    acc_i [C,1]) or None; returns (state, (bits [C, Nsym] int32, soft [C, Nsym]))."""
    dd, st = fn(xr_f, xi_f)
    return demod_tail(dd, st, sps, out_tile, state, class_major)
