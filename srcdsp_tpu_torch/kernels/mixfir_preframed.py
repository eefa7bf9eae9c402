"""Producer pre-framed complex-taps kernel K5 and the on-device framer K6
(counterpart of ``srcdsp_tpu/kernels/mixfir_preframed.py``).

A producer (the ingest framer ``io/framer.py``, `frame_planes` on the host, or
K6 on the card) ships [NT, span] frames: row J is the stream's samples
[J*stride, J*stride + span) with stride = out_tile*decim and span = stride +
hist, so rows overlap by hist. K5 reads each stream sample from the frame
row that `deframe` takes it from, row min(g // stride, NT - 1), so a block
whose outputs span several rows reads each row's samples from that row
(`frames_pick`, and `frames_staged` for how the staging loops place them).

Outputs are bit-identical to K4 (``kernels/mixfir_ctaps``) on the same
stream: the CUDA kernels share one body (``csrc/ctaps.cu``) and differ only in
the window source, and the plain version rebuilds the stream from the frames
and runs K4's plain version. bf16 ingest is as in K4: f32 taps, SNR > 30 dB
against the f32 output, where the JAX variant also rounds its taps to bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.fsk_ctaps import ctaps_host
from srcdsp_tpu_torch.kernels.mixfir import LANE, _round_up, check_in_dtype, cuda_or_cpu
from srcdsp_tpu_torch.kernels.mixfir_ctaps import mix_fir_ctaps_plain, word_u32

__all__ = ["frame_planes", "deframe", "make_ctaps_preframed_kernel", "make_frame_kernel",
           "ctaps_preframed_plain", "frames_pick", "frames_staged"]


def _frame_geometry(stride: int, span: int) -> int:
    """hist of a frame layout; the JAX frame_planes' geometry errors."""
    hist = span - stride
    if hist <= 0 or stride % hist:
        raise ValueError(f"need span-stride=hist with hist | stride; "
                         f"got span={span}, stride={stride}")
    return hist


def frame_planes(x: torch.Tensor, stride: int, span: int) -> torch.Tensor:
    """[..., hist+N] -> [..., NT, span] pre-framed rows, row J =
    x[..., J*stride : J*stride + span].

    The JAX version builds the rows from reshapes and needs hist | stride for
    that; `unfold` does not, but the same geometry is required so that both
    packages accept the same layouts.
    """
    hist = _frame_geometry(stride, span)
    n = x.shape[-1] - hist
    if n % stride:
        raise ValueError(f"N={n} not a multiple of stride {stride}")
    return x.unfold(-1, span, stride).contiguous()


def deframe(frames: torch.Tensor, stride: int) -> torch.Tensor:
    """[..., NT, span] frames -> the [..., NT*stride + hist] stream they
    cover: each row's first stride samples, then the last row's tail."""
    lead = frames.shape[:-2]
    head = frames[..., :stride].reshape(*lead, -1)
    return torch.cat([head, frames[..., -1, stride:]], dim=-1)


def frames_pick(g, nt: int, stride: int, span: int):
    """The row rule of the Frames source (fsk_common.cuh:79-88): the frame
    (row, col) that stream sample g (an int or an int64 array) is read from,
    row min(g // stride, nt - 1) as `deframe` takes it; (-1, -1) where the
    stream has no sample g (g < 0 or past (nt - 1)*stride + span)."""
    g = np.asarray(g, np.int64)
    ok = (g >= 0) & (g < (nt - 1) * stride + span)
    row = np.minimum(np.where(ok, g, 0) // stride, nt - 1)
    col = g - row * stride
    return np.where(ok, row, -1), np.where(ok, col, -1)


def frames_staged(base: int, length: int, threads: int, batch: int, nt: int, stride: int,
                  span: int, pairs: bool = False):
    """How stage_window reads window samples base .. base + length - 1 from
    Frames (fsk_common.cuh:102-139 Frames::View at, step, element, view, and
    stage_window's loops): each thread places its first sample of a batch by
    one division, then steps `threads` samples at a time (2*`threads` from
    one pair to the next with `pairs`, each pair samples i, i + 1). Returns
    (row, col) per window index, (-1, -1) where nothing is read."""
    row0 = base // stride
    off0, first, last = base - row0 * stride, -row0, nt - 1 - row0
    rows, cols = np.full(length, -1), np.full(length, -1)
    width, step = (2, 2 * threads) if pairs else (1, threads)
    for t in range(threads):
        for i0 in range(width * t, length, batch * step):
            dr, col = divmod(off0 + i0, stride)
            for q in range(batch):
                i = i0 + q * step
                if i < length:
                    r, cc = dr, col
                    if r > last:
                        r, cc = last, cc + (r - last) * stride
                    if r >= first and cc < span:
                        for w in range(width):
                            if i + w < length:
                                rows[i + w], cols[i + w] = row0 + r, cc + w
                col += step
                while col >= stride:
                    col, dr = col - stride, dr + 1
    return rows, cols


def ctaps_preframed_plain(word0, dword: int, xr_f: torch.Tensor, xi_f: torch.Tensor,
                          gr: torch.Tensor, gi: torch.Tensor, decim: int, out_tile: int,
                          hist: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5: the stream rebuilt from frames [NT, span], then K4's
    plain version -> yr, yi [NT, OT] f32."""
    stride = out_tile * decim
    x = torch.stack([deframe(xr_f, stride), deframe(xi_f, stride)])
    return mix_fir_ctaps_plain(word0, dword, x, gr, gi, decim, out_tile, hist)


def check_frames(xr_f: torch.Tensor, xi_f: torch.Tensor, lead: tuple, span: int,
                 b_rows: int, in_dtype: torch.dtype) -> int:
    """Validate a frame pair [*lead, NT, span] of the kernel's input dtype;
    return NT."""
    for f in (xr_f, xi_f):
        if f.dtype != in_dtype:
            raise ValueError(f"frames dtype {f.dtype} != kernel in_dtype {in_dtype}")
        if f.ndim != len(lead) + 2 or tuple(f.shape[:-2]) != lead or f.shape[-1] != span:
            raise ValueError(f"frames {tuple(f.shape)}, expected {lead} + (NT, {span})")
        if not f.is_contiguous():
            raise ValueError("frames must be contiguous")
    if xr_f.shape != xi_f.shape or xr_f.device != xi_f.device:
        raise ValueError("xr_f and xi_f differ in shape or device")
    nt = xr_f.shape[-2]
    if nt == 0 or nt % b_rows:
        raise ValueError(f"NT={nt} rows not a multiple of b_rows={b_rows}")
    return nt


def make_ctaps_preframed_kernel(taps, dword: int, decim: int, out_tile: int = 512,
                                b_rows: int = 32, in_dtype: torch.dtype = torch.float32,
                                device=None):
    """K5 over producer frames. Returns (fn, hist, stride, span) with
    fn(word0, xr_f [NT, span], xi_f [NT, span]) -> (yr, yi) [NT, out_tile] f32,
    word0 as for K4. Bit-identical to K4 on the same stream."""
    bf16 = check_in_dtype(in_dtype)
    counter = "ctaps_preframed_bf16" if bf16 else "ctaps_preframed"
    device = resolve(device)
    dword = word_u32(dword)
    gr_np, gi_np, _ = ctaps_host(taps, [dword], decim)
    t = gr_np.shape[-1]
    hist = _round_up(t - 1, LANE)
    stride = out_tile * decim
    span = stride + hist
    gr = torch.as_tensor(gr_np[0], device=device).contiguous()
    gi = torch.as_tensor(gi_np[0], device=device).contiguous()

    def fn(word0, xr_f, xi_f):
        nt = check_frames(xr_f, xi_f, (), span, b_rows, in_dtype)
        if xr_f.device != gr.device:
            raise ValueError(f"frames on {xr_f.device}, kernel built for {gr.device}")
        if not cuda_or_cpu(xr_f):
            return ctaps_preframed_plain(word0, dword, xr_f, xi_f, gr, gi, decim, out_tile,
                                         hist)
        lib = _build.load()
        yr = torch.empty((nt, out_tile), dtype=torch.float32, device=xr_f.device)
        yi = torch.empty_like(yr)
        rc = lib.srcdsp_ctaps_preframed(xr_f.data_ptr(), xi_f.data_ptr(), gr.data_ptr(),
                                        gi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                                        word_u32(word0), dword, nt, span, out_tile, decim,
                                        t, hist, int(bf16), _build.stream_handle(xr_f))
        _build.check(rc, counter)
        _build.LAUNCHES[counter] += 1
        return yr, yi

    return fn, hist, stride, span


def make_frame_kernel(stride: int, span: int, b_rows: int = 32,
                      in_dtype: torch.dtype = torch.float32, device=None):
    """K6, the on-device producer: fn(x [2, hist+N]) -> (xr_f, xi_f) [NT, span];
    a leading batch, x [C, 2, hist+N] -> [C, NT, span] x2, is one launch.
    NT must be a multiple of b_rows (the JAX kernel's grid step)."""
    check_in_dtype(in_dtype)
    hist = _frame_geometry(stride, span)
    dev = resolve(device)

    def fn(x):
        if x.dtype != in_dtype:
            raise ValueError(f"x dtype {x.dtype} != kernel in_dtype {in_dtype}")
        if x.ndim not in (2, 3) or x.shape[-2] != 2 or not x.is_contiguous():
            raise ValueError(f"x must be contiguous [C?, 2, hist+N], got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"x on {x.device}, kernel built for {dev}")
        n = x.shape[-1] - hist
        if n <= 0 or n % (b_rows * stride):
            raise ValueError(f"N={n} not a multiple of kernel block {b_rows * stride}")
        if not cuda_or_cpu(x):
            fr = frame_planes(x, stride, span)
            return fr[..., 0, :, :].contiguous(), fr[..., 1, :, :].contiguous()
        lib = _build.load()
        nt = n // stride
        xb = x.reshape(-1, 2, x.shape[-1])
        shape = (*x.shape[:-2], nt, span)
        xr_f = torch.empty(shape, dtype=x.dtype, device=x.device)
        xi_f = torch.empty_like(xr_f)
        rc = lib.srcdsp_frame(xb.data_ptr(), xr_f.data_ptr(), xi_f.data_ptr(), xb.shape[0],
                              x.shape[-1], nt, stride, span, x.element_size(),
                              _build.stream_handle(x))
        _build.check(rc, "frame")
        _build.LAUNCHES["frame"] += 1
        return xr_f, xi_f

    return fn
