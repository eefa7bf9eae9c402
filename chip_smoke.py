#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (srcdsp_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from srcdsp_tpu_torch/csrc with nvcc (sm_90a, one
   nvcc per source, in parallel) and the ingest framer with make and g++;
3. each kernel against its plain PyTorch version on the same device tensors,
   at the main path's shapes (config 1: 2^26 samples; config 4: one chunk
   of 32 x 2^22; config 2: one channel of 33,521,664 samples, and one chunk
   of 4 x 8,380,416 for K8 mc), f32 and bf16 ingest: error, agreement of
   the decisions, the median time of each over 5 runs (CUDA events), the
   library call's where one PyTorch call computes the same function, and the
   bound (the larger of the f32 multiply-adds over 67 TFLOP/s and the bytes
   in and out over 3.35 TB/s); the pre-framed kernels bit-identical to the
   ones over raw planes (K5 == K4, K7 == K3, K9 == K8);
4. config 4 end to end: 32 FSK channels, 4 chunks of 2^22 samples per
   channel, streamed through K3 (FskCtapsStream, the serving path), K1
   (FskPlanesStream), K2 (fsk_demod_fused), K3 on bf16 input, and K6 + K7
   (the frame kernel, then fsk_demod_preframed) in f32 and bf16, each at
   BER 0;
5. config 1: 2^26 samples of one channel through K1 and the four serving
   variants of configs.build_config1_serving (K4, K5; f32 and bf16 ingest);
6. the recorded fixture tests/fixtures/fsk_256sym.ci16 through the complex
   chain, equal to the C++ oracle's gold bits;
7. ingest at config-1 shape: an int16 capture framed to bf16 on the host by
   the C++ framer into pinned memory, copied to the card and filtered by K5,
   equal bit for bit to K5 over K6 frames of the same capture converted on
   the card; the time of each leg;
8. config 2 end to end: 4 channels x 33,521,664 samples through K8 mc (the
   429 combined taps of the 128-tap FIR and the 3/4 resampler), one launch
   equal bit for bit to 4 chunks with carried history; SNR > 90 dB against
   the plain chain (configs.build_config2 on the card) and, on the first
   2^18 samples of channel 0, against the C++ oracle; then the five variants
   of configs.build_config2_onchip, each timed, with pre-framed == fused ==
   fused_mc channel 0 bit for bit.

Launch counts are reset just before phase 4 and read after phase 8: every
kernel must have run on the main path. The last three lines are one JSON
object per kernel, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
C4_CHANNELS, C4_CHUNK, C4_CHUNKS = 32, 1 << 22, 4
DECIM, SPS, DEV = 4, 8, 0.05
OUT_TILE, B_ROWS = 512, 32
C1_SAMPLES = 1 << 26
# config 2: 2^25 samples per channel rounded down to whole blocks of every
# variant (49,152 = 32 K9 rows of 1536), streamed as 4 chunks of 682 K8 blocks
C2_CHANNELS, C2_CHUNK, C2_CHUNKS = 4, 682 * 12288, 4
C2_SAMPLES = C2_CHUNK * C2_CHUNKS
C2_ORACLE_SAMPLES = 1 << 18
REPS = 5
# published H100 SXM peaks: f32 outside the tensor cores, and HBM3
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = REPS) -> float:
    """Median CUDA-event time of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def tensor_bytes(*ts) -> int:
    """Bytes of the given tensors (nested tuples and lists allowed)."""
    total = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            total += tensor_bytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def roofline_ms(flops: float, nbytes: int) -> tuple[float, str]:
    """The least time the card could take: the larger of flops over the f32
    peak and bytes (each input read once, each output written once) over the
    memory rate, in ms, and which of the two binds."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def snr_db(torch, ref, got) -> float:
    return float(10 * torch.log10(ref.abs().pow(2).mean() / (got - ref).abs().pow(2).mean()))


def ber_per_channel(tx: np.ndarray, rx: np.ndarray, settle: int = 16) -> np.ndarray:
    """Lowest bit-error rate over lags -16..16 per channel, after `settle` symbols."""
    best = np.ones(tx.shape[0])
    for lag in range(-16, 17):
        bs, rs = settle + max(lag, 0), settle + max(-lag, 0)
        n = min(tx.shape[-1] - bs, rx.shape[-1] - rs)
        best = np.minimum(best, np.mean(tx[:, bs:bs + n] != rx[:, rs:rs + n], axis=-1))
    return best


def config4_signal(torch, dev, seed: int = 0):
    """32 CPFSK channels, channel c centred at 0.11 + 0.01*c (input rate)."""
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone

    n = C4_CHUNK * C4_CHUNKS
    nsym = n // (DECIM * SPS)
    rng = np.random.default_rng(seed)
    bits = random_bits(rng, (C4_CHANNELS, nsym))
    centers = [0.11 + 0.01 * c for c in range(C4_CHANNELS)]
    host = torch.empty((C4_CHANNELS, 2, n), dtype=torch.float32, pin_memory=True)
    for c in range(C4_CHANNELS):
        x = fsk_baseband(bits[c], DECIM * SPS, DEV / DECIM) * tone(n, centers[c])
        host[c, 0] = torch.from_numpy(x.real.copy())
        host[c, 1] = torch.from_numpy(x.imag.copy())
    words = np.asarray([freq_to_word(-f) for f in centers], np.uint32)
    return bits, host.to(dev), words


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from srcdsp_tpu_torch import oracle
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.chains.fsk_planes import FskPlanesStream, make_timing_tone
    from srcdsp_tpu_torch.configs import (
        CONFIG1_SERVING, CONFIG2_ONCHIP, build_config1, build_config1_serving, build_config2,
        build_config2_onchip, config2_step)
    from srcdsp_tpu_torch.io import framer
    from srcdsp_tpu_torch.io.capture import read_capture
    from srcdsp_tpu_torch.kernels import _build
    from srcdsp_tpu_torch.kernels import fsk_ctaps as kct
    from srcdsp_tpu_torch.kernels import fsk_fused as kff
    from srcdsp_tpu_torch.kernels import fsk_preframed as kfp
    from srcdsp_tpu_torch.kernels import mixfir as kmf
    from srcdsp_tpu_torch.kernels import mixfir_ctaps as kcm
    from srcdsp_tpu_torch.kernels import mixfir_preframed as kpf
    from srcdsp_tpu_torch.kernels import resample_pallas as krs
    from srcdsp_tpu_torch.kernels import resample_preframed as krp
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.planes import planes_from_int16
    from srcdsp_tpu_torch.ops.window import lowpass

    bf16 = torch.bfloat16

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # --- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"[2] built {lib_path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in (lib_path.parent / "nvcc.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"    ptxas: {line.strip()}")
    t0 = time.perf_counter()
    framer_path = framer.build()
    print(f"[2] built {framer_path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # --- 3. kernels vs plain at the main path's shapes --------------------------
    rows = []
    t0 = time.perf_counter()
    bits_tx, x4, words = config4_signal(torch, dev)
    print(f"[3] config-4 signal {tuple(x4.shape)} made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    taps4 = lowpass(64, 0.03)
    taps4_d = torch.as_tensor(taps4, device=dev)
    hist = 128
    chunk0 = torch.cat([torch.zeros((C4_CHANNELS, 2, hist), device=dev),
                        x4[:, :, :C4_CHUNK]], dim=-1)

    def record(name, source, replaces, err, rel, within, agree, k_fn, p_fn, flops, nbytes,
               lib_fn=None):
        """Time kernel and plain version (and the library call where one
        computes the same function); flops counts the least multiply-adds of
        the function's filter sums: real taps on complex samples, 4 flop per
        tap and output whatever form the kernel uses (complex taps are the
        kernel's choice; phasors and atan2 left out), nbytes the inputs and
        outputs once each (taps, at most 2 KB, left out)."""
        before = _build.LAUNCHES[name]
        ms, plain_ms = median_ms(torch, k_fn), median_ms(torch, p_fn)
        require(_build.LAUNCHES[name] == before + REPS + 1, f"{name}: launch count")
        lib_ms = median_ms(torch, lib_fn) if lib_fn is not None else None
        bound_ms, bound_by = roofline_ms(flops, nbytes)
        print(f"    {name}: max_abs_err {err:.3e} rel_l2 {rel:.3e} decisions_equal {agree} "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms library {lib_ms} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)",
              flush=True)
        require(within, f"{name}: max abs error {err} / rel L2 {rel} over tolerance")
        require(agree, f"{name}: decisions differ from the plain version")
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))

    def cplx_err(k, p):
        got, ref = torch.complex(*k), torch.complex(*p)
        err = float(torch.max(torch.abs(got - ref)))
        return err, float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))

    # K1, one channel, config-1 shapes
    c1 = build_config1(C1_SAMPLES, use_kernel=True, device=dev)
    x1 = c1.example[0]
    taps1_np = lowpass(64, 0.2)
    taps1 = torch.as_tensor(taps1_np, device=dev)
    word1 = int(freq_to_word(0.11))
    w01 = (-hist * word1) % (1 << 32)
    k1 = c1.step(x1)
    p1 = kmf.mix_fir_plain(w01, word1, x1[None], taps1, 2, OUT_TILE, hist)
    err, rel = cplx_err(k1, (p1[0].reshape(1, -1), p1[1].reshape(1, -1)))
    record("mixfir", "srcdsp_tpu_torch/csrc/mixfir.cu", "srcdsp_tpu/kernels/mixfir.py:277",
           err, rel, rel < 1e-5, True, lambda: c1.step(x1),
           lambda: kmf.mix_fir_plain(w01, word1, x1[None], taps1, 2, OUT_TILE, hist),
           k1[0].numel() * 64 * 4, tensor_bytes(x1, k1))

    # K1, 32 channels, one config-4 chunk
    kmc = kmf.make_mix_fir_kernel_mc(taps4, DECIM, C4_CHANNELS, out_tile=OUT_TILE,
                                     b_rows=B_ROWS, device=dev)
    w04 = [(-hist * int(w)) % (1 << 32) for w in words]
    kout = kmc.fn(w04, words, chunk0)
    pout = kmf.mix_fir_plain(w04, words, chunk0, taps4_d, DECIM, OUT_TILE, hist)
    err, rel = cplx_err(kout, pout)
    record("mixfir_mc", "srcdsp_tpu_torch/csrc/mixfir.cu", "srcdsp_tpu/kernels/mixfir.py:437",
           err, rel, rel < 1e-5, True, lambda: kmc.fn(w04, words, chunk0),
           lambda: kmf.mix_fir_plain(w04, words, chunk0, taps4_d, DECIM, OUT_TILE, hist),
           kout[0].numel() * 64 * 4, tensor_bytes(chunk0, kout))

    def fsk_check(name, source, replaces, k_fn, p_fn, inputs):
        d, st = k_fn()
        pd, pst = p_fn()
        flops, nbytes = d.numel() * 64 * 4, tensor_bytes(inputs, d, st)
        err = float(torch.max(torch.abs(d - pd)))
        rel = float(torch.linalg.norm(d - pd) / torch.linalg.norm(pd))
        st_ok = bool(torch.all(torch.abs(st - pst) <= 1e-3 + 1e-4 * torch.abs(pst)))
        require(st_ok, f"{name}: O&M sums outside rtol 1e-4 / atol 1e-3")
        _, (b, _) = kff.demod_tail(d, st, SPS, OUT_TILE, class_major=True)
        _, (pb, _) = kff.demod_tail(pd, pst, SPS, OUT_TILE, class_major=True)
        record(name, source, replaces, err, rel, err <= 1e-4, bool(torch.equal(b, pb)),
               k_fn, p_fn, flops, nbytes)

    k2, _ = kff.make_fsk_mc_kernel(taps4, DECIM, C4_CHANNELS, SPS, out_tile=OUT_TILE,
                                   b_rows=B_ROWS, class_major=True, device=dev)
    fsk_check("fsk_fused", "srcdsp_tpu_torch/csrc/fsk.cu",
              "srcdsp_tpu/kernels/fsk_fused.py:263",
              lambda: k2(w04, words, chunk0),
              lambda: kff.fsk_fused_plain(w04, words, chunk0, taps4_d, DECIM, OUT_TILE,
                                          hist, SPS, True), chunk0)
    k3, _ = kct.make_fsk_ctaps_kernel(taps4, words, DECIM, SPS, out_tile=OUT_TILE,
                                      b_rows=B_ROWS, class_major=True, device=dev)
    gr, gi, deltas = (torch.as_tensor(a, device=dev)
                      for a in kct.ctaps_host(taps4, words, DECIM))
    fsk_check("fsk_ctaps", "srcdsp_tpu_torch/csrc/fsk.cu",
              "srcdsp_tpu/kernels/fsk_ctaps.py:272",
              lambda: k3(chunk0),
              lambda: kct.fsk_ctaps_plain(chunk0, gr, gi, deltas, DECIM, OUT_TILE, hist,
                                          SPS, True), chunk0)
    del kout, pout, k1, p1

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    # K4, K5 and K6 at config-1 shape, f32 and bf16 ingest
    g1r, g1i = (torch.as_tensor(a[0], device=dev)
                for a in kct.ctaps_host(taps1_np, [word1], 2)[:2])
    for dt, sfx in ((torch.float32, ""), (bf16, "_bf16")):
        xin = x1.to(dt)
        k4 = kcm.make_mix_fir_ctaps_kernel(taps1_np, word1, 2, out_tile=OUT_TILE,
                                           b_rows=B_ROWS, in_dtype=dt, device=dev)
        y4 = k4.fn(w01, xin)
        err, rel = cplx_err(y4, kcm.mix_fir_ctaps_plain(w01, word1, xin, g1r, g1i, 2,
                                                        OUT_TILE, hist))
        record("mixfir_ctaps" + sfx, "srcdsp_tpu_torch/csrc/ctaps.cu",
               "srcdsp_tpu/kernels/mixfir_ctaps.py:241", err, rel, rel < 1e-5, True,
               lambda: k4.fn(w01, xin),
               lambda: kcm.mix_fir_ctaps_plain(w01, word1, xin, g1r, g1i, 2, OUT_TILE, hist),
               y4[0].numel() * 64 * 4, tensor_bytes(xin, y4))
        fn5, _, stride1, span1 = kpf.make_ctaps_preframed_kernel(
            taps1_np, word1, 2, out_tile=OUT_TILE, b_rows=B_ROWS, in_dtype=dt,
            device=dev)
        fk1 = kpf.make_frame_kernel(stride1, span1, B_ROWS, in_dtype=dt, device=dev)
        fr = kpf.frame_planes(xin, stride1, span1)
        kfr = fk1(xin)
        require(same(kfr, fr), f"frame{sfx}: K6 frames differ from frame_planes")
        if dt == torch.float32:
            # the library call: one unfold of the planes, made contiguous
            record("frame", "srcdsp_tpu_torch/csrc/frame.cu",
                   "srcdsp_tpu/kernels/mixfir_preframed.py:212", 0.0, 0.0, True, True,
                   lambda: fk1(xin), lambda: kpf.frame_planes(xin, stride1, span1),
                   0, tensor_bytes(xin, kfr),
                   lambda: xin.unfold(-1, span1, stride1).contiguous())
        y5 = fn5(w01, fr[0], fr[1])
        require(same(y5, y4), f"ctaps_preframed{sfx}: K5 != K4 (torch.equal)")
        print(f"    ctaps_preframed{sfx} == mixfir_ctaps{sfx}: torch.equal True; "
              f"frame{sfx} == frame_planes: torch.equal True")
        err, rel = cplx_err(y5, kpf.ctaps_preframed_plain(w01, word1, fr[0], fr[1], g1r, g1i,
                                                          2, OUT_TILE, hist))
        record("ctaps_preframed" + sfx, "srcdsp_tpu_torch/csrc/ctaps.cu",
               "srcdsp_tpu/kernels/mixfir_preframed.py:157", err, rel, rel < 1e-5, True,
               lambda: fn5(w01, fr[0], fr[1]),
               lambda: kpf.ctaps_preframed_plain(w01, word1, fr[0], fr[1], g1r, g1i, 2,
                                                 OUT_TILE, hist),
               y5[0].numel() * 64 * 4, tensor_bytes(fr, y5))
        del xin, fr, kfr, y4, y5

    # K3 on bf16 input, and K7 over frames of the same chunk in both dtypes
    k3b, _ = kct.make_fsk_ctaps_kernel(taps4, words, DECIM, SPS, out_tile=OUT_TILE,
                                       b_rows=B_ROWS, class_major=True, in_dtype=bf16,
                                       device=dev)
    chunk0b = chunk0.to(bf16)
    fsk_check("fsk_ctaps_bf16", "srcdsp_tpu_torch/csrc/fsk.cu",
              "srcdsp_tpu/kernels/fsk_ctaps.py:272",
              lambda: k3b(chunk0b),
              lambda: kct.fsk_ctaps_plain(chunk0b, gr, gi, deltas, DECIM, OUT_TILE, hist,
                                          SPS, True), chunk0b)
    for dt, sfx, k3fn, ch in ((torch.float32, "", k3, chunk0), (bf16, "_bf16", k3b, chunk0b)):
        fn7, _, stride4, span4 = kfp.make_fsk_preframed_kernel(
            taps4, words, DECIM, SPS, out_tile=OUT_TILE, b_rows=B_ROWS, class_major=True,
            in_dtype=dt, device=dev)
        fr = kpf.frame_planes(ch, stride4, span4)
        xr_f, xi_f = fr[:, 0].contiguous(), fr[:, 1].contiguous()
        del fr
        require(same(fn7(xr_f, xi_f), k3fn(ch)), f"fsk_preframed{sfx}: K7 != K3 (torch.equal)")
        print(f"    fsk_preframed{sfx} == fsk_ctaps{sfx}: torch.equal True (d, st)")
        fsk_check("fsk_preframed" + sfx, "srcdsp_tpu_torch/csrc/fsk.cu",
                  "srcdsp_tpu/kernels/fsk_preframed.py:173",
                  lambda: fn7(xr_f, xi_f),
                  lambda: kfp.fsk_preframed_plain(xr_f, xi_f, gr, gi, deltas, DECIM,
                                                  OUT_TILE, hist, SPS, True), (xr_f, xi_f))
        del xr_f, xi_f
    del chunk0, chunk0b

    # K8 (one channel, config-2 shape), K8 mc (4 channels, one chunk), K9 f32
    # and bf16 over K6 frames; K9 == K8 bit for bit
    t0 = time.perf_counter()
    c2 = build_config2_onchip(C2_SAMPLES, "fused_mc", channels=C2_CHANNELS, device=dev)
    x2 = c2.example[0]
    k8mc, w02, words2 = c2.meta["kernel"], c2.meta["words0"], c2.meta["words"]
    h2 = k8mc.hist
    require(h2 == 256 and x2.shape[-1] == h2 + C2_SAMPLES, f"config-2 planes {tuple(x2.shape)}")
    print(f"[3] config-2 planes {tuple(x2.shape)} made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    hc = krs.combine_fir_resample_taps(lowpass(128, 0.2), lowpass(48, 0.3), 3)
    hc_d = torch.as_tensor(hc, device=dev)
    c2_flops_per_out = -(-len(hc) // 3) * 4          # 143 real taps x complex samples
    k8 = krs.make_mix_resample_kernel(hc, 3, 4, out_tile=384, b_rows=24, device=dev)
    x20 = x2[0]
    y8 = k8.fn(w02[0], words2[0], x20)
    p8r, p8i = krs.mix_resample_plain(w02[0], words2[0], x20[None], hc_d, 3, 4, 384, h2)
    err, rel = cplx_err(y8, (p8r[0], p8i[0]))
    del p8r, p8i
    record("mix_resample", "srcdsp_tpu_torch/csrc/resample.cu",
           "srcdsp_tpu/kernels/resample_pallas.py:166", err, rel, rel < 1e-5, True,
           lambda: k8.fn(w02[0], words2[0], x20),
           lambda: krs.mix_resample_plain(w02[0], words2[0], x20[None], hc_d, 3, 4, 384, h2),
           y8[0].numel() * c2_flops_per_out, tensor_bytes(x20, y8))
    chunk2 = x2[..., :h2 + C2_CHUNK].contiguous()
    ymc = k8mc.fn(w02, words2, chunk2)
    err, rel = cplx_err(ymc, krs.mix_resample_plain(w02, words2, chunk2, hc_d, 3, 4, 384, h2))
    record("mix_resample_mc", "srcdsp_tpu_torch/csrc/resample.cu",
           "srcdsp_tpu/kernels/resample_pallas.py:283", err, rel, rel < 1e-5, True,
           lambda: k8mc.fn(w02, words2, chunk2),
           lambda: krs.mix_resample_plain(w02, words2, chunk2, hc_d, 3, 4, 384, h2),
           ymc[0].numel() * c2_flops_per_out, tensor_bytes(chunk2, ymc))
    del chunk2, ymc
    for dt, sfx, ot in ((torch.float32, "", 1152), (bf16, "_bf16", 2304)):
        fn9, h9, stride9, span9 = krp.make_resample_preframed_kernel(
            hc, words2[0], 3, 4, out_tile=ot, b_rows=B_ROWS, in_dtype=dt, device=dev)
        fr = kpf.make_frame_kernel(stride9, span9, B_ROWS, in_dtype=dt, device=dev)(x20.to(dt))
        y9 = fn9(w02[0], *fr)
        flat9 = torch.complex(y9[0].reshape(-1), y9[1].reshape(-1))
        flat8 = torch.complex(y8[0].reshape(-1), y8[1].reshape(-1))
        if dt == torch.float32:
            require(torch.equal(flat9, flat8), "resample_preframed: K9 != K8 (torch.equal)")
            print("    resample_preframed == mix_resample: torch.equal True")
        else:
            snr = snr_db(torch, flat8, flat9)
            print(f"    resample_preframed_bf16: SNR {snr:.2f} dB against K8 f32 (floor 40)")
            require(snr > 40.0, f"resample_preframed_bf16: SNR {snr} dB against f32")
        err, rel = cplx_err(y9, krp.resample_preframed_plain(w02[0], words2[0], *fr, hc_d, 3,
                                                             4, ot, h9))
        record("resample_preframed" + sfx, "srcdsp_tpu_torch/csrc/resample.cu",
               "srcdsp_tpu/kernels/resample_preframed.py:167", err, rel, rel < 1e-5, True,
               lambda: fn9(w02[0], *fr),
               lambda: krp.resample_preframed_plain(w02[0], words2[0], *fr, hc_d, 3, 4, ot,
                                                    h9),
               y9[0].numel() * c2_flops_per_out, tensor_bytes(fr, y9))
        del fr, y9, flat9, flat8

    # --- 4. config 4 end to end (main path) ------------------------------------
    x4b = x4.to(bf16)
    _build.reset_launches()
    chunks = [x4[:, :, i * C4_CHUNK:(i + 1) * C4_CHUNK] for i in range(C4_CHUNKS)]
    chunks_b = [x4b[:, :, i * C4_CHUNK:(i + 1) * C4_CHUNK] for i in range(C4_CHUNKS)]
    total = C4_CHANNELS * C4_CHUNK * C4_CHUNKS

    # each setup builds its path outside the timed region and returns a per-chunk step
    def k3_path():
        s = kct.FskCtapsStream(taps4, words, DECIM, SPS, C4_CHANNELS, out_tile=OUT_TILE,
                               b_rows=B_ROWS, device=dev)
        return lambda ch: s.process(ch)[0]

    def k1_path():
        k = kmf.make_mix_fir_kernel_mc(taps4, DECIM, C4_CHANNELS, out_tile=OUT_TILE,
                                       b_rows=B_ROWS, device=dev)
        tc, ts = make_timing_tone(C4_CHUNK // DECIM, SPS)
        s = FskPlanesStream(k, words, SPS, tc, ts, C4_CHANNELS)
        return lambda ch: s.process(ch)[0]

    def k2_path():
        fn, h = kff.make_fsk_mc_kernel(taps4, DECIM, C4_CHANNELS, SPS, out_tile=OUT_TILE,
                                       b_rows=B_ROWS, class_major=True, device=dev)
        carry = dict(buf=torch.zeros((C4_CHANNELS, 2, h), device=dev), state=None,
                     w0=[(-h * int(w)) % (1 << 32) for w in words])

        def step(ch):
            xin = torch.cat([carry["buf"], ch], dim=-1)
            carry["state"], (b, _) = kff.fsk_demod_fused(
                fn, h, OUT_TILE, carry["w0"], words, xin, SPS, state=carry["state"],
                class_major=True)
            carry["w0"] = [(w + C4_CHUNK * int(d)) % (1 << 32)
                           for w, d in zip(carry["w0"], words)]
            carry["buf"] = xin[..., -h:].contiguous()
            return b
        return step

    def k3_bf16_path():
        fn, h = kct.make_fsk_ctaps_kernel(taps4, words, DECIM, SPS, out_tile=OUT_TILE,
                                          b_rows=B_ROWS, class_major=True, in_dtype=bf16,
                                          device=dev)
        carry = dict(buf=torch.zeros((C4_CHANNELS, 2, h), dtype=bf16, device=dev), state=None)

        def step(ch):
            xin = torch.cat([carry["buf"], ch], dim=-1)
            carry["state"], (b, _) = kct.fsk_demod_ctaps(fn, h, OUT_TILE, xin, SPS,
                                                         state=carry["state"],
                                                         class_major=True)
            carry["buf"] = xin[..., -h:].contiguous()
            return b
        return step

    def preframed_path(dt):
        fn, h, stride, span = kfp.make_fsk_preframed_kernel(
            taps4, words, DECIM, SPS, out_tile=OUT_TILE, b_rows=B_ROWS, class_major=True,
            in_dtype=dt, device=dev)
        frame = kpf.make_frame_kernel(stride, span, B_ROWS, in_dtype=dt, device=dev)
        carry = dict(buf=torch.zeros((C4_CHANNELS, 2, h), dtype=dt, device=dev), state=None)

        def step(ch):
            xin = torch.cat([carry["buf"], ch], dim=-1)
            xr_f, xi_f = frame(xin)
            carry["state"], (b, _) = kfp.fsk_demod_preframed(fn, OUT_TILE, xr_f, xi_f, SPS,
                                                             state=carry["state"],
                                                             class_major=True)
            carry["buf"] = xin[..., -h:].contiguous()
            return b
        return step

    for name, setup, feed in (
            ("fsk_ctaps_stream (K3)", k3_path, chunks),
            ("fsk_planes_stream (K1)", k1_path, chunks),
            ("fsk_fused (K2)", k2_path, chunks),
            ("fsk_ctaps bf16 (K3 bf16)", k3_bf16_path, chunks_b),
            ("frame + fsk_preframed (K6+K7)", lambda: preframed_path(torch.float32), chunks),
            ("frame + fsk_preframed bf16 (K6+K7 bf16)", lambda: preframed_path(bf16),
             chunks_b)):
        step = setup()
        torch.cuda.synchronize()
        t = time.perf_counter()
        bits = torch.cat([step(ch) for ch in feed], dim=-1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        rx = bits.cpu().numpy()
        ber = ber_per_channel(bits_tx, rx)
        print(f"[4] config 4 {name}: {C4_CHANNELS} ch x {C4_CHUNKS} x {C4_CHUNK} samples, "
              f"{secs * 1e3:.3f} ms, {total / secs / 1e6:.1f} Ms/s aggregate, "
              f"max BER {ber.max()}", flush=True)
        require(rx.shape == bits_tx.shape, f"{name}: bits shape {rx.shape}")
        require(bool(np.all(ber == 0.0)), f"{name}: BER {ber}")
    del x4, x4b, chunks, chunks_b

    # --- 5. config 1 (main path) ----------------------------------------------
    c1_ms = median_ms(torch, lambda: c1.step(x1))
    yr, yi = c1.step(x1)
    torch.cuda.synchronize()
    require(tuple(yr.shape) == (1, C1_SAMPLES // 2), f"config 1 output {tuple(yr.shape)}")
    require(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()), "config 1 not finite")
    print(f"[5] config 1 kernel (K1): {C1_SAMPLES} samples in {c1_ms:.3f} ms median, "
          f"{C1_SAMPLES / c1_ms / 1e3:.1f} Ms/s", flush=True)
    serving = {}
    for variant in CONFIG1_SERVING:
        b = build_config1_serving(C1_SAMPLES, variant, device=dev)
        ms = median_ms(torch, lambda: b.step(*b.example))
        yr, yi = b.step(*b.example)
        torch.cuda.synchronize()
        require(b.samples_per_call == C1_SAMPLES and yr.numel() == C1_SAMPLES // 2,
                f"config 1 {variant}: {b.samples_per_call} samples, {tuple(yr.shape)} out")
        require(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()),
                f"config 1 {variant} not finite")
        serving[variant] = (yr.reshape(-1), yi.reshape(-1))
        print(f"[5] config 1 {variant}: {C1_SAMPLES} samples in {ms:.3f} ms median, "
              f"{C1_SAMPLES / ms / 1e3:.1f} Ms/s", flush=True)
        del b
    for sfx in ("", "_bf16io"):
        require(same(serving["preframed" + sfx], serving["ctaps" + sfx]),
                f"config 1 preframed{sfx} != ctaps{sfx}")
    ref = torch.complex(*serving["ctaps"])
    snr = float(10 * torch.log10(ref.abs().pow(2).mean()
                                 / (torch.complex(*serving["ctaps_bf16io"]) - ref)
                                 .abs().pow(2).mean()))
    print(f"    preframed == ctaps, preframed_bf16io == ctaps_bf16io (torch.equal); "
          f"bf16 ingest SNR {snr:.2f} dB against f32 (floor 30)")
    require(snr > 30.0, f"config 1 bf16 ingest SNR {snr} dB")
    del serving, ref

    # --- 6. recorded fixture -----------------------------------------------------
    fix = REPO / "tests" / "fixtures"
    meta = json.loads((fix / "fsk_256sym.fixture.json").read_text())
    x, _ = read_capture(str(fix / "fsk_256sym.ci16"))
    params = make_fsk_params(meta["center"], meta["taps"], meta["cutoff"], meta["decim"],
                             meta["sps"], meta["dev"], device=dev)
    _, (bits, _) = fsk_apply(params, fsk_init(params), torch.as_tensor(x, device=dev))
    gold = np.load(fix / "fsk_256sym_gold_bits.npy")
    require(np.array_equal(bits.cpu().numpy(), gold), "fixture bits differ from gold")
    print(f"[6] fixture fsk_256sym: {gold.size} bits equal to the oracle's gold bits")

    # --- 7. ingest: capture -> C++ framer (bf16) -> H2D -> K5 (main path) ---------
    fn5, h5, stride1, span1 = kpf.make_ctaps_preframed_kernel(
        taps1_np, word1, 2, out_tile=OUT_TILE, b_rows=B_ROWS, in_dtype=bf16, device=dev)
    iq = np.random.default_rng(7).integers(-32768, 32768, size=(h5 + C1_SAMPLES, 2),
                                           dtype=np.int16)
    # the first call also loads the library and allocates the pinned buffers,
    # which the caching host allocator hands back to the second, timed call
    t = time.perf_counter()
    hr, hi = framer.frame_ci16(iq, h5, stride1, span1, bf16=True, threads=4, pin_memory=True)
    first_s = time.perf_counter() - t
    del hr, hi
    t = time.perf_counter()
    hr, hi = framer.frame_ci16(iq, h5, stride1, span1, bf16=True, threads=4, pin_memory=True)
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    xr_f, xi_f = hr.to(dev, non_blocking=True), hi.to(dev, non_blocking=True)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t
    dev_ms = median_ms(torch, lambda: fn5(w01, xr_f, xi_f))
    y = fn5(w01, xr_f, xi_f)
    iq_d = torch.from_numpy(iq).to(dev)
    pr, pi = planes_from_int16(iq_d.reshape(-1))
    planes = torch.stack([pr, pi]).to(bf16)
    kr, ki = kpf.make_frame_kernel(stride1, span1, B_ROWS, in_dtype=bf16, device=dev)(planes)
    require(same((xr_f, xi_f), (kr, ki)), "ingest: framer frames differ from K6 frames")
    require(same(y, fn5(w01, kr, ki)), "ingest: K5 output differs between the two producers")
    frame_bytes = 2 * hr.numel() * hr.element_size()
    print(f"[7] ingest {C1_SAMPLES} ci16 samples: framer bf16 x4 threads {host_s * 1e3:.3f} ms "
          f"({C1_SAMPLES / host_s / 1e6:.1f} Ms/s; first call with the pinned allocation "
          f"{first_s * 1e3:.3f} ms), H2D {frame_bytes / 1e6:.1f} MB in "
          f"{h2d_s * 1e3:.3f} ms ({frame_bytes / h2d_s / 1e9:.2f} GB/s), K5 bf16 "
          f"{dev_ms:.3f} ms ({C1_SAMPLES / dev_ms / 1e3:.1f} Ms/s); frames and K5 output "
          f"equal to K6 frames of the capture converted on the card", flush=True)
    del hr, hi, xr_f, xi_f, y, iq_d, pr, pi, planes, kr, ki

    # --- 8. config 2 (main path) ---------------------------------------------
    t = time.perf_counter()
    one = c2.step(x2)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    stream = x2[..., h2:]
    carry = torch.zeros((C2_CHANNELS, 2, h2), device=dev)
    parts = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(C2_CHUNKS):
        xin = torch.cat([carry, stream[..., i * C2_CHUNK:(i + 1) * C2_CHUNK]], dim=-1)
        w0i = [(w0 + i * C2_CHUNK * w) % (1 << 32) for w0, w in zip(w02, words2)]
        parts.append(k8mc.fn(w0i, words2, xin))
        carry = xin[..., -h2:]
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t
    chunked = tuple(torch.cat([p[j] for p in parts], dim=1) for j in range(2))
    require(same(chunked, one), "config 2: chunked K8 mc != one launch (torch.equal)")
    del parts, xin, carry, chunked
    total2 = C2_CHANNELS * C2_SAMPLES
    print(f"[8] config 2 K8 mc: {C2_CHANNELS} ch x {C2_SAMPLES} samples, one launch "
          f"{one_s * 1e3:.3f} ms (first call), {C2_CHUNKS} chunks of {C2_CHUNK} with carried "
          f"history {chunk_s * 1e3:.3f} ms ({total2 / chunk_s / 1e6:.1f} Ms/s); chunked == one "
          f"launch: torch.equal True", flush=True)
    y2 = torch.complex(one[0], one[1]).reshape(C2_CHANNELS, -1)
    del one
    xc = torch.complex(stream[:, 0], stream[:, 1])
    chain_state = build_config2(16, C2_CHANNELS, device=dev).example[:3]
    t = time.perf_counter()
    *_, z2 = config2_step(words2, dev)(*chain_state, xc)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t
    require(z2.shape == y2.shape, f"config 2: plain chain {tuple(z2.shape)} vs {tuple(y2.shape)}")
    snr_chain = snr_db(torch, z2, y2)
    del z2
    x0 = xc[0, :C2_ORACLE_SAMPLES].cpu().numpy()
    mixed, _ = oracle.nco_mix(x0, 0, words2[0])
    ref0 = oracle.resample(oracle.fir(mixed, lowpass(128, 0.2)), lowpass(48, 0.3), 3, 4)
    snr_oracle = snr_db(torch, torch.from_numpy(ref0),
                        y2[0, :ref0.size].cpu())
    print(f"    config 2 against the plain chain (nco -> 128-tap FIR -> 3/4 resample, "
          f"{chain_s * 1e3:.1f} ms on the card): SNR {snr_chain:.2f} dB; first "
          f"{C2_ORACLE_SAMPLES} samples of channel 0 against the C++ oracle: SNR "
          f"{snr_oracle:.2f} dB (floor 90 each)", flush=True)
    require(snr_chain > 90.0, f"config 2: SNR {snr_chain} dB against the plain chain")
    require(snr_oracle > 90.0, f"config 2: SNR {snr_oracle} dB against the oracle")
    del xc, stream
    outs = {}
    for variant in CONFIG2_ONCHIP:
        b = c2 if variant == "fused_mc" else build_config2_onchip(C2_SAMPLES, variant,
                                                                   device=dev)
        ms = median_ms(torch, lambda: b.step(*b.example))
        yr, yi = b.step(*b.example)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()),
                f"config 2 {variant} not finite")
        y = torch.complex(yr, yi)
        outs[variant] = y.reshape(C2_CHANNELS, -1)[0] if variant == "fused_mc" else y.reshape(-1)
        print(f"[8] config 2 {variant}: {b.samples_per_call} samples in {ms:.3f} ms median, "
              f"{b.samples_per_call / ms / 1e3:.1f} Ms/s", flush=True)
        del b, yr, yi, y
    fused = outs["fused"]
    require(torch.equal(outs["fused_mc"], fused), "config 2: fused_mc channel 0 != fused")
    require(torch.equal(outs["preframed"], fused), "config 2: preframed != fused (torch.equal)")
    n2 = min(outs["two_kernels"].numel(), fused.numel())
    snr_two = snr_db(torch, fused[:n2], outs["two_kernels"][:n2])
    snr_bf16 = snr_db(torch, fused, outs["preframed_bf16io"])
    print(f"    preframed == fused == fused_mc channel 0 (torch.equal); two_kernels SNR "
          f"{snr_two:.2f} dB (floor 90), preframed_bf16io SNR {snr_bf16:.2f} dB (floor 40) "
          f"against fused", flush=True)
    require(snr_two > 90.0, f"config 2 two_kernels: SNR {snr_two} dB")
    require(snr_bf16 > 40.0, f"config 2 preframed_bf16io: SNR {snr_bf16} dB")
    del outs, fused, x2, c2, y2

    launches = dict(_build.LAUNCHES)
    print(f"    main-path launches: {launches}")
    for row in rows:
        row["launches"] = launches[row["name"]]
        require(row["launches"] > 0, f"{row['name']} never launched on the main path")

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
