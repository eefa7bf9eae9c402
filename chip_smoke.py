#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (srcdsp_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from srcdsp_tpu_torch/csrc with nvcc (sm_90a);
3. each kernel against its plain PyTorch version on the same device tensors,
   at the main path's shapes: error, agreement of the decisions, and the
   median time of each over 5 runs (CUDA events);
4. config 4 end to end: 32 FSK channels, 4 chunks of 2^22 samples per
   channel, streamed through K3 (FskCtapsStream, the serving path), K1
   (FskPlanesStream) and K2 (fsk_demod_fused), each at BER 0;
5. config 1: 2^26 samples of one channel through K1;
6. the recorded fixture tests/fixtures/fsk_256sym.ci16 through the complex
   chain, equal to the C++ oracle's gold bits.

Launch counts are reset just before phase 4 and read after phase 5: every
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
REPS = 5


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

    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.chains.fsk_planes import FskPlanesStream, make_timing_tone
    from srcdsp_tpu_torch.configs import build_config1
    from srcdsp_tpu_torch.io.capture import read_capture
    from srcdsp_tpu_torch.kernels import _build
    from srcdsp_tpu_torch.kernels import fsk_ctaps as kct
    from srcdsp_tpu_torch.kernels import fsk_fused as kff
    from srcdsp_tpu_torch.kernels import mixfir as kmf
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.window import lowpass

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

    def record(name, source, replaces, err, rel, within, agree, k_fn, p_fn):
        before = _build.LAUNCHES[name]
        ms, plain_ms = median_ms(torch, k_fn), median_ms(torch, p_fn)
        require(_build.LAUNCHES[name] == before + REPS + 1, f"{name}: launch count")
        print(f"    {name}: max_abs_err {err:.3e} rel_l2 {rel:.3e} decisions_equal {agree} "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms", flush=True)
        require(within, f"{name}: max abs error {err} / rel L2 {rel} over tolerance")
        require(agree, f"{name}: decisions differ from the plain version")
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms))

    def cplx_err(k, p):
        got, ref = torch.complex(*k), torch.complex(*p)
        err = float(torch.max(torch.abs(got - ref)))
        return err, float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))

    # K1, one channel, config-1 shapes
    c1 = build_config1(C1_SAMPLES, use_kernel=True, device=dev)
    x1 = c1.example[0]
    taps1 = torch.as_tensor(lowpass(64, 0.2), device=dev)
    word1 = int(freq_to_word(0.11))
    w01 = (-hist * word1) % (1 << 32)
    k1 = c1.step(x1)
    p1 = kmf.mix_fir_plain(w01, word1, x1[None], taps1, 2, OUT_TILE, hist)
    err, rel = cplx_err(k1, (p1[0].reshape(1, -1), p1[1].reshape(1, -1)))
    record("mixfir", "srcdsp_tpu_torch/csrc/mixfir.cu", "srcdsp_tpu/kernels/mixfir.py:277",
           err, rel, rel < 1e-5, True, lambda: c1.step(x1),
           lambda: kmf.mix_fir_plain(w01, word1, x1[None], taps1, 2, OUT_TILE, hist))

    # K1, 32 channels, one config-4 chunk
    kmc = kmf.make_mix_fir_kernel_mc(taps4, DECIM, C4_CHANNELS, out_tile=OUT_TILE,
                                     b_rows=B_ROWS, device=dev)
    w04 = [(-hist * int(w)) % (1 << 32) for w in words]
    kout = kmc.fn(w04, words, chunk0)
    pout = kmf.mix_fir_plain(w04, words, chunk0, taps4_d, DECIM, OUT_TILE, hist)
    err, rel = cplx_err(kout, pout)
    record("mixfir_mc", "srcdsp_tpu_torch/csrc/mixfir.cu", "srcdsp_tpu/kernels/mixfir.py:437",
           err, rel, rel < 1e-5, True, lambda: kmc.fn(w04, words, chunk0),
           lambda: kmf.mix_fir_plain(w04, words, chunk0, taps4_d, DECIM, OUT_TILE, hist))

    def fsk_check(name, source, replaces, k_fn, p_fn):
        d, st = k_fn()
        pd, pst = p_fn()
        err = float(torch.max(torch.abs(d - pd)))
        rel = float(torch.linalg.norm(d - pd) / torch.linalg.norm(pd))
        st_ok = bool(torch.all(torch.abs(st - pst) <= 1e-3 + 1e-4 * torch.abs(pst)))
        require(st_ok, f"{name}: O&M sums outside rtol 1e-4 / atol 1e-3")
        _, (b, _) = kff.demod_tail(d, st, SPS, OUT_TILE, class_major=True)
        _, (pb, _) = kff.demod_tail(pd, pst, SPS, OUT_TILE, class_major=True)
        record(name, source, replaces, err, rel, err <= 1e-4, bool(torch.equal(b, pb)),
               k_fn, p_fn)

    k2, _ = kff.make_fsk_mc_kernel(taps4, DECIM, C4_CHANNELS, SPS, out_tile=OUT_TILE,
                                   b_rows=B_ROWS, class_major=True, device=dev)
    fsk_check("fsk_fused", "srcdsp_tpu_torch/csrc/fsk.cu",
              "srcdsp_tpu/kernels/fsk_fused.py:263",
              lambda: k2(w04, words, chunk0),
              lambda: kff.fsk_fused_plain(w04, words, chunk0, taps4_d, DECIM, OUT_TILE,
                                          hist, SPS, True))
    k3, _ = kct.make_fsk_ctaps_kernel(taps4, words, DECIM, SPS, out_tile=OUT_TILE,
                                      b_rows=B_ROWS, class_major=True, device=dev)
    gr, gi, deltas = (torch.as_tensor(a, device=dev)
                      for a in kct.ctaps_host(taps4, words, DECIM))
    fsk_check("fsk_ctaps", "srcdsp_tpu_torch/csrc/fsk.cu",
              "srcdsp_tpu/kernels/fsk_ctaps.py:272",
              lambda: k3(chunk0),
              lambda: kct.fsk_ctaps_plain(chunk0, gr, gi, deltas, DECIM, OUT_TILE, hist,
                                          SPS, True))
    del chunk0, kout, pout, k1, p1

    # --- 4. config 4 end to end (main path) ------------------------------------
    _build.reset_launches()
    chunks = [x4[:, :, i * C4_CHUNK:(i + 1) * C4_CHUNK] for i in range(C4_CHUNKS)]
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

    for name, setup in (("fsk_ctaps_stream (K3)", k3_path),
                        ("fsk_planes_stream (K1)", k1_path), ("fsk_fused (K2)", k2_path)):
        step = setup()
        torch.cuda.synchronize()
        t = time.perf_counter()
        bits = torch.cat([step(ch) for ch in chunks], dim=-1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        rx = bits.cpu().numpy()
        ber = ber_per_channel(bits_tx, rx)
        print(f"[4] config 4 {name}: {C4_CHANNELS} ch x {C4_CHUNKS} x {C4_CHUNK} samples, "
              f"{secs * 1e3:.3f} ms, {total / secs / 1e6:.1f} Ms/s aggregate, "
              f"max BER {ber.max()}", flush=True)
        require(rx.shape == bits_tx.shape, f"{name}: bits shape {rx.shape}")
        require(bool(np.all(ber == 0.0)), f"{name}: BER {ber}")
    del x4, chunks

    # --- 5. config 1 (main path) ----------------------------------------------
    c1_ms = median_ms(torch, lambda: c1.step(x1))
    yr, yi = c1.step(x1)
    torch.cuda.synchronize()
    require(tuple(yr.shape) == (1, C1_SAMPLES // 2), f"config 1 output {tuple(yr.shape)}")
    require(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()), "config 1 not finite")
    print(f"[5] config 1: {C1_SAMPLES} samples in {c1_ms:.3f} ms median, "
          f"{C1_SAMPLES / c1_ms / 1e3:.1f} Ms/s", flush=True)

    launches = dict(_build.LAUNCHES)
    print(f"    main-path launches: {launches}")
    for row in rows:
        row["launches"] = launches[row["name"]]
        require(row["launches"] > 0, f"{row['name']} never launched on the main path")

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

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
