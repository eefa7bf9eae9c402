"""File -> chain -> file CLI (counterpart of ``srcdsp_tpu/cli.py``).

Stream a capture file through a chain on the card and write the result:

    python -m srcdsp_tpu_torch.cli fsk  in.iq bits.out --center 0.11 --decim 4 --sps 8
    python -m srcdsp_tpu_torch.cli psk  in.iq syms.out --center 0.17 --decim 2 --sps 4 --order 4
    python -m srcdsp_tpu_torch.cli qam  in.iq syms.out --center 0.13 --decim 2 --sps 4 --order 64
    python -m srcdsp_tpu_torch.cli fir  in.iq out.iq   --taps 64 --cutoff 0.1 --decim 2
    python -m srcdsp_tpu_torch.cli fm   in.iq audio.f32 --center 0.11 --decim 4 --dev 0.08 [--stereo]
    python -m srcdsp_tpu_torch.cli am   in.iq audio.f32 --center 0.21 --decim 4
    python -m srcdsp_tpu_torch.cli channelize in.iq out --channels 64 [--demod psk]
    python -m srcdsp_tpu_torch.cli mod  syms.u8 out.iq --mod qam --order 16 --sps 8
    python -m srcdsp_tpu_torch.cli scan in.iq dets.jsonl --analyze
    python -m srcdsp_tpu_torch.cli mux  chans wide.iq --channels 16
    python -m srcdsp_tpu_torch.cli resample in.iq out.iq --up 3 --down 4
    python -m srcdsp_tpu_torch.cli gen  test.iq --gen chirp --snr 10 --fmt cu8
    python -m srcdsp_tpu_torch.cli fecenc bits.u8 coded.u8 --code ldpc
    python -m srcdsp_tpu_torch.cli fecdec llrs.f32 bits.u8 --code ldpc [--hard]
    python -m srcdsp_tpu_torch.cli scf  in.iq lines.jsonl [--conj]
    python -m srcdsp_tpu_torch.cli adsb es.iq frames.jsonl --sps-half 1
    python -m srcdsp_tpu_torch.cli ais  vhf.iq msgs.jsonl --decim 2 --sps 4
    python -m srcdsp_tpu_torch.cli rds  fm.iq groups.jsonl --sps-half 96 --pilot 0.0833
    python -m srcdsp_tpu_torch.cli gps  l1.iq acq.jsonl --sps 2 [--prn 7]
    python -m srcdsp_tpu_torch.cli pocsag pager.iq pages.jsonl --sps 8 --dev 0.05
    python -m srcdsp_tpu_torch.cli ax25 audio.f32 frames.jsonl --fs 13200

Streams in fixed blocks with carried state (bit-exact vs one-shot), writes
output incrementally per block, checkpoints every --ckpt-every blocks, and
resumes automatically when the checkpoint file matches (--ckpt PATH). On
completion the checkpoint is deleted. `channelize` fans one wideband
capture out to per-channel files (`out.chNNN.cf32`), optionally
demodulating each channel (`--demod psk` -> `out.chNNN.u8` symbol indices).

Every chain runs on `--device`: the card by default (the CLI raises without
one), `--device cpu` on request. Each block goes to the device once and its
output comes back once; the host sinks (file writes, JSON lines, the
framing codecs) stay on the host. The files, records and stderr summaries
are the reference's, and a checkpoint the reference wrote resumes here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve, to_host

_CHAINS = ["fsk", "psk", "dqpsk", "qam", "fir", "fm", "am", "channelize", "mod", "scan", "mux",
           "resample", "gen", "fecenc", "fecdec", "scf", "adsb", "ais", "rds", "gps", "pocsag",
           "ax25", "css", "apt", "acars", "sstv", "navtex", "rtty", "same", "cw"]


def _open_out(args):
    return open(args.outfile, "w") if args.outfile != "-" else sys.stdout


def _close_out(out) -> None:
    if out is not sys.stdout:
        out.close()


def _on(args, x) -> torch.Tensor:
    """A host array on the CLI's device: one copy."""
    return torch.as_tensor(np.ascontiguousarray(x), device=args.device)


def _stream(args, params, state, apply_fn, out_fmt: str, out_per_block: int):
    """Stream infile through the chain, committing output incrementally.

    out_fmt: "u8" (symbol indices), "cf32" (interleaved complex) or "f32"
    (real audio). out_per_block: output items per input block (symbols for
    demods, samples for filters) - fixed, so a checkpoint at block B implies
    an output offset of exactly B*out_per_block items. Each block's output
    is appended as soon as it is computed; a crash therefore loses at most
    the blocks since the last checkpoint, and a resumed run truncates to the
    checkpointed offset and continues IN PLACE in the same outfile. The
    checkpoint is deleted when the stream completes.
    """
    from srcdsp_tpu_torch import checkpoint
    from srcdsp_tpu_torch.io.capture import interleave_cf32, read_capture_blocks

    start_block = 0
    if args.ckpt and checkpoint.exists(args.ckpt):
        state, start_block = checkpoint.restore(args.ckpt, state)
        print(f"resumed from block {start_block}", file=sys.stderr)

    item = {"u8": 1, "f32": 4, "cf32": 8}[out_fmt]  # bytes per item
    offset = start_block * out_per_block * item
    mode = "r+b" if (start_block and os.path.exists(args.outfile)) else "wb"
    n_items = start_block * out_per_block
    i = start_block - 1
    with open(args.outfile, mode) as f:
        f.truncate(offset)
        f.seek(offset)
        for i, xb in enumerate(read_capture_blocks(args.infile, args.block,
                                                   start_block=start_block),
                               start=start_block):
            state, out = apply_fn(params, state, _on(args, xb))
            arr = to_host(out[0] if isinstance(out, tuple) else out).reshape(-1)
            if out_fmt == "u8":
                f.write(arr.astype(np.uint8).tobytes())
            elif out_fmt == "f32":
                f.write(arr.astype(np.float32).tobytes())
            else:
                f.write(interleave_cf32(arr).tobytes())
            n_items += arr.shape[0]
            if args.ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
                f.flush()
                checkpoint.save(args.ckpt, state, block_index=i + 1)
    if i < start_block and start_block == 0:
        print("no full blocks to process", file=sys.stderr)
        return
    if out_fmt == "cf32":
        from srcdsp_tpu_torch.io.capture import CaptureMeta, _sidecar
        meta = CaptureMeta(fmt="cf32", num_samples=n_items)
        with open(_sidecar(args.outfile), "w") as f:
            f.write(meta.to_json())
    if args.ckpt:
        checkpoint.delete(args.ckpt)
    print(f"processed blocks {start_block}..{i} -> {args.outfile}",
          file=sys.stderr)


def _channelize(args) -> None:
    """file -> polyphase bank -> per-channel capture files (the config-5
    workload in file form). With --demod psk the per-channel streams are
    demodulated and each channel's symbol indices are written as u8."""
    from srcdsp_tpu_torch.chains.channelizer import (
        channelize_apply, channelizer_init, design_prototype)
    from srcdsp_tpu_torch.io.capture import (
        CaptureMeta, _sidecar, interleave_cf32, read_capture_blocks)

    m = args.channels
    proto = design_prototype(m, taps_per_phase=args.taps_per_phase)
    state = channelizer_init(proto, m, device=args.device)
    demod = args.demod == "psk"
    if demod:
        from srcdsp_tpu_torch.chains.psk import make_psk_params, psk_apply, psk_init
        psk = make_psk_params(0.0, decim=1, sps=args.sps, order=args.order,
                              rrc_span=4, device=args.device)
        pst = psk_init(psk, channel_shape=(m,))

    ext = "u8" if demod else "cf32"
    paths = [f"{args.outfile}.ch{c:03d}.{ext}" for c in range(m)]
    files = [open(pth, "wb") for pth in paths]
    n_items = 0
    nb = 0
    try:
        for xb in read_capture_blocks(args.infile, args.block):
            state, y = channelize_apply(proto, state, _on(args, xb), m)
            if demod:
                pst, (idx, _) = psk_apply(psk, pst, y)
                out = to_host(idx).astype(np.uint8)         # [M, Nsym]
            else:
                yc = to_host(y)                             # [M, K] c64
                out = np.stack([interleave_cf32(row) for row in yc])
            for c, f in enumerate(files):
                f.write(out[c].tobytes())
            n_items += out.shape[-1] // (1 if demod else 2)
            nb += 1
    finally:
        for f in files:
            f.close()
    if not demod:
        for pth in paths:
            with open(_sidecar(pth), "w") as f:
                f.write(CaptureMeta(fmt="cf32", sample_rate=1.0 / m,
                                    num_samples=n_items).to_json())
    print(f"channelized {nb} blocks -> {m} files {args.outfile}.chNNN.{ext}",
          file=sys.stderr)


def _mux(args) -> None:
    """Per-channel captures -> polyphase SYNTHESIS bank -> one wideband
    capture: the transmit dual of `channelize`. infile is a prefix: reads
    `<infile>.chNNN.cf32` for NNN in 0..channels-1 (the files `channelize`
    writes), streams block-aligned across channels with carried state
    (stops at the shortest channel's last whole block)."""
    from srcdsp_tpu_torch.chains.channelizer import (
        design_prototype, synthesize_apply, synthesizer_init)
    from srcdsp_tpu_torch.io.capture import (
        CaptureMeta, _sidecar, interleave_cf32, read_capture_blocks)

    m = args.channels
    proto = design_prototype(m, taps_per_phase=args.taps_per_phase)
    state = synthesizer_init(proto, m, device=args.device)
    kb = max(1, args.block // m)
    gens = [read_capture_blocks(f"{args.infile}.ch{c:03d}.cf32", kb)
            for c in range(m)]
    n_items = 0
    with open(args.outfile, "wb") as f:
        for blocks in zip(*gens):        # one block per channel, in step;
            y = np.stack(blocks)         # stops at the shortest channel
            state, xb = synthesize_apply(proto, state, _on(args, y), m)
            f.write(interleave_cf32(to_host(xb)).tobytes())
            n_items += xb.shape[-1]
    with open(_sidecar(args.outfile), "w") as f:
        f.write(CaptureMeta(fmt="cf32", num_samples=n_items).to_json())
    print(f"muxed {m} channels -> {n_items} wideband samples "
          f"{args.outfile}", file=sys.stderr)


def _modulate(args) -> None:
    """u8 bits/symbol-indices -> modulated IQ capture (cf32): the
    transmit-side subcommand over chains/tx.py. --mod psk|qam consume symbol
    indices (< --order); fsk|gmsk consume bits {0,1}."""
    from srcdsp_tpu_torch.chains import tx as txm
    from srcdsp_tpu_torch.io.capture import CaptureMeta, _sidecar, interleave_cf32
    from srcdsp_tpu_torch.ops.window import root_raised_cosine

    data = np.fromfile(args.infile, dtype=np.uint8)
    sps = args.sps
    if args.mod in ("psk", "qam"):
        if data.size and int(data.max()) >= args.order:
            raise SystemExit(f"symbol index {int(data.max())} out of range "
                             f"for order {args.order}")
        taps = root_raised_cosine(sps, 8, beta=0.35)   # rx chains' matched pulse
        params = txm.make_linear_tx(args.center, taps, sps, device=args.device)
        state = txm.linear_tx_init(params)

        def step(s, blk):
            idx = _on(args, blk.astype(np.int32))
            sym = (txm.psk_map(idx, args.order) if args.mod == "psk"
                   else txm.qam_map(idx, args.order))
            return txm.linear_tx_apply(params, s, sym)
    else:
        if data.size and int(data.max()) > 1:
            raise SystemExit(f"{args.mod} expects bits, got value "
                             f"{int(data.max())}")
        params = (txm.make_cpfsk_tx(args.center, sps, args.dev, device=args.device)
                  if args.mod == "fsk"
                  else txm.make_gmsk_tx(args.center, sps, bt=args.bt, device=args.device))
        state = txm.cpm_tx_init(params)

        def step(s, blk):
            return txm.cpm_tx_apply(params, s, _on(args, blk.astype(np.int32)))

    sym_block = max(1, args.block // sps)
    n_items = 0
    with open(args.outfile, "wb") as f:
        for lo in range(0, data.size, sym_block):
            state, y = step(state, data[lo:lo + sym_block])
            arr = to_host(y).reshape(-1)
            f.write(interleave_cf32(arr).tobytes())
            n_items += arr.shape[0]
    with open(_sidecar(args.outfile), "w") as f:
        f.write(CaptureMeta(fmt="cf32", num_samples=n_items).to_json())
    print(f"modulated {data.size} {args.mod} symbols -> {n_items} samples "
          f"{args.outfile}", file=sys.stderr)


def _fec(args) -> None:
    """FEC file subcommands: `fecenc` reads u8 info BITS and writes u8 coded
    bits in whole codewords (zero-padding the final word); `fecdec` reads
    f32 LLRs (llr > 0 favors bit 0) or, with --hard, u8 bits mapped to +-4
    LLRs, and writes u8 decoded info bits. --code ldpc decodes through the
    K14 serving decoder (the CUDA kernel on the card, its plain version on
    the CPU); the other codes run their plain torch decoders on --device.
    """
    code_name = args.code
    dev = args.device

    if code_name == "ldpc":
        from srcdsp_tpu_torch.kernels.ldpc_pallas import make_ldpc_decoder, plan_edges
        from srcdsp_tpu_torch.ldpc import ldpc_encode, make_ldpc_code, make_regular_ldpc
        h = make_regular_ldpc(args.fec_n, 3, 6, seed=0)
        code = make_ldpc_code(h, device=dev)
        k, n = code.k, code.n

        def encode(u):
            return to_host(ldpc_encode(code, _on(args, u))).astype(np.uint8)

        dec = make_ldpc_decoder(code, plan_edges(h), iters=args.fec_iters, device=dev)

        def decode(llr):
            _, info, ok = dec(_on(args, llr))
            return to_host(info).astype(np.uint8), to_host(ok)
    elif code_name == "polar":
        from srcdsp_tpu_torch.polar import make_polar, polar_decode, polar_encode
        pc = make_polar(args.fec_n, args.fec_k)
        k, n = pc.k, pc.n

        def encode(u):
            return to_host(polar_encode(pc, _on(args, u))).astype(np.uint8)

        def decode(llr):
            info, _ = polar_decode(pc, _on(args, llr))
            return to_host(info).astype(np.uint8), None
    elif code_name == "turbo":
        from srcdsp_tpu_torch.turbo import make_turbo, turbo_decode_batch, turbo_encode
        tc = make_turbo(args.fec_k, seed=0)
        k = args.fec_k
        kk = tc.rsc.k - 1                    # termination tail bits
        n = 3 * k + 2 * kk                   # sys+tail | par1+tail | par2

        def encode(u):
            s, p1, p2 = turbo_encode(tc, _on(args, u))
            return to_host(torch.cat([s, p1, p2], dim=-1)).astype(np.uint8)

        def decode(llr):
            lt = _on(args, llr)
            bits, _ = turbo_decode_batch(tc, lt[:, :k + kk], lt[:, k + kk:2 * (k + kk)],
                                         lt[:, 2 * (k + kk):], iters=args.fec_iters)
            return to_host(bits).astype(np.uint8), None
    elif code_name == "conv":
        from srcdsp_tpu_torch.fec import conv_encode, make_conv_code, viterbi_decode
        cc = make_conv_code(7, [0o171, 0o133])       # the K=7 NASA code
        k = args.fec_k
        n = cc.n * (k + cc.k - 1)                    # terminated

        def encode(u):
            return to_host(conv_encode(cc, _on(args, u))).astype(np.uint8)

        def decode(llr):
            return to_host(viterbi_decode(cc, _on(args, llr))).astype(np.uint8), None
    elif code_name == "bch":
        from srcdsp_tpu_torch.bch import bch_decode, bch_encode, make_bch_code
        # --fec-n picks the field (31/63/127/255...); default (31,21) t=2
        bn = args.fec_n if args.fec_n != 504 else 31
        m = bn.bit_length()
        if (1 << m) - 1 != bn or not 3 <= m <= 10:
            raise SystemExit(f"--fec-n must be 2^m - 1 with 3 <= m <= 10 "
                             f"for bch, got {bn}")
        bc = make_bch_code(m, args.fec_t, device=dev)
        k, n = bc.k, bc.n

        def encode(u):
            return to_host(bch_encode(bc, _on(args, u))).astype(np.uint8)

        def decode(llr):
            hard = (llr < 0).astype(np.int32)
            info, ok = bch_decode(bc, _on(args, hard))
            return to_host(info).astype(np.uint8), to_host(ok)
    elif code_name == "golay":
        from srcdsp_tpu_torch.golay import golay_decode, golay_encode, make_golay
        gc = make_golay()
        k, n = 12, 24

        def encode(u):
            return to_host(golay_encode(gc, _on(args, u.reshape(-1, 12)))
                           ).astype(np.uint8).reshape(-1)

        def decode(llr):
            hard = (llr < 0).astype(np.int32).reshape(-1, 24)
            info, _, ok = golay_decode(gc, _on(args, hard))
            return to_host(info).astype(np.uint8).reshape(-1), to_host(ok)
    elif code_name == "rs":
        from srcdsp_tpu_torch.rs import make_rs_code, rs_decode, rs_encode
        # the generic --fec-n/--fec-k defaults (504/128) are LDPC/polar
        # shapes; RS defaults to the CCSDS (255, 223)
        rs_n = args.fec_n if args.fec_n != 504 else 255
        rs_k = args.fec_k if args.fec_k != 128 else 223
        rc = make_rs_code(rs_n, rs_k, device=dev)
        # RS works on BYTES: fecenc reads raw bytes (k per word), fecdec
        # reads received bytes (--hard implied; LLRs don't apply)
        if args.chain == "fecenc":
            u = np.fromfile(args.infile, dtype=np.uint8)
            nw = -(-u.size // rc.k)
            u = np.concatenate([u, np.zeros(nw * rc.k - u.size, np.uint8)])
            cw = to_host(rs_encode(rc, _on(args, u.reshape(nw, rc.k)))).astype(np.uint8)
            cw.reshape(-1).tofile(args.outfile)
            print(f"encoded {u.size} bytes -> {nw} x rs({rc.n},{rc.k}) "
                  f"codewords -> {args.outfile}", file=sys.stderr)
        else:
            r = np.fromfile(args.infile, dtype=np.uint8)
            nw = r.size // rc.n
            if nw == 0:
                raise SystemExit(f"input shorter than one codeword "
                                 f"({rc.n} bytes)")
            msg, ok = rs_decode(rc, _on(args, r[: nw * rc.n].reshape(nw, rc.n)))
            to_host(msg).astype(np.uint8).reshape(-1).tofile(args.outfile)
            print(f"decoded {nw} x rs({rc.n},{rc.k}) -> {nw * rc.k} bytes"
                  f", {int(np.sum(to_host(ok)))}/{nw} corrected-clean"
                  f" -> {args.outfile}", file=sys.stderr)
        return
    else:
        raise SystemExit(f"unknown --code {code_name}")

    if args.chain == "fecenc":
        u = np.fromfile(args.infile, dtype=np.uint8)
        if u.size and int(u.max()) > 1:
            raise SystemExit("fecenc expects bits {0,1}")
        nw = -(-u.size // k)
        u = np.concatenate([u, np.zeros(nw * k - u.size, np.uint8)])
        cw = encode(u.reshape(nw, k).astype(np.int32))
        cw.reshape(-1).tofile(args.outfile)
        print(f"encoded {u.size} info bits -> {nw} x {code_name}(n={n}, "
              f"k={k}) codewords -> {args.outfile}", file=sys.stderr)
        return

    if args.hard:
        b = np.fromfile(args.infile, dtype=np.uint8)
        llr = (4.0 * (1.0 - 2.0 * b.astype(np.float32)))
    else:
        llr = np.fromfile(args.infile, dtype=np.float32)
    nw = llr.size // n
    if nw == 0:
        raise SystemExit(f"input shorter than one codeword ({n} values)")
    info, ok = decode(llr[:nw * n].reshape(nw, n).astype(np.float32))
    info.reshape(-1).tofile(args.outfile)
    okmsg = (f", {int(np.sum(ok))}/{nw} parity-clean"
             if ok is not None else "")
    print(f"decoded {nw} x {code_name} codewords -> {nw * k} info bits"
          f"{okmsg} -> {args.outfile}", file=sys.stderr)


def _gen(args) -> None:
    """Test-signal generator subcommand: tone | chirp | noise -> IQ capture
    (host numpy; pair with `mod` for digital signals). --snr adds
    calibrated AWGN on top of the signal."""
    from srcdsp_tpu_torch.io.capture import CaptureMeta, write_capture
    from srcdsp_tpu_torch.testing.signals import chirp, np_tone

    n = args.num_samples
    rng = np.random.default_rng(args.seed)
    if args.gen == "tone":
        x = np_tone(n, args.center)
    elif args.gen == "chirp":
        x = chirp(n, args.f0, args.f1)
    else:                                            # noise
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
             / np.sqrt(2)).astype(np.complex64)
    if args.snr is not None and args.gen != "noise":
        p_sig = float(np.mean(np.abs(x) ** 2))
        sigma = np.sqrt(p_sig * 10.0 ** (-args.snr / 10.0) / 2.0)
        x = (x + sigma * (rng.standard_normal(n)
                          + 1j * rng.standard_normal(n))
             ).astype(np.complex64)
    write_capture(args.outfile2, np.asarray(x), CaptureMeta(fmt=args.fmt))
    print(f"generated {n} {args.gen} samples -> {args.outfile2}",
          file=sys.stderr)


def _scan(args) -> None:
    """Blind survey subcommand: capture -> JSON lines, one per detected band
    (center, bandwidth, SNR; with --analyze also baud + PSK order from the
    band mixed to baseband)."""
    from srcdsp_tpu_torch.chains.blindscan import baud_estimate, classify_mpsk, detect_css, scan
    from srcdsp_tpu_torch.io.capture import read_capture
    from srcdsp_tpu_torch.ops.fir import fir_full
    from srcdsp_tpu_torch.ops.window import lowpass
    from srcdsp_tpu_torch.testing.signals import np_tone

    x, meta = read_capture(args.infile)
    n = min(len(x), args.block * 16)
    x = np.asarray(x[:n])
    dets = scan(x, nfft=args.scan_nfft, device=args.device)
    out = _open_out(args)
    for d in dets:
        rec = {"center": d.center, "bandwidth": d.bandwidth,
               "snr_db": round(d.power_db, 1)}
        if args.analyze:
            bb = x * np_tone(x.size, -d.center)
            # isolate the band before analysis: other signals in the
            # capture would otherwise feed the line tests
            cut = float(min(0.45, max(0.75 * d.bandwidth, 0.01)))
            bb = to_host(fir_full(lowpass(129, cut), _on(args, bb.astype(np.complex64))))
            baud, line_db = baud_estimate(bb, f_lo=max(1e-3, d.bandwidth / 16))
            if line_db > 10.0:
                rec["baud"] = baud
            order, _ = classify_mpsk(bb[: 1 << 16])
            if order:
                rec["psk_order"] = order
            # the chirp statistic expects ~1 sample/chip, but (sf, chip rate)
            # are individually ambiguous - an SF7 chirp at 2x oversampling
            # IS an SF9 chirp. Sweep power-of-two decimations (exact
            # hypotheses), keep the best score, and report the INVARIANT
            # chirp rate 1/(2^sf * decim^2) in capture units alongside the
            # winning (sf, decim) pair.
            best_c = None
            for decim_c in (1, 2, 4, 8, 16, 32):
                if decim_c > 2.5 / max(d.bandwidth, 1e-3):
                    break
                r = detect_css(bb[::decim_c], device=args.device)
                if r["detected"] and (best_c is None or r["score"] > best_c[0]):
                    best_c = (r["score"], r, decim_c)
            if best_c is not None:
                _, chirp, decim_c = best_c
                rec["css_sf"] = chirp["sf"]
                rec["css_decim"] = decim_c
                rec["css_chirp_rate"] = 1.0 / ((1 << chirp["sf"]) * decim_c * decim_c)
                rec["css_direction"] = chirp["direction"]
        out.write(json.dumps(rec) + "\n")
    _close_out(out)
    print(f"{len(dets)} detections", file=sys.stderr)


def _scf(args) -> None:
    """Cyclostationary survey subcommand: capture -> JSON lines - the
    normalized cycle profile's detected lines (non-conjugate: baud-rate
    features; --conj: 2 f_c carrier features, the BPSK/QPSK test)."""
    from srcdsp_tpu_torch.io.capture import read_capture
    from srcdsp_tpu_torch.ops.cyclo import detect_cycles, fam_scf

    x, _meta = read_capture(args.infile)
    np_ = args.scf_np
    pfr = args.scf_p
    need = (pfr - 1) * (np_ // 4) + np_
    x = np.asarray(x)
    if len(x) < need:
        raise SystemExit(f"capture too short: need {need} samples for "
                         f"Np={np_}, P={pfr}")
    res = fam_scf(_on(args, x[:need].astype(np.complex64)), np_=np_, p=pfr, conj=args.conj)
    peaks = detect_cycles(res, thresh=args.scf_thresh)
    out = _open_out(args)
    for alpha, strength in peaks:
        out.write(json.dumps({
            "alpha": round(alpha, 6), "strength": round(strength, 4),
            "kind": "conjugate" if args.conj else "standard"}) + "\n")
    _close_out(out)


def _adsb(args) -> None:
    """Mode S / ADS-B subcommand: capture (IQ -> magnitude, or raw f32
    magnitude with --mag) -> JSON lines, one per CRC-clean frame (hex
    payload + sample offset). The decoder is host numpy, as the
    reference's."""
    from srcdsp_tpu_torch.chains.adsb import decode_all_frames
    from srcdsp_tpu_torch.io.capture import read_capture

    if args.mag:
        mag = np.fromfile(args.infile, np.float32)
    else:
        x, _meta = read_capture(args.infile)
        mag = np.abs(np.asarray(x)).astype(np.float32)
    frames = decode_all_frames(mag, sps_half=args.sps_half, thresh=args.adsb_thresh)
    out = _open_out(args)
    for bits, start in frames:
        byts = np.packbits(bits.reshape(-1, 8)).tobytes()
        out.write(json.dumps({"start": start, "hex": byts.hex()}) + "\n")
    _close_out(out)
    print(f"decoded {len(frames)} CRC-clean Mode S frames", file=sys.stderr)


def _fsk_bits(args, x, dev_: float, cutoff: float, timing_forget: float = 0.5) -> np.ndarray:
    """The FSK chain over the whole capture on --device (one `fsk_apply`,
    as the reference jits it), the hard bits copied back once."""
    from srcdsp_tpu_torch.chains.fsk import fsk_capture_bits

    return to_host(fsk_capture_bits(_on(args, x), args.center, args.taps, cutoff, args.sps, dev_,
                                    decim=args.decim, timing_forget=timing_forget)).reshape(-1)


def _ais(args) -> None:
    """AIS subcommand: IQ capture -> GMSK/FSK discriminator demod (unknown CFO:
    NRZI absorbs the discriminator bias) -> multi-frame HDLC/FCS stream
    decode -> JSON lines, one per FCS-clean frame (hex payload + flag bit
    offset)."""
    from srcdsp_tpu_torch.chains.ais import decode_all_ais_frames
    from srcdsp_tpu_torch.io.capture import read_capture

    x, _meta = read_capture(args.infile)
    x = np.asarray(x)
    decim, sps = args.decim, args.sps
    if (x.size // (decim * sps)) == 0:
        raise SystemExit("capture shorter than one symbol block")
    lv_hat = _fsk_bits(args, x, 0.25 / sps, 0.45 / decim, timing_forget=0.95)  # GMSK: long memory
    frames = decode_all_ais_frames(lv_hat)
    out = _open_out(args)
    for payload, start in frames:
        out.write(json.dumps({"start_bit": int(start), "hex": payload.hex()}) + "\n")
    _close_out(out)
    print(f"decoded {len(frames)} FCS-clean AIS frames", file=sys.stderr)


def _fm_mpx(args, path: str) -> torch.Tensor | np.ndarray:
    """--mpx: the raw f32 file; else the FM discriminator over the whole IQ
    capture on --device, scaled by 1/--dev (stays on the device)."""
    from srcdsp_tpu_torch.chains.fsk import discriminate
    from srcdsp_tpu_torch.io.capture import read_capture

    if args.mpx:
        return np.fromfile(path, np.float32)
    x, _meta = read_capture(path)
    xt = _on(args, np.asarray(x).astype(np.complex64))
    _, d = discriminate(torch.zeros(1, dtype=torch.complex64, device=xt.device), xt)
    return d / args.dev


def _rds(args) -> None:
    """RDS subcommand: FM IQ capture (or raw f32 MPX with --mpx) -> pilot-cubed
    coherent 57 kHz demod -> block-code group decode -> JSON lines, one per
    syndrome-clean group."""
    from srcdsp_tpu_torch.chains.rds import rds_demod_mpx, rds_sync_decode

    bits = rds_demod_mpx(_fm_mpx(args, args.infile), args.pilot, args.sps_half,
                         device=args.device)
    groups = rds_sync_decode(bits)
    out = _open_out(args)
    for g in groups:
        out.write(json.dumps({
            "start_bit": g["start"], "version": g["version"],
            "corrected": g["corrected"],
            "words": [f"{w:04x}" for w in g["words"]]}) + "\n")
    _close_out(out)
    print(f"decoded {len(groups)} RDS groups", file=sys.stderr)


def _gps(args) -> None:
    """GPS C/A subcommand: IQ capture -> 2-D acquisition per PRN -> JSON lines
    for PRNs whose peak/median ratio clears --gps-thresh."""
    from srcdsp_tpu_torch.chains.gps import acquire_ca, fine_acquire, make_gps_acq
    from srcdsp_tpu_torch.io.capture import read_capture

    x, _meta = read_capture(args.infile)
    xt = _on(args, np.asarray(x).astype(np.complex64))
    prns = [int(args.prn)] if args.prn != "all" else list(range(1, 33))
    out = _open_out(args)
    found = 0
    for prn in prns:
        acq = make_gps_acq(prn, sps=args.sps, device=args.device)
        dop = np.arange(-args.doppler_bins, args.doppler_bins + 1) / (2.0 * acq.n)
        res = acquire_ca(acq, xt, dop)
        if float(res["ratio"]) < args.gps_thresh:
            continue
        fine = fine_acquire(acq, res)
        out.write(json.dumps({
            "prn": prn, "ratio": round(float(res["ratio"]), 2),
            "code_phase_samples": round(float(fine["code_phase"]), 2),
            "doppler_cps": float(fine["doppler"])}) + "\n")
        found += 1
    _close_out(out)
    print(f"acquired {found} PRNs", file=sys.stderr)


def _pocsag(args) -> None:
    """POCSAG subcommand: 2-FSK IQ capture -> FSK demod (both polarities tried -
    network conventions differ) -> batch decode -> JSON lines, one per
    page."""
    from srcdsp_tpu_torch.chains.pocsag import decode_numeric, decode_transmission
    from srcdsp_tpu_torch.io.capture import read_capture

    x, _meta = read_capture(args.infile)
    bits = _fsk_bits(args, np.asarray(x).astype(np.complex64), args.dev, 0.45 / args.decim)
    pages = decode_transmission(bits)
    if not pages:
        pages = decode_transmission(1 - bits)
    out = _open_out(args)
    for g in pages:
        out.write(json.dumps({
            "ric": g["ric"], "func": g["func"],
            "corrected": g["corrected"],
            "data": [f"{w:05x}" for w in g["data"]],
            "numeric": decode_numeric(g["data"])}) + "\n")
    _close_out(out)
    print(f"decoded {len(pages)} POCSAG pages", file=sys.stderr)


def _css(args) -> None:
    """CSS (LoRa-class) subcommand: IQ capture at 1 sample/chip -> burst scan
    (up/down-chirp sync) -> dechirp-FFT demod -> frame decode -> JSON lines,
    one per detected burst (implicit-header mode: payload length from
    --css-len)."""
    from srcdsp_tpu_torch.chains.css import css_receive_stream, make_css_params
    from srcdsp_tpu_torch.io.capture import read_capture

    x, _meta = read_capture(args.infile)
    params = make_css_params(sf=args.css_sf, cr=args.css_cr)
    bursts = css_receive_stream(params, _on(args, np.asarray(x).astype(np.complex64)),
                                args.css_len)
    out = _open_out(args)
    n_ok = 0
    for payload, ok, start in bursts:
        n_ok += bool(ok)
        out.write(json.dumps({
            "start_chip": int(start), "crc_ok": bool(ok),
            "hex": payload.hex() if payload is not None else None}) + "\n")
    _close_out(out)
    print(f"decoded {n_ok}/{len(bursts)} CSS bursts CRC-clean", file=sys.stderr)


def _apt(args) -> None:
    """NOAA APT subcommand: FM IQ capture (or raw f32 MPX with --mpx) ->
    discriminator -> 2400 Hz AM envelope -> sync -> full-line image written
    as a binary PGM (P5, 8-bit, 2080 px wide - both video channels plus
    sync/telemetry bands, the standard APT raster)."""
    from srcdsp_tpu_torch.chains.apt import apt_decode_mpx, make_apt_params

    p = make_apt_params(fs=args.fs, device=args.device)
    out = apt_decode_mpx(p, _fm_mpx(args, args.infile))
    img = np.clip(out["lines"], 0.0, 1.0)
    pix = (img * 255.0 + 0.5).astype(np.uint8)
    with open(args.outfile, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (pix.shape[1], pix.shape[0]))
        f.write(pix.tobytes())
    print(f"wrote {pix.shape[0]} APT lines (sync offset "
          f"{out['offset']}, score {out['score']:.1f})", file=sys.stderr)


def _am_audio(args) -> np.ndarray:
    """--mpx: the raw f32 audio; else the AM envelope |x| - DC of the IQ
    capture (host numpy, as the reference)."""
    from srcdsp_tpu_torch.io.capture import read_capture

    if args.mpx:
        return np.fromfile(args.infile, np.float32)
    x, _meta = read_capture(args.infile)
    env = np.abs(np.asarray(x)).astype(np.float32)
    return env - env.mean()


def _acars(args) -> None:
    """ACARS subcommand: AM IQ capture (envelope = |x| - DC) or raw f32 audio
    with --mpx -> MSK demod -> block decode -> JSON lines."""
    from srcdsp_tpu_torch.chains.acars import decode_acars_audio

    fs = args.fs if args.fs is not None else 48000.0
    if fs % 2400:
        raise SystemExit(f"--fs {fs} must be a multiple of 2400 for "
                         f"integer samples/bit")
    recs = decode_acars_audio(_am_audio(args), int(fs // 2400), fs, device=args.device)
    out = _open_out(args)
    for r in recs:
        out.write(json.dumps({
            "start_bit": r["start_bit"], "bcs_ok": r["bcs_ok"],
            "mode": r["mode"], "address": r["address"],
            "label": r["label"], "bid": r["bid"],
            "text": r["text"]}) + "\n")
    _close_out(out)
    print(f"decoded {len(recs)} ACARS blocks", file=sys.stderr)


def _cw(args) -> None:
    """CW/Morse subcommand: audio f32 (--mpx) or IQ capture -> blind decode
    (tone and speed estimated from the capture; host numpy) -> text."""
    from srcdsp_tpu_torch.chains.cw import decode_cw
    from srcdsp_tpu_torch.io.capture import read_capture

    fs = args.fs if args.fs is not None else 8000.0
    if args.mpx:
        audio = np.fromfile(args.infile, np.float32)
    else:
        x, _meta = read_capture(args.infile)
        audio = np.asarray(x)
    out_rec = decode_cw(audio, fs)
    out = _open_out(args)
    out.write(json.dumps({"text": out_rec["text"],
                          "wpm": round(out_rec["wpm"], 1),
                          "tone_hz": round(out_rec["tone_hz"], 1)}) + "\n")
    _close_out(out)
    print(f"decoded {len(out_rec['text'])} chars at "
          f"{out_rec['wpm']:.0f} WPM", file=sys.stderr)


def _same(args) -> None:
    """SAME/EAS subcommand: real f32 audio (--mpx) or AM IQ capture -> 520.83
    Bd AFSK decode -> header JSON lines (one per burst)."""
    from srcdsp_tpu_torch.chains.same import decode_same_audio, same_parse

    fs = args.fs if args.fs is not None else 12500.0
    audio = _am_audio(args)
    out = _open_out(args)
    bursts = decode_same_audio(audio, fs, device=args.device)
    for b in bursts:
        rec = same_parse(b)
        out.write(json.dumps({"raw": b, **(rec or {})}) + "\n")
    _close_out(out)
    print(f"decoded {len(bursts)} SAME bursts", file=sys.stderr)


def _rtty(args) -> None:
    """RTTY subcommand: complex-baseband FSK capture -> async deframe -> ITA2
    text."""
    from srcdsp_tpu_torch.chains.rtty import decode_rtty
    from srcdsp_tpu_torch.io.capture import read_capture

    x, _meta = read_capture(args.infile)
    text = decode_rtty(_on(args, np.asarray(x).astype(np.complex64)), args.sps, args.dev)
    out = _open_out(args)
    out.write(text + "\n")
    _close_out(out)
    print(f"decoded {len(text)} RTTY characters", file=sys.stderr)


def _navtex(args) -> None:
    """NAVTEX subcommand: complex-baseband FSK capture (100 Bd, +-dev) ->
    SITOR-B diversity decode -> parsed message JSON."""
    from srcdsp_tpu_torch.chains.navtex import decode_navtex_audio, navtex_parse
    from srcdsp_tpu_torch.io.capture import read_capture

    x, _meta = read_capture(args.infile)
    text, erasures = decode_navtex_audio(_on(args, np.asarray(x).astype(np.complex64)),
                                         args.sps, args.dev)
    rec = navtex_parse(text)
    out = _open_out(args)
    out.write(json.dumps({
        "ok": rec is not None, "erasures": int(erasures),
        "text": text, **(rec or {})}) + "\n")
    _close_out(out)
    print(f"NAVTEX decode: {'ok' if rec else 'no frame'}, "
          f"{erasures} erasures", file=sys.stderr)


def _sstv(args) -> None:
    """SSTV subcommand: NBFM IQ capture (or raw f32 audio with --mpx) ->
    instantaneous-frequency decode (Martin M1) -> binary PPM (P6, 8-bit
    RGB)."""
    from srcdsp_tpu_torch.chains.sstv import make_sstv_params, sstv_decode

    fs = args.fs if args.fs is not None else 11025.0
    p = make_sstv_params(fs=fs, height=args.lines, device=args.device)
    out = sstv_decode(p, _fm_mpx(args, args.infile))
    if not out["ok"]:
        raise SystemExit("no SSTV VIS header found")
    pix = (np.clip(out["image"], 0, 1) * 255.0 + 0.5).astype(np.uint8)
    with open(args.outfile, "wb") as fo:
        fo.write(b"P6\n%d %d\n255\n" % (pix.shape[1], pix.shape[0]))
        fo.write(pix.tobytes())
    print(f"decoded SSTV VIS {out['vis']}: {pix.shape[1]}x{pix.shape[0]}",
          file=sys.stderr)


def _ax25(args) -> None:
    """AX.25/APRS subcommand: real f32 audio (Bell-202 AFSK) -> FSK demod ->
    HDLC/FCS deframe -> parsed frames as JSON lines."""
    from srcdsp_tpu_torch.chains.ax25 import decode_ax25_audio

    if args.fs is None:
        args.fs = 13200.0
    if abs(args.fs / 1200.0 - round(args.fs / 1200.0)) > 1e-9:
        raise SystemExit(
            f"--fs {args.fs} is not an integer multiple of 1200 Hz; "
            f"decode_ax25_audio needs integer samples/bit - resample "
            f"the audio first (13200, 24000, 48000 all work)")
    audio = np.fromfile(args.infile, np.float32)
    fm = 1200.0 / args.fs
    fsp = 2200.0 / args.fs
    sps = int(round(args.fs / 1200.0))
    recs = decode_ax25_audio(audio, sps, fm, fsp, device=args.device)
    out = _open_out(args)
    for r in recs:
        out.write(json.dumps({
            "start_bit": r["start_bit"],
            "src": f"{r['src'][0]}-{r['src'][1]}",
            "dest": f"{r['dest'][0]}-{r['dest'][1]}",
            "path": [f"{c}-{s2}" for c, s2 in r["path"]],
            "info": r["info"].decode(errors="replace")}) + "\n")
    _close_out(out)
    print(f"decoded {len(recs)} AX.25 frames", file=sys.stderr)


_DRIVERS = {"mod": _modulate, "fecenc": _fec, "fecdec": _fec, "scan": _scan, "scf": _scf,
            "adsb": _adsb, "ais": _ais, "rds": _rds, "gps": _gps, "pocsag": _pocsag,
            "ax25": _ax25, "css": _css, "acars": _acars, "sstv": _sstv, "navtex": _navtex,
            "rtty": _rtty, "same": _same, "cw": _cw, "apt": _apt, "mux": _mux}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="srcdsp_tpu_torch.cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("chain", choices=_CHAINS)
    p.add_argument("infile")
    p.add_argument("outfile", nargs="?", default=None,
                   help="output path (optional for `gen`, whose single "
                        "positional is the output)")
    p.add_argument("--center", type=float, default=0.0,
                   help="channel center, cycles/sample")
    p.add_argument("--decim", type=int, default=4)
    p.add_argument("--sps", type=int, default=8)
    p.add_argument("--order", type=int, default=4, help="M for M-PSK")
    p.add_argument("--dev", type=float, default=0.05,
                   help="FSK deviation, cycles/sample at the decimated rate")
    p.add_argument("--taps", type=int, default=64)
    p.add_argument("--cutoff", type=float, default=0.1)
    p.add_argument("--block", type=int, default=1 << 16)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--ckpt-every", type=int, default=16)
    p.add_argument("--tracking", action="store_true",
                   help="closed-loop Gardner/Costas tracking (fsk/psk) "
                        "instead of the feedforward estimators - for "
                        "captures with a drifting symbol clock")
    p.add_argument("--channels", type=int, default=64,
                   help="bank size M (channelize)")
    p.add_argument("--taps-per-phase", type=int, default=8,
                   help="prototype taps per phase (channelize)")
    p.add_argument("--demod", choices=["none", "psk"], default="none",
                   help="per-channel demod after the bank (channelize)")
    p.add_argument("--audio-decim", type=int, default=4,
                   help="audio decimation after the discriminator/"
                        "envelope (fm/am)")
    p.add_argument("--deemph-tau", type=float, default=None,
                   help="FM de-emphasis RC constant in AUDIO samples "
                        "(e.g. 75e-6*fs_audio); omit to disable")
    p.add_argument("--gen", choices=["tone", "chirp", "noise"],
                   default="tone", help="gen: signal kind")
    p.add_argument("--num-samples", type=int, default=1 << 20,
                   help="gen: output length")
    p.add_argument("--f0", type=float, default=-0.2,
                   help="gen chirp: start frequency")
    p.add_argument("--f1", type=float, default=0.2,
                   help="gen chirp: end frequency")
    p.add_argument("--snr", type=float, default=None,
                   help="gen: add AWGN at this SNR (dB)")
    p.add_argument("--fmt", choices=["cf32", "ci16", "cu8", "ci8"],
                   default="cf32", help="gen: output capture format")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stereo", action="store_true",
                   help="fm: decode the stereo MPX (interleaved L,R out)")
    p.add_argument("--pilot", type=float, default=19e3 / 240e3,
                   help="fm --stereo: pilot frequency in cycles/sample at "
                        "the post-decim (MPX) rate")
    p.add_argument("--up", type=int, default=1,
                   help="resample: interpolation factor L")
    p.add_argument("--down", type=int, default=1,
                   help="resample: decimation factor M")
    p.add_argument("--analyze", action="store_true",
                   help="scan: also estimate baud + PSK order per band")
    p.add_argument("--conj", action="store_true",
                   help="scf: conjugate SCF (carrier/2fc features) "
                        "instead of the standard SCF (baud features)")
    p.add_argument("--scf-np", type=int, default=64,
                   help="scf: spectral channels Np")
    p.add_argument("--scf-p", type=int, default=256,
                   help="scf: accumulated frames P")
    p.add_argument("--scf-thresh", type=float, default=0.35,
                   help="scf: detection threshold relative to the PSD "
                        "peak (noise floor ~4.4/sqrt(P))")
    p.add_argument("--mag", action="store_true",
                   help="adsb: input is raw f32 magnitude, not IQ")
    p.add_argument("--sps-half", type=int, default=1,
                   help="adsb: samples per 0.5us half-bit (1 at 2 Msps)")
    p.add_argument("--adsb-thresh", type=float, default=3.0,
                   help="adsb: preamble score threshold")
    p.add_argument("--scan-nfft", type=int, default=4096,
                   help="scan: Welch PSD size")
    p.add_argument("--mpx", action="store_true",
                   help="rds: input is raw f32 MPX, not FM IQ "
                        "(--pilot gives the pilot freq in cycles/sample "
                        "at the capture rate, shared with fm --stereo)")
    p.add_argument("--fs", type=float, default=None,
                   help="sample rate in Hz (ax25 audio, default 13200; "
                        "apt MPX/IQ, default 20800 - must be a "
                        "multiple of 4160)")
    p.add_argument("--prn", default="all",
                   help="gps: PRN 1..32 or 'all'")
    p.add_argument("--doppler-bins", type=int, default=10,
                   help="gps: search +-K half-bins of 1/(2N) cyc/sample")
    p.add_argument("--gps-thresh", type=float, default=6.0,
                   help="gps: peak/median detection ratio")
    p.add_argument("--timing-forget", type=float, default=0.5,
                   help="O&M timing accumulator memory (fsk): ~0.95 for "
                        "smooth CPM (GMSK/MSK) whose d^2 timing tone is "
                        "weak; default 0.5 for square-pulse FSK")
    p.add_argument("--mod", choices=["psk", "qam", "fsk", "gmsk"],
                   default="psk",
                   help="modulation for the `mod` chain (transmit)")
    p.add_argument("--bt", type=float, default=0.3,
                   help="GMSK Gaussian BT product (mod --mod gmsk)")
    p.add_argument("--code", choices=["ldpc", "turbo", "polar", "conv",
                                      "rs", "bch", "golay"],
                   default="ldpc",
                   help="fecenc/fecdec: code family (conv = K=7 Viterbi "
                        "over bits; rs = RS(255,223) over BYTES, decode "
                        "reads received bytes directly; bch = binary "
                        "BCH(2^m-1) over bits, t from --fec-t)")
    p.add_argument("--fec-t", type=int, default=2,
                   help="bch: correctable bit errors per codeword")
    p.add_argument("--fec-n", type=int, default=504,
                   help="fec: codeword length (ldpc/polar)")
    p.add_argument("--fec-k", type=int, default=128,
                   help="fec: info length (polar) / block length (turbo)")
    p.add_argument("--fec-iters", type=int, default=10,
                   help="fec: decoder iterations (ldpc/turbo)")
    p.add_argument("--hard", action="store_true",
                   help="fecdec: input is u8 hard bits (mapped to +-4 "
                        "LLRs) instead of f32 LLRs")
    p.add_argument("--lines", type=int, default=256,
                   help="sstv: image height (Martin M1 standard 256)")
    p.add_argument("--css-sf", type=int, default=8,
                   help="css: spreading factor (2^sf chips/symbol)")
    p.add_argument("--css-cr", type=int, default=4,
                   help="css: parity bits per nibble codeword (1-4)")
    p.add_argument("--css-len", type=int, default=16,
                   help="css: payload length in bytes (implicit header)")
    p.add_argument("--device", default=None,
                   help="torch device the chains run on: the current CUDA "
                        "card by default (the CLI raises without one); "
                        "`cpu` runs the plain versions on the host")
    args = p.parse_args(argv)

    args.device = resolve(args.device)

    if args.order < 2 or args.order > 256 or args.order & (args.order - 1):
        p.error(f"--order must be a power of two in [2, 256], got {args.order}")

    if args.chain == "gen":
        # gen takes only an output path; `gen out.iq` parses it as infile
        args.outfile2 = args.outfile or args.infile
        _gen(args)
        return

    if args.outfile is None:
        p.error("outfile is required")

    if args.chain == "css" and not 1 <= args.css_len <= 255:
        p.error(f"--css-len must be in [1, 255], got {args.css_len}")
    if args.chain == "apt":
        if args.fs is None:
            args.fs = 20800.0
        if args.fs % 4160:
            p.error(f"--fs must be a multiple of the 4160 word rate, "
                    f"got {args.fs}")
    if args.chain in _DRIVERS:
        _DRIVERS[args.chain](args)
        return

    if args.chain == "channelize":
        # block must be a whole number of bank frames (and of symbols when
        # demodulating at sps samples/symbol per channel)
        q = args.channels * (args.sps if args.demod == "psk" else 1)
        args.block -= args.block % q
        _channelize(args)
        return

    # block must be a whole number of output symbols / decimated samples;
    # fm/am additionally need whole de-emphasis/DC-block IIR blocks (128)
    # at their processing rate
    if args.chain in ("fsk", "psk", "dqpsk", "qam"):
        q = args.decim * args.sps
    elif args.chain == "fm":
        q = args.decim * args.audio_decim
        if args.deemph_tau is not None:
            q *= 128
    elif args.chain == "am":
        q = args.decim * args.audio_decim * 128
    else:
        q = args.decim
    args.block -= args.block % q
    dev = args.device
    per_sym = args.block // (args.decim * args.sps)

    if args.chain == "fsk":
        from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
        params = make_fsk_params(args.center, args.taps, args.cutoff,
                                 args.decim, args.sps, args.dev,
                                 timing_forget=args.timing_forget, device=dev)
        if args.tracking:
            from srcdsp_tpu_torch.chains.tracking import fsk_track_apply, fsk_track_init
            _stream(args, params, fsk_track_init(params), fsk_track_apply,
                    out_fmt="u8", out_per_block=per_sym)
        else:
            _stream(args, params, fsk_init(params), fsk_apply,
                    out_fmt="u8", out_per_block=per_sym)
    elif args.chain == "psk":
        from srcdsp_tpu_torch.chains.psk import make_psk_params, psk_apply, psk_init
        params = make_psk_params(args.center, args.decim, args.sps,
                                 order=args.order, device=dev)
        if args.tracking:
            from srcdsp_tpu_torch.chains.tracking import psk_track_apply, psk_track_init
            _stream(args, params, psk_track_init(params), psk_track_apply,
                    out_fmt="u8", out_per_block=per_sym)
        else:
            _stream(args, params, psk_init(params), psk_apply,
                    out_fmt="u8", out_per_block=per_sym)
    elif args.chain == "dqpsk":
        from srcdsp_tpu_torch.chains.dqpsk import dqpsk_apply, dqpsk_init, make_dqpsk_params
        params = make_dqpsk_params(args.center, args.decim, args.sps, device=dev)
        _stream(args, params, dqpsk_init(params), dqpsk_apply, out_fmt="u8",
                out_per_block=per_sym)
    elif args.chain == "qam":
        from srcdsp_tpu_torch.chains.qam import make_qam_params, qam_apply, qam_init
        params = make_qam_params(args.center, decim=args.decim, sps=args.sps,
                                 order=args.order, device=dev)
        _stream(args, params, qam_init(params), qam_apply, out_fmt="u8",
                out_per_block=per_sym)
    elif args.chain == "fm" and args.stereo:
        # stereo: the chains.analog FM-stereo receiver; output is
        # interleaved L,R f32 frames
        from srcdsp_tpu_torch.chains.analog import (
            fm_stereo_rx_apply, fm_stereo_rx_init, make_fm_stereo_rx)

        params = make_fm_stereo_rx(args.center, args.decim, dev=args.dev,
                                   pilot=args.pilot,
                                   audio_decim=args.audio_decim,
                                   num_taps=args.taps,
                                   deemph_tau=args.deemph_tau, device=dev)

        def apply_fn(p_, state, xb):
            state, lr = fm_stereo_rx_apply(p_, state, xb)
            return state, lr.transpose(-1, -2)   # frame-interleave L,R

        _stream(args, params, fm_stereo_rx_init(params), apply_fn,
                out_fmt="f32",
                out_per_block=2 * (args.block // (args.decim * args.audio_decim)))
    elif args.chain == "fm":
        from srcdsp_tpu_torch.chains.analog import fm_apply, fm_init, make_fm_params
        params = make_fm_params(args.center, args.decim, dev=args.dev,
                                audio_decim=args.audio_decim,
                                num_taps=args.taps,
                                deemph_tau=args.deemph_tau, device=dev)
        _stream(args, params, fm_init(params), fm_apply, out_fmt="f32",
                out_per_block=args.block // (args.decim * args.audio_decim))
    elif args.chain == "am":
        from srcdsp_tpu_torch.chains.analog import am_apply, am_init, make_am_params
        params = make_am_params(args.center, args.decim,
                                audio_decim=args.audio_decim,
                                num_taps=args.taps, device=dev)
        _stream(args, params, am_init(params), am_apply, out_fmt="f32",
                out_per_block=args.block // (args.decim * args.audio_decim))
    elif args.chain == "resample":
        from srcdsp_tpu_torch.ops.resample import resample_apply, resample_init
        from srcdsp_tpu_torch.ops.window import lowpass

        up, down = args.up, args.down
        if up < 1 or down < 1:
            p.error(f"--up/--down must be >= 1, got {up}/{down}")
        if args.block < down:
            p.error(f"--block {args.block} smaller than --down {down}")
        # anti-alias/anti-image cutoff at the tighter of the two rates
        cutoff = 0.5 / max(up, down) * 0.9
        taps = torch.as_tensor((lowpass(args.taps, cutoff) * up).astype(np.float32),
                               device=dev)     # unit passband gain

        def apply_fn(params, state, xb):
            return resample_apply(taps, state, xb, up=up, down=down)

        args.block -= args.block % max(down, 1)    # N*up % down == 0
        _stream(args, None, resample_init(args.taps, up, device=dev), apply_fn,
                out_fmt="cf32", out_per_block=args.block * up // down)
    else:
        from srcdsp_tpu_torch.ops.fir import fir_apply, fir_init
        from srcdsp_tpu_torch.ops.nco import freq_to_word, nco_apply, nco_init, word_tensor
        from srcdsp_tpu_torch.ops.window import lowpass

        taps = torch.as_tensor(lowpass(args.taps, args.cutoff).astype(np.float32), device=dev)
        word = word_tensor(freq_to_word(-args.center), dev)

        def apply_fn(params, state, xb):
            nco_s, fir_s = state
            nco_s, m = nco_apply(word, nco_s, xb)
            fir_s, y = fir_apply(taps, fir_s, m, decim=args.decim)
            return (nco_s, fir_s), y

        _stream(args, None, (nco_init(device=dev), fir_init(args.taps, device=dev)), apply_fn,
                out_fmt="cf32", out_per_block=args.block // args.decim)


if __name__ == "__main__":
    main()
