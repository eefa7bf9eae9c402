#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (srcdsp_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from srcdsp_tpu_torch/csrc with nvcc (sm_90a, one
   nvcc per source, in parallel) and the ingest framer with make and g++;
   print the registers, spill bytes and resident blocks per SM of K1 (each
   decim's instantiation), K20, the complex-taps (K4, K5, K17) and FSK (K2,
   K3, K7) rings at decim 2 and 4, K11 (each N), the resampler (K8, K9 at
   config 2's 3/4) and the bank (K12, K13 at M 64, 128, 256 and 96, with
   their tile) and K18 (each decim's instantiation); ptxas reports no spill
   in any complex-taps, FSK, resample, bank, K16 or K18 instantiation, and
   each ring keeps 4 blocks an SM (the resampler 2);
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
   fused_mc channel 0 bit for bit;
9. the FFT: the four configs.build_fft variants at 8192 frames of 4096 (K10
   in natural, digit and kernel-natural order; the matrix FFT of
   ops.fft_planes), each timed, with 5 N log2 N GFLOP/s and the share of the
   bound; the conj inverse round trip above 110 dB; the three K10 variants
   and cuFFT (torch.fft.fft) timed in turns on the same frames, one call per
   turn (host path included) and 5 back to back (the card's time);
10. config 3 end to end: 16 channels x 8,355,840 samples (2^23 rounded down
   to 170 blocks of 49,152) through K11 (1024 taps, fft 4096, hop 3072) in
   one launch, equal bit for bit to 5 chunks through FftConvStream; SNR >
   100 dB against the plain K11 on the card and > 90 dB against the C++
   oracle's direct FIR (first 2^16 samples of channels 0 and 15); then the
   three variants of configs.build_config3_onchip, each timed;
11. config 5 end to end: 64 channels x 2^19 frames (33,554,432 wideband
   samples) through the four variants of configs.build_config5_onchip (K13
   class-major + bank-stats tail, the serving path; K13 standard; K12 +
   the planes tail; the matmul bank), each timed with its wideband Ms/s;
   K13 in one launch equal bit for bit to 4 chunks of 2^17 frames, each with
   its 128 history columns; a 64-channel QPSK wideband made on the card by
   the plain synthesis bank (2^15 symbols per channel, sps 4) decoded at
   SER 0 on every channel by fused, fused_std and bank, fused == fused_std;
   K12 > 100 dB against the C++ oracle's channelize on the first 2^16
   samples; the chan_8x128 fixture through K12 > 100 dB against its gold;
   the qpsk_256sym fixture through psk_apply on the card equal to its gold;
   configs.build_config5 (the complex tier, 2^16 frames), timed.
12. the coded tier: the coherent coded modem (configs.build_coded_modem:
   8 channels x 512 codewords of the z = 128 dual-diagonal code, n 1536,
   QAM16 at sps 2, 13 dB, made on the card by chains.tx; K1 mc -> plane
   demap -> K15), its K1 mc front end (33 taps, decim 2) within rel L2 1e-5
   of the plain version on the modem's planes before anything is timed,
   every syndrome clean and the decoded codewords equal to the
   transmitted ones; the coded FSK link (configs.build_coded_link: 4 x 256
   codewords of the (3,6) n = 504 code, 14 dB; K2 -> K14), info BER 0 and
   every word ok; the QC decoder alone (configs.build_ldpc qc at B 4096,
   6 iterations), decisions equal to the plain dense layered decoder on the
   words both converge; turbo (configs.build_turbo: t 512, 4 iterations,
   B 256, 1.5 dB) through K16, bits and posteriors equal to the plain
   turbo_decode_batch; each timed;
13. config 1's alternate front ends and the decimation tier: at config-1
   shape (2^26 samples, lowpass(64, 0.2), decim 2, word freq_to_word(0.11),
   out_tile 512, b_rows 32) K17 (history as its own operand) equal to K4 bit
   for bit, in one launch and in 4 chunks with carried history, and K18 (mix
   once by a factored phasor, on K1's ring since PR 13) within rel L2 2e-6
   of K1, the four timed in turns (K1 / K18 printed; K4 the same-run
   yardstick of K1); two DDCs (make_ddc(0.21, 0.004, 70 dB): D 187; make_ddc(0.21,
   0.0155): D 48, four half-bands and a residual 3) over 32 channels made on
   the card, 4 blocks of D*2^14 samples each: in-band tone within 5 %,
   residual below -55 dB, 4 blocks against one within 3e-6, channel 0
   against the port's CPU run within rel L2 1e-5, timed; the IIR DC blocker
   over 32 x 2^22 above 80 dB against the C++ oracle's iir_stream, its two
   inter-block forms within rel L2 1e-5, timed; the AGC settled within 5 %
   of its target; Welch of the D = 48 output peaking at the tone's bin;
14. the distribution tier: the card count, then on C14_SHARDS time shards of
   one card (and again on 2 shards across cuda:0 and cuda:1 where the
   machine has two cards; else "cross-card leg: 1 device, not run"): K19 on
   config 1's planes (halo 128) and config 3's 32 rows (halo 1024), equal to
   dist.halo's copies in one launch per card, timed in turns against a copy_
   yardstick; K20 and
   mix_fir_time_sharded over 2 buffers of 2^26, both equal to K1 over the
   unsharded stream, carried tails equal, the three timed in turns (CUDA
   events on one card; on two, the host clock around a synchronize of both);
   fftconv_time_sharded over 5 shards (phase 10's chunks) in 2 buffers equal
   to one K11 launch; build_config5's mesh form (indices equal to the single
   device, soft within 2e-5) and the pre-filter -> channelizer -> PSK stream
   of __graft_entry__.py in 2 buffers (the FIR stream equal to fir_full and
   the channelizer stream to channelize_full, PSK indices equal, soft
   within 2e-5); codeword-sharded K14, block-sharded K16 and channel-sharded
   FSK through map_shards against the unsharded calls;
15. the classical FEC tier, plain torch (no kernel of ours, so after the
   launch counts are read), every result on the card equal by torch.equal to
   the port's own CPU run on the same numpy-made inputs, each timed (CUDA
   events) with its coded Mb/s and the torch operations one call dispatches:
   the CCSDS link of tests/e2e/test_concat_coding.py at 512 messages (CRC-32
   on the card equal to binascii.crc32, RS(255,223), symbol interleaving at
   depth 4, 128 terminated K=7 [171, 133] frames of 8,160 bits, BPSK at
   Eb/N0 2.5 dB from numpy seed 1, Viterbi, RS decode, CRC: inner symbol
   errors left, every message back); RS alone (512 x 16 byte errors),
   Viterbi alone (B 512, T 512, noise 0.6), BCH(31,21) (4096 x 2 errors),
   Golay (65,536 words with 0-3 errors corrected, 4,096 with 4 all flagged),
   polar N 256, K 128 at 3 dB (SC at B 32,768; SC-list L 8 at B 1,024, the
   one-hot entry point with and without fast equal to it), the 802.11 scrambler over 32 x
   2^20 bits (two uneven chunks == one call) and an HDLC round trip of 2^20
   bits with its two flags found;
16. the synchronization and block-equalizer tier, plain torch except the
   coded OFDM modem's K15, at the JAX probes' widths (bench/tracking_onchip.py,
   ofdm_onchip.py, scfde_onchip.py, ofdm_modem_onchip.py), every step's
   decisions equal to the port's own CPU run of the same call on the same
   numpy-made inputs and to the transmitted data: the feedforward PSK
   tracker over 8 x 8*2^16 samples (QPSK, sps 4, block 128) on a warped
   clock (SER 0) and, ragged, on a 3000 ppm clock (valid masks equal, the
   emitted count above nominal, SER 0); the closed-loop PSK (block 8192) and
   FSK (block 2^14) plane trackers over 8 channels, 2 blocks each (the probe
   ran 8: a depth cut for time; mismatch against the CPU run <= 1e-3, errors
   0 after 64 symbols); the OFDM planes receiver (8 x 16,384 16-QAM symbols,
   soft within rel L2 1e-5 of the CPU run) and the SC-FDE planes receiver
   (8 x 4,096 QPSK blocks of 256), SER 0; the coded OFDM modem (8 x 512
   codewords of the z = 128 code, 16-QAM, 15 dB, 4 pilot symbols, 6
   iterations) with every syndrome clean, decoded == transmitted and K15's
   launch count rising across the call; OOK over 32 x 2^20 samples (sps 8,
   rise 3), BER 0. Each step prints its ms a call (CUDA-event median of 5;
   the closed loops by the host clock, marked), aggregate Ms/s, torch ops a
   call and us an op, and the phase its total seconds;
17. the CSS modem and the rest of the plane tier, plain torch (no kernel of
   ours), each step on the card held against the port's own CPU run of the
   same call on the same numpy-made inputs (the batched chains on their first
   4 channels) and timed: the coded CSS link of bench/css_modem_onchip.py
   (sf 8, cr 4, 1,024 frames of 20-byte payloads at -11 dB: the folded-DFT
   LLR planes within rel L2 1e-5, then the batch soft decode on the card,
   every frame back, payloads and flags equal; coded Mb/s); the demod planes
   at bench/css_onchip.py's defaults (16,384 symbols at -5 dB, direct and
   four-step, and four-step at sf 11), shifts equal, SER 0; the burst
   receiver over 16 bursts with gaps drawn uniformly over 200-4000 chips and
   CFOs uniformly over +-2.5 bins at 0 dB, every payload back, results and
   starts equal, and two more bursts on the wraps of the sync's solve (N/2
   off the frame grid, a CFO of exactly 1.5 bins) both decoded; the blind scan at nfft 4,096 over 2^22
   samples (three signals found, detections equal) and detect_css finding
   sf 9; frame sync, MSK, pi/4-DQPSK, FHSS dehop, FM, AM, SSB and the FM
   stereo receiver over 32 x 2^20 samples, DSSS acquire + RAKE and FHSS
   acquire on one channel, block LMS and CMA over 8 x 2^16, MLSE, RLS and
   the DFE over a few thousand symbols (host clock), decisions equal and
   soft outputs within rel L2 1e-5;
18. the ops tier, plain torch (no kernel of ours), each step on the card held
   against the port's own CPU run of the same call and against the reference
   tests' physics, timed: the range-Doppler map and 2-D CFAR of a 256 x 8,192
   cube (8 targets found at their cells; a noise cube's false-alarm rate
   within 0.3-3x of the design); CA and GO CFAR over 64 x 2^20 cells (rate
   in the reference test's band); the impairment estimators and the impulse
   blanker over 32 x 2^20 samples (estimates within the reference tests'
   bounds, 16 streamed blocks equal to one shot); FAM at Np 256, P 1,024
   (BPSK's 2fc line, 4x QPSK's there, the baud line); the acceleration
   search at N 2^16 over 121 rates (frequency within a bin, drift within a
   grid step, dechirp phasors equal to numpy's); DPD ILA (> 20 dB) and the
   predistorter over 32 x 2^20 (8 blocks equal to one shot); FRESH planes
   at 2^21 samples (== CPU within 5e-3 of the RMS, SINR within 0.2 dB of
   fresh_apply, > 6 dB over Wiener); a 16-element ULA over 2^20 snapshots
   (covariance in 16 blocks, the three spectra find the sources) and the
   MVDR -> PSK link (SER 0); ZF, MMSE and ML (4x4 16-QAM over 65,536
   candidates too) equal to what was sent at 80 dB, ML <= MMSE <= ZF on an
   ill-conditioned channel, the 2x2 MIMO-OFDM link;
19. the fifteen protocol receivers, plain torch (no kernel of ours), each at
   a capture its users record, every message sent gated to come back and a
   prefix gated equal to the port's own CPU run: one minute of one AIS
   channel (2,250 slots at 9,600 bd, 4,608,000 samples, 500 type-1 frames,
   GMSK BT 0.4, CFO, noise), 60 s of APRS (30 frames), 1,024 BLE packets as
   1,024 channels of one FSK call, 1 s of ADS-B at 2 Msps (1,000 DF17
   frames), 16 ACARS blocks in 30 s at 48 kHz, 20 POCSAG pages in 30 s, 10 s
   of RDS MPX at 228 kHz, a GPS cold search (32 PRNs x 41 Dopplers x 10 ms,
   four satellites at their cells) and one 6 s subframe tracked (nav bits and
   the TLM preamble), 5 minutes of NAVTEX, 60 s of RTTY, three SAME headers,
   a 12-minute APT pass (1,440 lines), a full Martin M1 SSTV image, 60 s of
   CW and 60 minutes of DCF77; each step's time (host clock; its card part
   by CUDA events), rate and torch operations a call.
20. the port's CLI (python -m srcdsp_tpu_torch.cli) on the card, file to
   file, in a temporary directory removed at the end: a 2^26-sample FSK
   capture (config 4's signal, 512 MiB of cf32) streamed in blocks of 2^20 as
   its own process, unbroken, then again with a checkpoint every 8 blocks,
   SIGKILLed once a checkpoint of block >= 16 is on disk and resumed: the
   resumed file byte-equal to the unbroken one, the checkpoint gone, BER 0;
   the time of each leg of a block (read + decode, H2D, chain, D2H + write);
   a checkpoint written in the JAX package's format (uint32 phase word) from
   the port's state at block 8, resumed to the same bytes; config 5's form in
   files (channelize --demod psk over 2^25 samples of a 64-channel QPSK
   wideband, SER 0, each file equal to the --device cpu run on 2^20;
   channelize to cf32 and mux back, both within rel L2 1e-5 of the CPU);
   fecenc / fecdec --code ldpc over 16,384 codewords through K14 (3 bit
   errors a word, then BPSK LLRs at 6 dB: decoded == sent, K14's launches
   rising, the first 256 codewords equal to the plain K14 on the CPU); every
   other chain once (fir, resample, fm, fm --stereo, am, psk, qam, dqpsk,
   fsk on GMSK, both tracking loops, mod psk / qam / fsk / gmsk, gen, scan
   --analyze, scf, the six other codes, the fourteen decoder subcommands),
   each equal to its --device cpu run (decisions and records equal, floats
   within rel L2 1e-5) and what was sent back; bench/fault_injection.py's
   stream over 8 time shards of one card, dropped after buffer 3 and
   restored into a fresh mesh, bit-equal to the unbroken single-device run;
   debug.checked around fsk_apply at 2^20, its cost a call and a NaN named.
21. the multi-process tier: fresh worker processes (dist.multihost_check,
   dist.fault_injection_multihost), the kernels built once here before any
   starts; 2 ranks x 2 shards sharing the card over gloo (card tensors
   staged through the host, counted), and with two cards also NCCL with one
   rank a card: config 5 (64 channels x 2^16 frames) == phase 14's
   one-process mesh form by torch.equal, indices == the single-device
   build, soft within 2e-5; K1 over 2^26 samples and K11 over config 3's 16
   channels == one unsharded call by torch.equal, tails exact; the pipeline
   on 3 ranks (M = 24) == its one-process form; the 2 -> 1 fault injection
   (save_orbax by both ranks, restore_orbax in this process) == the
   uninterrupted run; the capture case (3 blocks of 2^26 ci16 samples, each
   rank decoding and copying only its own shards, K20 over IPC) == the
   one-process stream, K19 and K20 launched. Printed: the backend, each
   rank's step time (CUDA events), the staged bytes and their time, the
   phase's seconds.
22. a capture straight onto a time-sharded mesh: a ci16 file of 4 x 2^26
   samples (seeded noise, 1 GiB) streamed unsharded through K1 on [tail |
   block] (the yardstick), then through io.capture.device_blocks with
   time_sharding(mesh, 2) and K20 (dist.multihost_check.stream_k20) onto 4
   shards of one card and, where the machine has two cards, one shard a
   card: every block's output and the carried tail == the yardstick's by
   torch.equal, one host-to-device copy a shard a block (io.capture.H2D)
   into a buffer of its own; the Ms/s of each pass file to result (host
   clock), K20 and K1 on a resident block in turns, and one shard's host
   decode and host-to-device copy.
23. K10 and K11 past the powers of two up to 8192 (kernels.fft_pallas.fft_plan:
   csrc/fft_mixed.cu, one block a frame up to 16384; csrc/fft_4step.cu, the
   four-step, from 17408 to 2^20; both on csrc/fft_lines.cuh's compile-time
   register schedules, a four-step line of no register shape a Bluestein
   line on two register transforms): the new kernels' registers, local
   bytes and blocks per SM, no spill; the plans at 17408, 1024 x 1021 and
   884,736 hold only register and Bluestein lines; K10 over 2^25 samples at
   3072 (n2 384), 5120, 11264, 12288, 16384, 21504 (96 x 224, the odd part
   21 on two register lines), 65536 (n2 128), 2^20 (n2 1024), 1024 x 1021
   (n2 128, the 1021-point rows a Bluestein line) and 27 x 2^15 = 884,736
   (the 864-point rows a Bluestein line) against its plain version, timed
   with cuFFT in turns (one call, 5 back to back), each row beside the
   earlier bodies' time and ratio to cuFFT where they were measured; K11 on one
   chunk of config 3 with 4096 taps (fft 16384, one block a frame), with
   3000 taps at fft 12288, with 4352 taps at the four-step's first size
   17408 and with 4096 taps at 1024 x 1021 against its plain version and
   cuDNN conv1d; then, counts at 0, K10's three orders at every size
   (natural == kernel-natural == digit unscrambled by torch.equal; > 110 dB
   against complex128; conj round trip > 110 dB), config 3 at 4096 taps, 16 x 8,355,840
   (one launch == 5 FftConvStream chunks == fftconv_time_sharded over 5
   shards == per-channel taps by torch.equal; > 100 dB against the plain
   K11, > 90 dB against the C++ oracle on channels 0 and 15), K11 at fft
   12288 over 16 x 8,331,264, K11's four-step at 17408 over 16 x 7,864,320
   and at 1024 x 1021 over 16 x 5 blocks of 8 frames (one launch == 5
   FftConvStream chunks; > 100 dB, > 90 dB).

Phase 3 also holds K10 (three orders, 8192 x 4096; SNR > 110 dB against
torch.fft in complex128, natural == digit + unscramble == kernel-natural by
torch.equal, natural_order=True running no transpose, each order's time as
a multiple of cuFFT's and its share of the bound, at least 4 resident blocks
per SM) and K11 (shared and per-channel taps, one config-3 chunk of
16 x 1,671,168) against their plain versions, with cuFFT (torch.fft.fft) and
cuDNN conv1d (TF32 off) as their library yardsticks, and K12 and K13 at the
config-5 shape ([2, 64, 128 + 2^19] phase-major, b_k 512; K13's Y == K12's,
class-major == standard permuted, by torch.equal), with one cuBLAS
torch.matmul of E_comb^T by a prestaged SS^T (TF32 off, staging left out)
as K12's yardstick and that matmul plus the plain stats epilogue as K13's,
and K12 and K13 at M = 128 (the FFT) and M = 96 (the direct DFT), 2^15
frames, against their plain versions (rel L2 1e-5, K13's Y == K12's).

Phase 3 also holds K14 (edge-form LDPC, [504, 1024], 10 iterations), K15 (QC
layered LDPC, [1536, 4096], 6 iterations) and K16 (max-log BCJR, the turbo's
first half [515, 256]) against their plain versions by torch.equal; no
PyTorch call computes min-sum or BCJR, so they have no library yardstick.
It holds K17 and K18 at config-1 shape against their plain versions (rel L2
1e-5 and 2e-6); no PyTorch call computes a mix with a FIR. It holds K19 on 4
column slices of config 1's body (halo 128; one launch per card) to
dist.halo's copies by torch.equal, with the copy_ of each halo as its
library yardstick, and K20 on
the same slices to its plain version per shard (rel L2 1e-5).

Launch counts are reset just before phase 4 and read after phase 14: every
kernel must have run on the main path. Phase 15 launches none of them;
phase 16 reads K15's count before and after its modem on its own; phases 17,
18 and 19 launch none; phase 20 reads K14's count around each `fecdec --code
ldpc` of the CLI and adds those launches to K14's row; phase 21's workers
count their K1 and K11 launches in their distributed steps (each worker
starts at 0, its warm-up call and rank 0's one-call comparisons left out),
and those are added to K1's and K11's rows (and K19's and K20's); phase 22
resets the counts before its passes and adds its K1 and K20 launches to
their rows; phase 23 times its bodies first, one row a body and size
(fft_mixed_3072 ... fft_4step_1045504, fftconv_mixed_16384,
fftconv_mixed_12288, fftconv_4step_17408, fftconv_4step_1045504), then
resets the counts before its path and gives each row the launches of its
body at its size there (fft, fft_digit, fft_nat, fftconv and
fftconv_per_channel count launches of the register body alone, which the
phase's path never runs). The last three lines are one JSON object per
kernel, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
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
# the FFT (bench/run.py run_fft): 8192 frames of 4096 points
FFT_BATCH, FFT_N, FFT_SNR_FRAMES = 8192, 4096, 256
# config 3 (bench/run.py run_config3_onchip): 16 channels, 2^23 samples per
# channel rounded down to 170 K11 blocks of 49,152, streamed as 5 chunks of 34
C3_CHANNELS, C3_CHUNK, C3_CHUNKS = 16, 34 * 49152, 5
C3_SAMPLES = C3_CHUNK * C3_CHUNKS
C3_ORACLE_SAMPLES = 1 << 16
# config 5 (bench/run.py run_config5_onchip): 64 channels, 2^19 frames, b_k 512,
# K13 chunks of 2^17 frames; the modulated check at 2^15 QPSK symbols of sps 4
C5_CHANNELS, C5_FRAMES, C5_BK, C5_CHUNKS = 64, 1 << 19, 512, 4
C5_NSYM, C5_SPS, C5_ORDER = 1 << 15, 4, 4
C5_ORACLE_SAMPLES, C5_COMPLEX_FRAMES = 1 << 16, 1 << 16
# the coded tier (bench/ldpc_onchip.py, turbo_onchip.py): K14 at B 1024, the QC
# decoder at B 4096; the dense layered gate runs in chunks of 256 codewords
C12_EDGES_BATCH, C12_QC_BATCH, C12_DENSE_CHUNK = 1024, 4096, 256
C12_MODEM_CHANNELS, C12_MODEM_WORDS, C12_LINK_CHANNELS, C12_LINK_WORDS = 8, 512, 4, 256
C12_TURBO_T, C12_TURBO_BATCH = 512, 256
# least operations counted per edge and iteration (min-sum), per state and step (BCJR)
MINSUM_OPS, BCJR_OPS = 12, 16
# phase 13: K17 chunks; the DDCs' channels, blocks and outputs per block; the IIR
C13_K17_CHUNKS, C13_CHANNELS, C13_DDC_BLOCKS, C13_DDC_BLOCK_OUT = 4, 32, 4, 1 << 14
C13_SETTLE, C13_IIR_SAMPLES, C13_ORACLE_SAMPLES = 256, 1 << 22, 1 << 16
# phase 14: time shards of config 1 (and K19 on config 3's 32 rows), K11's
# shards (phase 10's chunks), the distributed config-5 pipeline's pre-filter
# taps and buffers, the sharded FSK body's channels and symbols
C14_SHARDS, C14_FFT_SHARDS, C14_BUFFERS = 4, 5, 2
C14_PRE_TAPS, C14_FSK_CHANNELS, C14_FSK_SYMBOLS = 16, 8, 4096
# phase 15, the classical FEC tier: tests/e2e/test_concat_coding.py's chain
# at serving batch, then bench/fec_onchip.py's and bench/polar_onchip.py's shapes
C15_MESSAGES, C15_DEPTH = 512, 4
C15_RS_BATCH, C15_VIT_BATCH, C15_VIT_T, C15_VIT_NOISE = 512, 512, 512, 0.6
C15_BCH_BATCH, C15_GOLAY_WORDS, C15_GOLAY_FOUR = 4096, 65536, 4096
C15_POLAR_N, C15_POLAR_K, C15_POLAR_SNR = 256, 128, 3.0
C15_SC_BATCH, C15_SCL_BATCH, C15_SCL_L = 32768, 1024, 8
C15_SCR_STREAMS, C15_SCR_BITS, C15_HDLC_BITS = 32, 1 << 20, 1 << 20
# phase 16, the sync and block-equalizer tier, at the JAX probes' widths
# (bench/tracking_onchip.py, ofdm_onchip.py, scfde_onchip.py,
# ofdm_modem_onchip.py); the closed loops run 2 blocks (the probe ran 8: a
# depth cut for time), the OOK step a capture of 32 keyfob-class channels
C16_CHANNELS, C16_FF_SAMPLES, C16_FF_BLOCK, C16_RHO = 8, 8 << 16, 128, 3e-3
C16_TRACK_BLOCKS, C16_PSK_BLOCK, C16_FSK_BLOCK, C16_SETTLE = 2, 1 << 13, 1 << 14, 64
C16_OFDM_SYMBOLS, C16_SCFDE_BLOCKS = 16384, 4096
# the modem at 15 dB with 4 averaged pilot symbols: with one, the JAX
# package's link misses at 15 dB (ok 0.894, BASELINE.md) and needs 18
C16_MODEM_WORDS, C16_MODEM_Z, C16_MODEM_SNR, C16_MODEM_PILOTS = 512, 128, 15.0, 4
C16_OOK_CHANNELS, C16_OOK_SAMPLES, C16_OOK_SPS = 32, 1 << 20, 8
# phase 17, the CSS modem and the rest of the plane tier: bench/css_modem_onchip.py's
# coded link (sf 8, cr 4, 1,024 frames of 20 bytes at -11 dB) and bench/css_onchip.py's
# demod (16,384 symbols at -5 dB; sf 11 four-step too); 16 bursts through the stream
# receiver; tests/unit/test_blindscan.py's three signals over 2^22 samples; the batched
# chains at 32 x 2^20 samples (their CPU runs on the first 4 channels); the block
# equalizers at 8 x 2^16 and the per-symbol loops at a few thousand symbols (cuts for
# time, PERF.md)
C17_SF, C17_CR, C17_FRAMES, C17_PLEN, C17_SNR = 8, 4, 1024, 20, -11.0
C17_DEMOD_SYMS, C17_DEMOD_SNR, C17_SF_WIDE, C17_DETECT_SF = 16384, -5.0, 11, 9
C17_BURSTS, C17_STREAM_SNR = 16, 0.0
C17_SCAN_SAMPLES, C17_SCAN_NFFT = 1 << 22, 4096
C17_CHANNELS, C17_SAMPLES, C17_CPU_CHANNELS = 32, 1 << 20, 4
C17_EQ_CHANNELS, C17_EQ_SAMPLES = 8, 1 << 16
C17_MLSE_SYMBOLS, C17_RLS_SYMBOLS, C17_DFE_SYMBOLS = 4096, 1024, 2048
# phase 18, the ops tier at its users' sizes: a pulse-Doppler cube of 256 pulses x
# 8,192 range bins (8 targets), CFAR over 64 x 2^20 cells, the impairment estimators
# and the blanker over 32 x 2^20 samples, FAM at Np 256 x P 1,024, the acceleration
# search at N 2^16 over +-120/N^2 (121 rates), DPD ILA over 2^16 and the
# predistorter over 32 x 2^20 in 8 blocks, bench/fresh_onchip.py's FRESH (2^21
# samples, 24 taps, 2^14 training), a 16-element ULA over 2^20 snapshots (two unit
# sources and a jammer at 6 dB) and the MVDR -> PSK link over 2^16 symbols, MIMO
# detection over 2^20 vectors (4x4 16-QAM ML over 4,096) and the 2x2 MIMO-OFDM link
# over 1,024 symbols; CPU runs of the batched steps on their first C18_CPU_CHANNELS
# channels
C18_PULSES, C18_RANGE, C18_CHIRP, C18_TARGETS = 256, 8192, 512, 8
C18_CFAR_CHANNELS, C18_IMP_CHANNELS, C18_SAMPLES, C18_CPU_CHANNELS = 64, 32, 1 << 20, 4
C18_FAM_NP, C18_FAM_P, C18_ACCEL_N, C18_ACCEL_RATES = 256, 1024, 1 << 16, 120.0
C18_DPD_TRAIN, C18_DPD_CHANNELS, C18_DPD_BLOCKS = 1 << 16, 32, 8
C18_FRESH_N, C18_FRESH_TAPS, C18_FRESH_TRAIN = 1 << 21, 24, 1 << 14
C18_ELEMENTS, C18_SNAPSHOTS, C18_COV_BLOCKS, C18_ANGLES = 16, 1 << 20, 16, 961
C18_LINK_SYMS = 1 << 16
C18_MIMO_N, C18_ML16_N, C18_OFDM_SYMS = 1 << 20, 4096, 1024
# phase 19, the fifteen protocol receivers at captures their users record: one
# minute of AIS (2,250 slots, 500 frames), 60 s of APRS, 1,024 BLE packets, 1 s of
# ADS-B at 2 Msps (1,000 frames), 30 s of ACARS and of POCSAG, 10 s of RDS MPX, a
# GPS cold search (32 PRNs x 41 Dopplers x 10 ms) and a 6 s subframe tracked,
# 5 minutes of NAVTEX, 60 s of RTTY, three SAME headers, a 12-minute APT pass, a
# Martin M1 image, 60 s of CW and 60 minutes of DCF77; each gated whole, and a
# prefix of each (or the whole capture, where it is small) against the CPU run
C19_AIS_SLOTS, C19_AIS_FRAMES, C19_AIS_PREFIX = 2250, 500, 1 << 19
C19_AX25_SECONDS, C19_AX25_FRAMES, C19_AX25_PREFIX = 60, 30, 1 << 17
C19_BLE_PACKETS, C19_BLE_BITS, C19_BLE_PREFIX = 1024, 448, 32
C19_ADSB_SAMPLES, C19_ADSB_FRAMES, C19_ADSB_PREFIX = 2_000_000, 1000, 1 << 18
C19_ACARS_SECONDS, C19_ACARS_BLOCKS, C19_ACARS_PREFIX = 30, 16, 1 << 18
C19_POCSAG_SECONDS, C19_POCSAG_PAGES, C19_POCSAG_PREFIX = 30, 20, 1 << 16
C19_RDS_SAMPLES, C19_RDS_PREFIX = 2_280_000, 1 << 18
C19_GPS_ACQ_MS, C19_GPS_TRACK_MS, C19_GPS_TRACK_PREFIX, C19_GPS_CPU_PRNS = 10, 6000, 200, (3, 11)
C19_NAVTEX_CHARS, C19_NAVTEX_PREFIX, C19_RTTY_CHARS, C19_RTTY_PREFIX = 1800, 1 << 16, 300, 1 << 15
C19_APT_LINES, C19_APT_PREFIX, C19_SSTV_LINES, C19_SSTV_CPU_LINES, C19_SSTV_PREFIX = (
    1440, 1 << 20, 256, 8, 1 << 16)
C19_CW_WORDS, C19_DCF77_MINUTES = 16, 60
# phase 20, the CLI on the card, file to file: a 2^26-sample FSK capture (512 MiB of cf32,
# config 4's signal) in blocks of 2^20, a checkpoint every 8 blocks, SIGKILL once a
# checkpoint of block >= 16 is on disk; config 5's wideband (2^25 samples, 64 channels) and
# its CPU run on 2^20; fecdec --code ldpc over 16,384 codewords (the CPU run on 256); the
# other chains over 2^20 samples in blocks of 2^16 (the CPU runs on 2^17), the closed loops
# on 2^16 / 2^14 samples both ways; the fault-injection stream over 8 shards of one card
C20_FSK_SAMPLES, C20_BLOCK, C20_CKPT_EVERY, C20_KILL_AFTER, C20_LEG_BLOCKS = (
    1 << 26, 1 << 20, 8, 16, 8)
C20_WIDE_SAMPLES, C20_WIDE_PREFIX = 1 << 25, 1 << 20
C20_LDPC_WORDS, C20_LDPC_CPU_WORDS, C20_LDPC_HARD_ERRORS, C20_LDPC_SIGMA = 16384, 256, 3, 0.5
C20_STREAM_SAMPLES, C20_STREAM_BLOCK, C20_STREAM_PREFIX = 1 << 20, 1 << 16, 1 << 17
C20_TRACK_FSK, C20_TRACK_PSK, C20_SCAN_SAMPLES = 1 << 16, 1 << 14, 1 << 17
C20_FAULT_SHARDS, C20_FAULT_BUFFER, C20_CHECK_BLOCK = 8, 1 << 18, 1 << 20
# phase 21, the multi-process tier (dist.multihost_check --size full): 2 ranks x 2 shards
# (config 5 at 64 channels x 2^16 frames, K1 and K20 over 2^26 samples, K11 over config
# 3's 16 channels, K19 on config 1's planes at halo 128 and config 3's 32 rows at halo
# 1024), 3 ranks x 2 shards (the pipeline, M = 24), the 2 -> 1 fault injection; gloo on
# one card, and NCCL with one rank a card where the machine has two
C21_SHARDS, C21_TIMEOUT = 2, 420.0
# phase 22, a capture streamed straight onto a time-sharded mesh: 4 blocks of config
# 1's 2^26 samples (1 GiB of ci16), 4 shards of one card, then a shard a card on two
C22_BLOCKS, C22_SHARDS = 4, 4
# phase 23, K10 and K11 past the powers of two up to 8192: K10 over 2^25 samples a size
# (frames rounded down to whole groups of 16) at the JAX kernels' sizes (n2 384 at 3072,
# 1024 at 2^20, else 128), the SNR against complex128 on the first C23_SNR_SAMPLES; config 3
# with 4096 taps (fft 16384, hop 12,288: 16 x 8,355,840 = 85 blocks of 8 frames, 5 chunks
# of 17), K11 at fft 12288 with 3000 taps (hop 9216, 113 blocks of 8 frames) and at the
# four-step's first size 17408 with 17408 / 4 taps as config 3 has at 16384 (hop 12,288:
# 16 x 7,864,320 = 80 blocks of 8 frames, 5 chunks of 16; its 136-point columns a
# Bluestein line) and at 1024 x 1021 with 4096 taps, whose 1021-point rows are a
# Bluestein line (5 blocks of 8 frames, 5 chunks of 1); K10 also at 21504 = 96 x 224 (the
# odd part 21 split across two register lines), at 1024 x 1021 (the Bluestein rows) and
# at 27 x 2^15 = 884,736 (1024 x 864: the 864-point rows, radix 3 alone, a Bluestein line)
C23_SAMPLES, C23_BFRAMES, C23_SNR_SAMPLES = 1 << 25, 16, 1 << 22
C23_SIZES = ((3072, 384), (5120, 128), (11264, 128), (12288, 128), (16384, 128),
             (21504, 128), (65536, 128), (1 << 20, 1024), (1024 * 1021, 128), (27 << 15, 128))
C23_TAPS, C23_FFT, C23_BFRAMES_K11, C23_BLOCKS = 4096, 16384, 8, 85
C23_MIXED_TAPS, C23_MIXED_FFT, C23_MIXED_BLOCKS = 3000, 12288, 113
C23_4STEP_TAPS, C23_4STEP_FFT, C23_4STEP_BLOCKS = 4352, 17408, 80
C23_PRIME_TAPS, C23_PRIME_FFT, C23_PRIME_BLOCKS = 4096, 1024 * 1021, 5
# the sizes whose plans hold a Bluestein line (and register lines besides)
C23_BLUESTEIN = (C23_4STEP_FFT, C23_PRIME_FFT, 27 << 15)
# the bodies these replaced (every pass a run-time radix over the frame in shared
# memory), on an H100 80GB HBM3 at 700.00 W: (ms one call, ms 5 back to back, ms over
# cuFFT's one call) of K10 a size; ms of K11 a chunk; at 884,736 and 1024 x 1021 (K10)
# and at 17408 and 1024 x 1021 (K11) the generic run-time passes of the four-step's
# lines that the Bluestein lines replaced, timed with that code as phase 23 times them
C23_BEFORE = {3072: (0.4691, 0.4563, 2.19), 5120: (0.4909, 0.4546, 2.33),
            11264: (1.5980, 1.4960, 5.67), 12288: (0.6822, 0.6168, 3.08),
            16384: (0.8893, 0.7627, 3.89), 65536: (1.0209, 0.9327, 2.33),
            1 << 20: (1.2669, 1.1799, 3.01), 27 << 15: (0.8354, 0.7908, 1.65),
            1024 * 1021: (40.7528, 40.6356, 15.96)}
C23_BEFORE_K11 = {C23_FFT: 1.6252, C23_MIXED_FFT: 0.9788, C23_4STEP_FFT: 2.7361,
                  C23_PRIME_FFT: 379.3376}
FM_PILOT = 19.0 / 240.0
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


def complex_err(torch, k, p) -> tuple[float, float]:
    """(max abs error, rel L2) of the complex planes k against p."""
    got, ref = torch.complex(*k), torch.complex(*p)
    err = float(torch.max(torch.abs(got - ref)))
    return err, float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


def record_row(torch, rows, name, source, replaces, err, rel, within, agree, k_fn, p_fn,
               flops, nbytes, lib_fn=None, per_call=1, counter=None) -> dict:
    """Time kernel and plain version (and the library call where one
    computes the same function) and append the kernel's row to `rows`
    (returned too); flops counts the least operations of the function (for
    the filters the multiply-adds of their sums: real taps on complex
    samples, 4 flop per tap and output whatever form the kernel uses;
    complex taps are the kernel's choice; phasors and atan2 left out),
    nbytes the inputs and outputs once each (taps, at most 2 KB, left out);
    per_call the launches in one k_fn call (one per shard for K20, one per
    card for K19, one per batch and kernel for the four-step), counted under
    `counter` (the row's name unless given)."""
    from srcdsp_tpu_torch.kernels import _build

    counter = counter or name
    before = _build.LAUNCHES[counter]
    ms, plain_ms = median_ms(torch, k_fn), median_ms(torch, p_fn)
    require(_build.LAUNCHES[counter] == before + per_call * (REPS + 1), f"{name}: launch count")
    lib_ms = median_ms(torch, lib_fn) if lib_fn is not None else None
    bound_ms, bound_by = roofline_ms(flops, nbytes)
    print(f"    {name}: max_abs_err {err:.3e} rel_l2 {rel:.3e} decisions_equal {agree} "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms library {lib_ms} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)",
          flush=True)
    require(within, f"{name}: max abs error {err} / rel L2 {rel} over tolerance")
    require(agree, f"{name}: decisions differ from the plain version")
    row = dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=lib_ms)
    rows.append(row)
    return row


def ber_per_channel(tx: np.ndarray, rx: np.ndarray, settle: int = 16) -> np.ndarray:
    """Lowest bit-error rate over lags -16..16 per channel, after `settle` symbols."""
    best = np.ones(tx.shape[0])
    for lag in range(-16, 17):
        bs, rs = settle + max(lag, 0), settle + max(-lag, 0)
        n = min(tx.shape[-1] - bs, rx.shape[-1] - rs)
        best = np.minimum(best, np.mean(tx[:, bs:bs + n] != rx[:, rs:rs + n], axis=-1))
    return best


def ser_per_channel(data: np.ndarray, idx: np.ndarray, order: int, settle: int = 30
                    ) -> np.ndarray:
    """Lowest symbol-error rate over lags -32..32 per channel, after a
    differential decode and `settle` symbols (the V&V rotation drops out)."""
    d = np.mod(idx - np.concatenate([np.zeros_like(idx[:, :1]), idx[:, :-1]], axis=1), order)
    best = np.ones(data.shape[0])
    for lag in range(-32, 33):
        bs, rs = settle + max(lag, 0), settle + max(-lag, 0)
        n = min(data.shape[-1] - bs, d.shape[-1] - rs)
        best = np.minimum(best, np.mean(data[:, bs:bs + n] != d[:, rs:rs + n], axis=-1))
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


def tone_fit(torch, y, f: float):
    """Per row of y [C, N]: the tone's amplitude |sum y[n] e^{-j 2 pi f n}| / N
    (the reference's goertzel) and the mean power left once that tone is
    taken out, in complex128 (the reference's mean|y|^2 - amplitude^2, without
    the cancellation)."""
    n = torch.arange(y.shape[-1], dtype=torch.float64, device=y.device)
    e = torch.polar(torch.ones_like(n), 2 * np.pi * f * n)
    y = y.to(torch.complex128)
    c = (y @ e.conj()) / y.shape[-1]
    return c.abs(), (y - c[:, None] * e).abs().pow(2).mean(-1)


def phase13(torch, dev, x1, x3r, n3r, c1, k17, k18, taps1_np, word1, w01) -> None:
    """Config 1 through K17 and K18 beside K4 and K1, the two DDCs, the IIR,
    the AGC and the spectrum (all on the main path: launches counted)."""
    from srcdsp_tpu_torch import oracle
    from srcdsp_tpu_torch.kernels import mixfir_ctaps as kcm
    from srcdsp_tpu_torch.ops import agc as oagc
    from srcdsp_tpu_torch.ops import ddc as oddc
    from srcdsp_tpu_torch.ops import iir as oiir
    from srcdsp_tpu_torch.ops import spectrum as ospec
    from srcdsp_tpu_torch.ops.nco import NcoState, freq_to_word, nco_phasor

    # A. K17 == K4 bit for bit (one launch, and 4 chunks with carried history);
    # K18 against K1; the four timed in turns
    hist = k17.hist
    k4 = kcm.make_mix_fir_ctaps_kernel(taps1_np, word1, 2, out_tile=OUT_TILE, b_rows=B_ROWS,
                                       device=dev)
    y4 = k4.fn(w01, x1)
    xh, xb = x1[:, :hist], x1[:, hist:].view(2, -1, OUT_TILE * 2)
    y17 = k17.fn(0, xh, xb)
    require(torch.equal(y17[0], y4[0]) and torch.equal(y17[1], y4[1]),
            "K17 != K4 on the same stream (torch.equal)")
    q = C1_SAMPLES // C13_K17_CHUNKS
    parts = []
    for i in range(C13_K17_CHUNKS):
        lo = hist + i * q
        parts.append(k17.fn((i * q * word1) % (1 << 32), x1[:, lo - hist:lo],
                           x1[:, lo:lo + q].view(2, -1, OUT_TILE * 2)))
    require(all(torch.equal(torch.cat([p[j] for p in parts]), y17[j]) for j in range(2)),
            "K17: 4 chunks with carried history != one launch (torch.equal)")
    y1 = c1.step(x1)
    y18 = k18.fn(w01, word1, x3r, n=n3r)
    got = torch.complex(y18[0].reshape(-1), y18[1].reshape(-1))
    ref = torch.complex(y1[0].reshape(-1), y1[1].reshape(-1))
    rel18 = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    require(rel18 < 2e-6, f"K18 against K1: rel L2 {rel18}")
    del y4, y17, parts, y1, y18, got, ref
    fns = {"K17": lambda: k17.fn(0, xh, xb), "K4": lambda: k4.fn(w01, x1),
           "K18": lambda: k18.fn(w01, word1, x3r, n=n3r), "K1": lambda: c1.step(x1)}
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for rnd in range(2 * REPS):
        for name in (fns if rnd % 2 == 0 else reversed(list(fns))):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[name]()
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1))
    med = {k: float(np.median(v)) for k, v in times.items()}
    d17 = np.asarray(times["K17"]) - np.asarray(times["K4"])
    d18 = np.asarray(times["K18"]) - np.asarray(times["K1"])
    print(f"[13] config 1 front ends, {C1_SAMPLES} samples, {2 * REPS} turns each: "
          + ", ".join(f"{k} {v:.4f} ms ({C1_SAMPLES / v / 1e3:.1f} Ms/s)" for k, v in med.items())
          + f"; K17 - K4 median {np.median(d17):+.4f} ms (range {d17.min():+.4f} .. "
          f"{d17.max():+.4f}), K18 - K1 median {np.median(d18):+.4f} ms (range "
          f"{d18.min():+.4f} .. {d18.max():+.4f}), K1 / K18 {med['K1'] / med['K18']:.3f}; K17 "
          "== K4 and 4 chunks == one launch "
          f"(torch.equal), K18 against K1 rel L2 {rel18:.3e} (floor 2e-6)", flush=True)

    # B. the down-converter: 32 channels, 4 blocks of D*2^14 samples each
    gen = np.random.default_rng(13)
    y48 = None
    for label, ddc, f_in, f_nb in (
            ("ddc(0.21, 0.004, 70 dB)", oddc.make_ddc(0.21, 0.004, atten_db=70.0), 0.0012, 0.02),
            ("ddc(0.21, 0.0155)", oddc.make_ddc(0.21, 0.0155), 240 / 49152, 0.03)):
        d = ddc.decim
        blk = d * C13_DDC_BLOCK_OUT
        n = C13_DDC_BLOCKS * blk
        st0 = NcoState(phase=torch.as_tensor(gen.integers(0, 1 << 32, C13_CHANNELS),
                                             device=dev))
        x = (nco_phasor(int(freq_to_word(0.21 + f_in)), st0, n)[1]
             + 0.9 * nco_phasor(int(freq_to_word(0.21 + f_nb)), st0, n)[1])
        torch.cuda.synchronize()
        _, one = oddc.ddc_apply(ddc, oddc.ddc_init(ddc, (C13_CHANNELS,), device=dev), x)
        st = oddc.ddc_init(ddc, (C13_CHANNELS,), device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = []
        for i in range(C13_DDC_BLOCKS):
            st, yb = oddc.ddc_apply(ddc, st, x[:, i * blk:(i + 1) * blk])
            outs.append(yb)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        y = torch.cat(outs, dim=-1)
        stream_err = float((y - one).abs().max())
        _, cpu0 = oddc.ddc_apply(ddc, oddc.ddc_init(ddc, (1,), device="cpu"), x[:1, :blk].cpu())
        rel_cpu = float(torch.linalg.norm(outs[0][:1].cpu() - cpu0) / torch.linalg.norm(cpu0))
        ys = y[:, C13_SETTLE:]
        amp, resid = tone_fit(torch, ys, f_in * d)
        resid_db = 10 * torch.log10(resid / 0.81)
        print(f"[13] {label}: D {d} (half-bands {[len(h) for h in ddc.plan.halfband_taps]}, "
              f"final {0 if ddc.plan.final_taps is None else len(ddc.plan.final_taps)} taps / "
              f"{ddc.plan.final_decim}), {C13_CHANNELS} ch x {C13_DDC_BLOCKS} blocks of {blk}: "
              f"{secs * 1e3:.3f} ms, {C13_CHANNELS * n / secs / 1e6:.1f} Ms/s input (host clock);"
              f" tone amplitude {float(amp.min()):.5f} .. {float(amp.max()):.5f} (within 5 %), "
              f"residual worst {float(resid_db.max()):.2f} dB (floor -55); 4 blocks against one: "
              f"max abs {stream_err:.3e} (floor 3e-6); channel 0 against the CPU: rel L2 "
              f"{rel_cpu:.3e} (floor 1e-5)", flush=True)
        require(bool(((amp - 1.0).abs() < 0.05).all()), f"{label}: tone amplitude {amp}")
        require(float(resid_db.max()) < -55.0, f"{label}: residual {resid_db} dB")
        require(stream_err < 3e-6, f"{label}: 4 blocks differ from one by {stream_err}")
        require(rel_cpu < 1e-5, f"{label}: card against CPU rel L2 {rel_cpu}")
        y48 = y if d == 48 else y48
        del x, one, outs, y, ys, cpu0

    # C. the IIR (DC blocker) and the AGC over 32 x 2^22, Welch of the D = 48 output
    b, a = oiir.dc_block_coeffs()
    xi = (torch.randn((C13_CHANNELS, C13_IIR_SAMPLES), dtype=torch.complex64, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(13))
          + torch.tensor(2.0 - 1.0j, dtype=torch.complex64, device=dev))
    xi = xi * torch.linspace(0.5, 1.5, C13_CHANNELS, device=dev)[:, None]
    prm = oiir.make_iir_params(b, a, device=dev)
    st = oiir.iir_init(prm, (C13_CHANNELS,), device=dev)
    _, yi = oiir.iir_apply(prm, st, xi)
    _, ys = oiir.iir_apply(prm, st, xi, inter_block="scan")
    rel_forms = float(torch.linalg.norm(yi - ys) / torch.linalg.norm(ys))
    ref, _ = oracle.iir_stream(xi[0, :C13_ORACLE_SAMPLES].cpu().numpy(), b, a)
    snr_o = snr_db(torch, torch.from_numpy(ref), yi[0, :C13_ORACLE_SAMPLES].cpu())
    iir_ms = median_ms(torch, lambda: oiir.iir_apply(prm, st, xi))
    agc = oagc.make_agc_params(device=dev)
    ya = oagc.agc_full(agc, xi)
    pw = ya[:, C13_IIR_SAMPLES // 2:].abs().pow(2).mean(-1)
    del ys
    psd = ospec.welch(y48, 1024)
    peak = psd.argmax(-1)
    print(f"[13] IIR dc_block over {C13_CHANNELS} x {C13_IIR_SAMPLES}: {iir_ms:.3f} ms median "
          f"({C13_CHANNELS * C13_IIR_SAMPLES / iir_ms / 1e3:.1f} Ms/s); against the C++ oracle's "
          f"iir_stream on {C13_ORACLE_SAMPLES} samples of channel 0: SNR {snr_o:.2f} dB (floor "
          f"80); assoc against scan rel L2 {rel_forms:.3e} (floor 1e-5); AGC settled power "
          f"{float(pw.min()):.4f} .. {float(pw.max()):.4f} (target 1, within 5 %); Welch of the "
          f"D = 48 output peaks at bins {sorted(set(peak.tolist()))} (tone at bin 240)",
          flush=True)
    require(snr_o > 80.0, f"IIR: SNR {snr_o} dB against the oracle")
    require(rel_forms < 1e-5, f"IIR: assoc against scan rel L2 {rel_forms}")
    require(bool(((pw - 1.0).abs() < 0.05).all()), f"AGC: settled power {pw}")
    require(bool((peak == 240).all()), f"Welch: peak bins {peak}")


def phase23(torch, dev) -> tuple[list, dict]:
    """K10 and K11 at the sizes past the powers of two (``kernels.fft_pallas.
    fft_plan``: one block a frame up to 16384, the four-step from 17408, a
    line of no register shape a Bluestein line). First each body against
    its plain version and the library call, timed (kernel and plain: median
    of 5; K10 and cuFFT in turns, one call a turn and 5 back to back, beside
    the earlier bodies' times and ratios); then, with the counts at 0, the
    path a user drives: K10 in its three orders at every size (natural ==
    kernel-natural == digit unscrambled by torch.equal; SNR against
    torch.fft in complex128 above 110 dB; the conj round trip above 110 dB),
    config 3 with 4096 taps through K11 (one launch == 5 FftConvStream
    chunks == fftconv_time_sharded over 5 shards == per-channel taps by
    torch.equal, > 100 dB against the plain K11, > 90 dB against the C++
    oracle's direct FIR), K11 at fft 12288 and K11's four-step at 17408 (the
    136-point columns a Bluestein line) and 1024 x 1021 (the 1021-point rows
    one) (one launch == 5 FftConvStream chunks). Returns the new bodies' rows, one a body and
    size, each with the launches of that size on the path, and the path's
    launches."""
    from srcdsp_tpu_torch import oracle
    from srcdsp_tpu_torch.configs import C3_CUTOFF, seeded_planes
    from srcdsp_tpu_torch.dist import fused as dfused
    from srcdsp_tpu_torch.dist import mesh as dmesh
    from srcdsp_tpu_torch.kernels import _build
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft
    from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc
    from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes
    from srcdsp_tpu_torch.ops.window import lowpass

    card = card_line()
    rows = []
    orders = (("fft", True), ("fft_digit", False), ("fft_nat", "kernel"))
    bodies = {k: v for k, v in _build.ptxas_report().items()
              if any(b in k for b in ("fft_mixed_kernel", "fftconv_mixed_kernel", "fft4_",
                                      "fftconv4_"))}
    spilled = [k for k, (_, st, ld) in bodies.items() if st or ld]
    blue = [k for k in bodies if "bluestein" in k]
    for n in C23_BLUESTEIN:
        lines = kfft.fft_plan(n).lines
        print(f"[23] {n}: {'; '.join(map(str, lines))}", flush=True)
        require(all(isinstance(g, (kfft.LineShape, kfft.BluesteinLine)) for g in lines)
                and any(isinstance(g, kfft.BluesteinLine) for g in lines),
                f"{n}: lines {lines} (register and Bluestein lines, a Bluestein one among them)")
    for n, n2 in C23_SIZES[:5] + ((C23_4STEP_FFT, 128),) + C23_SIZES[5:]:
        plan = kfft.fft_plan(n, n2)
        names = (kfft.MIXED_KERNELS,) if plan.body == "mixed" else (
            ("cols", "out"), ("rows", "mid"))
        for g, pair in zip(plan.lines, names):
            for name in pair:
                regs, local, blocks = kfft.lines_info(name, g)
                threads = g.threads
                print(f"[23] {name} at {n} ({g}, {g.smem_bytes()} B of shared memory): {regs} "
                      f"registers, {local} bytes of local memory, {blocks} blocks of {threads} "
                      f"threads per SM ({blocks * threads // 32} warps)")
                require(local == 0 and blocks >= 1, f"{name} at {n}: {local} B local, {blocks}")
    want = (3 * len(kfft.MIXED_SHAPES) + 4 * len(kfft.FOUR_STEP_LINES)
            + 4 * len(kfft.BLUESTEIN_LOG2M))
    print(f"[23] ptxas: {len(bodies) - len(spilled)} of {len(bodies)} fft_mixed / fft_4step "
          f"kernels without spills, {len(blue)} of them Bluestein: "
          f"{', '.join(f'{k} {bodies[k][0]} registers' for k in sorted(blue))}", flush=True)
    require(len(bodies) == want and not spilled, f"ptxas: {len(bodies)} of {want}, spills in "
                                                 f"{spilled}")
    require(len(blue) == 4 * len(kfft.BLUESTEIN_LOG2M), f"ptxas: Bluestein kernels {blue}")

    def frames(n: int) -> int:
        return C23_SAMPLES // n // C23_BFRAMES * C23_BFRAMES

    def inputs(n: int):
        g = torch.Generator(device=dev).manual_seed(n)
        return (torch.randn((frames(n), n), device=dev, generator=g),
                torch.randn((frames(n), n), device=dev, generator=g))

    def body_of(n: int, n2: int = 128) -> str:
        return "mixed" if kfft.fft_plan(n, n2).body == "mixed" else "4step"

    # --- each body at each size against its plain version and the library, timed --
    for n, n2 in C23_SIZES:
        plan = kfft.fft_plan(n, n2)
        body = "fft_" + body_of(n, n2)
        xr, xi = inputs(n)
        xc = torch.complex(xr, xi)
        k = kfft.make_fft_kernel(n, n2=n2, b_frames=C23_BFRAMES, device=dev)

        def plain(k=k, xr=xr, xi=xi):
            pr, pi = kfft.fft_rows_plain(xr.reshape(-1, k.n2), xi.reshape(-1, k.n2), k.consts,
                                         k.n1, k.n2)
            return kfft.unscramble(pr, k.n1, k.n2), kfft.unscramble(pi, k.n1, k.n2)

        y = k.fn(xr, xi)
        err, rel = complex_err(torch, y, plain())
        per_call = 1 if plan.body == "mixed" else 2 * -(-frames(n) // kfft.scratch_frames(n, 2))
        print(f"[23] K10 {n} (n2 {n2}, {plan.body}: {'; '.join(map(str, plan.lines))}), "
              f"{frames(n)} frames, {per_call} launches a call:", flush=True)
        row = record_row(torch, rows, f"{body}_{n}", "srcdsp_tpu_torch/csrc/" + (
            "fft_mixed.cu" if plan.body == "mixed" else "fft_4step.cu"),
            "srcdsp_tpu/kernels/fft_pallas.py:201", err, rel, rel < 1e-5, True,
            lambda: k.fn(xr, xi), plain, 5 * n * np.log2(n) * frames(n),
            tensor_bytes(xr, xi, y), lib_fn=lambda: torch.fft.fft(xc, dim=-1),
            per_call=per_call, counter=body)
        fns = {"kernel": lambda: k.fn(xr, xi), "cuFFT": lambda: torch.fft.fft(xc, dim=-1)}
        t1 = {a: float(np.median(v)) for a, v in in_turns(torch, fns, 2 * REPS).items()}
        t5 = {a: float(np.median(v)) for a, v in in_turns(torch, fns, 2 * REPS,
                                                             calls=REPS).items()}
        old = [f" (before: {v})" for v in C23_BEFORE.get(n, ("not measured",) * 3)]
        print(f"[23] K10 {n} in turns: one call kernel {t1['kernel']:.4f}{old[0]} / cuFFT "
              f"{t1['cuFFT']:.4f} ms = {t1['kernel'] / t1['cuFFT']:.3f} x cuFFT{old[2]}; {REPS} "
              f"back to back {t5['kernel']:.4f}{old[1]} / {t5['cuFFT']:.4f} ms "
              f"({t5['kernel'] / t5['cuFFT']:.3f} x cuFFT, {row['bound_ms'] / t5['kernel']:.3f} of "
              f"the bound); {card}", flush=True)
        del xr, xi, xc, y, k

    taps = lowpass(C23_TAPS, C3_CUTOFF)
    for fft, ntaps, blocks in ((C23_FFT, C23_TAPS, C23_BLOCKS),
                               (C23_MIXED_FFT, C23_MIXED_TAPS, C23_MIXED_BLOCKS),
                               (C23_4STEP_FFT, C23_4STEP_TAPS, C23_4STEP_BLOCKS),
                               (C23_PRIME_FFT, C23_PRIME_TAPS, C23_PRIME_BLOCKS)):
        mixed = fft < kfft.FOUR_STEP_MIN
        body = "fftconv_" + ("mixed" if mixed else "4step")
        t_k = taps if fft == C23_FFT else lowpass(ntaps, C3_CUTOFF)
        kc = kfc.make_fftconv_kernel(t_k, fft, num_channels=C3_CHANNELS,
                                     b_frames=C23_BFRAMES_K11, device=dev)
        chunk = blocks // 5 * kc.block_in()
        xk = seeded_planes(C3_CHANNELS, kc.overlap, chunk, seed=23, device=dev)
        hresp = torch.as_tensor(kfc.freq_response_planes(t_k, fft), device=dev)
        fftp = make_fft_planes(fft, device=dev)
        w = torch.as_tensor(np.ascontiguousarray(t_k[::-1]), dtype=torch.float32,
                            device=dev)[None, None]
        yc = kfc.fftconv_pallas(kc, xk)
        err, rel = complex_err(torch, yc, kfc.fftconv_plain(xk, hresp, fftp, fft, kc.hop))
        nf = C3_CHANNELS * chunk // kc.hop
        per_call = 1 if mixed else 3 * -(-nf // kfft.scratch_frames(fft, 4))
        print(f"[23] K11 {fft}, {ntaps} taps (hop {kc.hop}), one chunk of {C3_CHANNELS} x "
              f"{chunk}, {per_call} launches a call; library: cuDNN conv1d (TF32 off):",
              flush=True)
        row = record_row(torch, rows, f"{body}_{fft}", "srcdsp_tpu_torch/csrc/" + (
            "fft_mixed.cu" if mixed else "fft_4step.cu"),
            "srcdsp_tpu/kernels/fftconv_pallas.py:361", err, rel, rel < 1e-5, True,
            lambda: kfc.fftconv_pallas(kc, xk),
            lambda: kfc.fftconv_plain(xk, hresp, fftp, fft, kc.hop),
            nf * (2 * 5 * fft * np.log2(fft) + 6 * fft), tensor_bytes(xk, yc),
            lib_fn=lambda: torch.nn.functional.conv1d(xk.reshape(2 * C3_CHANNELS, 1, -1), w),
            per_call=per_call, counter=body)
        old = C23_BEFORE_K11.get(fft)
        print(f"[23] K11 {fft}: {row['ms']:.4f} ms a chunk"
              f"{f' (before: {old:.4f})' if old else ''}, "
              f"{C3_CHANNELS * chunk / row['ms'] / 1e3:.1f} Ms/s; {card}", flush=True)
        del xk, yc, kc
    by_name = {row["name"]: row for row in rows}

    # --- the path, with the counts at 0 ---------------------------------------
    _build.reset_launches()
    for n, n2 in C23_SIZES:
        body = "fft_" + body_of(n, n2)
        before = _build.LAUNCHES[body]
        xr, xi = inputs(n)
        outs = {}
        for name, order in orders:
            kn = kfft.make_fft_kernel(n, n2=n2, b_frames=C23_BFRAMES, natural_order=order,
                                      device=dev)
            outs[name] = (kn, kn.fn(xr, xi))
        nat = outs["fft"][1]
        kd = outs["fft_digit"][0]
        require(all(torch.equal(a, b) for a, b in zip(nat, outs["fft_nat"][1])),
                f"K10 {n}: kernel-natural store != natural")
        require(all(torch.equal(kfft.unscramble(d.reshape(-1, n2), kd.n1, kd.n2), a)
                    for d, a in zip(outs["fft_digit"][1], nat)),
                f"K10 {n}: digit store + unscramble != natural store (torch.equal)")
        b = max(1, C23_SNR_SAMPLES // n)
        ref = torch.fft.fft(torch.complex(xr[:b].double(), xi[:b].double()), dim=-1)
        snr = snr_db(torch, ref, torch.complex(nat[0][:b], nat[1][:b]).to(torch.complex128))
        rr, ri = kfft.ifft_pallas(outs["fft"][0], *nat)
        trip = min(snr_db(torch, xr, rr), snr_db(torch, xi, ri))
        print(f"[23] K10 {n}: natural == kernel-natural == unscrambled digit (torch.equal); SNR "
              f"{snr:.2f} dB against torch.fft in complex128 on {b} frames (floor 110); conj "
              f"round trip {trip:.2f} dB (floor 110)", flush=True)
        require(snr > 110.0, f"K10 {n}: SNR {snr} dB against complex128")
        require(trip > 110.0, f"K10 {n}: round trip SNR {trip} dB")
        by_name[f"{body}_{n}"]["launches"] = _build.LAUNCHES[body] - before
        del xr, xi, outs, nat, ref, rr, ri

    body3 = "fftconv_" + body_of(C23_FFT)
    before = _build.LAUNCHES[body3]
    k11 = kfc.make_fftconv_kernel(taps, C23_FFT, num_channels=C3_CHANNELS,
                                  b_frames=C23_BFRAMES_K11, device=dev)
    chunk = C23_BLOCKS // 5 * k11.block_in()
    n3 = 5 * chunk
    require((k11.overlap, k11.hop, n3) == (4096, 12288, 8355840),
            f"config 3 at 4096 taps: overlap {k11.overlap}, hop {k11.hop}, {n3} samples")
    x = seeded_planes(C3_CHANNELS, k11.overlap, n3, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = kfc.fftconv_pallas(k11, x)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    st = kfc.FftConvStream(k11)
    body = x[..., k11.overlap:]
    parts = [st.process(body[..., i * chunk:(i + 1) * chunk]) for i in range(5)]
    require(all(torch.equal(torch.cat([q[j] for q in parts], -1), one[j]) for j in range(2)),
            "config 3 at 4096 taps: 5 FftConvStream chunks != one launch (torch.equal)")
    del parts
    mesh5 = dmesh.make_mesh(time=5, devices=[dev] * 5)
    tail, yr5, yi5 = dfused.fftconv_time_sharded(
        k11, torch.zeros((C3_CHANNELS, 2, k11.overlap), device=dev), dmesh.shard(body, mesh5),
        mesh5)
    require(torch.equal(torch.cat(yr5, -1), one[0]) and torch.equal(torch.cat(yi5, -1), one[1]),
            "config 3 at 4096 taps: fftconv_time_sharded over 5 shards != one launch")
    require(torch.equal(tail, x[..., -k11.overlap:]), "fftconv_time_sharded: carried tail")
    del yr5, yi5, tail
    kpc = kfc.make_fftconv_kernel(np.tile(taps, (C3_CHANNELS, 1)), C23_FFT,
                                  num_channels=C3_CHANNELS, b_frames=C23_BFRAMES_K11, device=dev)
    pc = kfc.fftconv_pallas(kpc, x)
    require(torch.equal(pc[0], one[0]) and torch.equal(pc[1], one[1]),
            "config 3 at 4096 taps: per-channel taps != shared taps (torch.equal)")
    del pc
    h2s = torch.as_tensor(kfc.freq_response_planes(taps, C23_FFT), device=dev)
    y3 = torch.complex(*one)
    snr_plain = snr_db(torch, torch.complex(*kfc.fftconv_plain(
        x, h2s, make_fft_planes(C23_FFT, device=dev), C23_FFT, k11.hop)), y3)
    snr_or = []
    for c in (0, C3_CHANNELS - 1):
        xc = torch.complex(x[c, 0, k11.overlap:k11.overlap + C3_ORACLE_SAMPLES],
                           x[c, 1, k11.overlap:k11.overlap + C3_ORACLE_SAMPLES]).cpu().numpy()
        snr_or.append(snr_db(torch, torch.from_numpy(oracle.fir(xc, taps)),
                             y3[c, :C3_ORACLE_SAMPLES].cpu()))
    ms3 = median_ms(torch, lambda: kfc.fftconv_pallas(k11, x))
    print(f"[23] config 3 at {C23_TAPS} taps (fft {C23_FFT}, hop {k11.hop}, {body3}): "
          f"{C3_CHANNELS} ch x {n3} samples, one launch {one_s * 1e3:.3f} ms (first call), "
          f"median {ms3:.3f} ms (before: 7.485) ({C3_CHANNELS * n3 / ms3 / 1e3:.1f} Ms/s); == 5 "
          f"FftConvStream chunks == fftconv_time_sharded over 5 shards == per-channel taps "
          f"(torch.equal); SNR {snr_plain:.2f} dB against the plain K11 (floor 100), "
          f"{snr_or[0]:.2f} / {snr_or[1]:.2f} dB against the C++ oracle's direct FIR on the "
          f"first {C3_ORACLE_SAMPLES} samples of channels 0 and {C3_CHANNELS - 1} (floor 90); "
          f"{card}", flush=True)
    require(snr_plain > 100.0, f"config 3 at 4096 taps: SNR {snr_plain} dB against plain")
    require(min(snr_or) > 90.0, f"config 3 at 4096 taps: SNR {snr_or} dB against the oracle")
    by_name[f"{body3}_{C23_FFT}"]["launches"] = _build.LAUNCHES[body3] - before
    del x, one, y3, body

    for fft, ntaps, blocks in ((C23_MIXED_FFT, C23_MIXED_TAPS, C23_MIXED_BLOCKS),
                               (C23_4STEP_FFT, C23_4STEP_TAPS, C23_4STEP_BLOCKS),
                               (C23_PRIME_FFT, C23_PRIME_TAPS, C23_PRIME_BLOCKS)):
        bodyk = "fftconv_" + body_of(fft)
        before = _build.LAUNCHES[bodyk]
        taps_k = lowpass(ntaps, C3_CUTOFF)
        km = kfc.make_fftconv_kernel(taps_k, fft, num_channels=C3_CHANNELS,
                                     b_frames=C23_BFRAMES_K11, device=dev)
        nm = blocks * km.block_in()
        x = seeded_planes(C3_CHANNELS, km.overlap, nm, seed=0, device=dev)
        one = kfc.fftconv_pallas(km, x)
        st = kfc.FftConvStream(km)
        edges = [km.overlap + i * blocks // 5 * km.block_in() for i in range(6)]  # whole blocks
        parts = [st.process(x[..., a:b]) for a, b in zip(edges, edges[1:])]
        require(all(torch.equal(torch.cat([q[j] for q in parts], -1), one[j]) for j in range(2)),
                f"K11 {fft}: 5 FftConvStream chunks != one launch (torch.equal)")
        del parts
        ym = torch.complex(*one)
        hm = torch.as_tensor(kfc.freq_response_planes(taps_k, fft), device=dev)
        snr_m = snr_db(torch, torch.complex(*kfc.fftconv_plain(
            x, hm, make_fft_planes(fft, device=dev), fft, km.hop)), ym)
        xc = torch.complex(x[0, 0, km.overlap:km.overlap + C3_ORACLE_SAMPLES],
                           x[0, 1, km.overlap:km.overlap + C3_ORACLE_SAMPLES]).cpu().numpy()
        snr_mo = snr_db(torch, torch.from_numpy(oracle.fir(xc, taps_k)),
                        ym[0, :C3_ORACLE_SAMPLES].cpu())
        print(f"[23] K11 at fft {fft}, {ntaps} taps (hop {km.hop}, {bodyk}): {C3_CHANNELS} ch x "
              f"{nm} samples, == 5 FftConvStream chunks (torch.equal), SNR {snr_m:.2f} dB "
              f"against the plain K11 (floor 100), {snr_mo:.2f} dB against the C++ oracle on "
              f"channel 0 (floor 90)", flush=True)
        require(snr_m > 100.0 and snr_mo > 90.0, f"K11 {fft}: SNR {snr_m}, {snr_mo} dB")
        by_name[f"{bodyk}_{fft}"]["launches"] = _build.LAUNCHES[bodyk] - before
        del x, ym, one

    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    require(set(launches) <= {"fft_mixed", "fft_4step", "fftconv_mixed", "fftconv_4step"},
            f"phase 23: the path launched a kernel other than the new bodies ({launches})")
    for row in rows:
        require(row["launches"] > 0, f"phase 23: {row['name']} never launched on the path")
    return rows, launches


def in_turns(torch, fns: dict, turns: int, cards=None, calls: int = 1) -> dict:
    """Times in ms of each fn over `turns` rounds, in alternating order
    (forward, then backward), after one warm-up call each. CUDA events on the
    current device; with `cards` (device indices, more than one), the host
    clock between synchronizes of every card, since the events of one card
    do not wait for another's work. With `calls` > 1 a turn times that many
    calls back to back (the card then waits on no host work between them)
    and reports the time per call."""
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for rnd in range(turns):
        for name in (fns if rnd % 2 == 0 else reversed(list(fns))):
            if cards and len(cards) > 1:
                for c in cards:
                    torch.cuda.synchronize(c)
                t0 = time.perf_counter()
                fns[name]()
                for c in cards:
                    torch.cuda.synchronize(c)
                times[name].append((time.perf_counter() - t0) * 1e3)
                continue
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(calls):
                fns[name]()
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1) / calls)
    return times


def phase14(torch, dev, x1, taps1_np, word1) -> None:
    """The distribution tier (all on the main path: launches counted): K19 and
    K20 on time shards of one card (and across two where the machine has
    them), K1 and K11 on time shards, the distributed config-5 pipeline and
    the sharded coded bodies, each against its unsharded form."""
    from srcdsp_tpu_torch.chains.channelizer import (
        channelize_full, design_prototype, pad_prototype)
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.chains.psk import make_psk_params, psk_apply, psk_init
    from srcdsp_tpu_torch.configs import C3_CUTOFF, build_config5, build_ldpc, build_turbo
    from srcdsp_tpu_torch.dist import channelize as dchan
    from srcdsp_tpu_torch.dist import fused as dfused
    from srcdsp_tpu_torch.dist import halo as dhalo
    from srcdsp_tpu_torch.dist import mesh as dmesh
    from srcdsp_tpu_torch.kernels import _build
    from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc
    from srcdsp_tpu_torch.kernels import halo_dma as k19
    from srcdsp_tpu_torch.kernels import halo_fused as khf
    from srcdsp_tpu_torch.kernels import mixfir as kmf
    from srcdsp_tpu_torch.kernels.bcjr_pallas import turbo_decode_pallas
    from srcdsp_tpu_torch.ops.fir import fir_full
    from srcdsp_tpu_torch.ops.window import lowpass
    from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone

    hist, n1 = 128, C1_SAMPLES
    cards = torch.cuda.device_count()
    legs = [("one card", dmesh.make_mesh(time=C14_SHARDS, devices=[dev] * C14_SHARDS))]
    if cards >= 2:
        legs.append(("two cards", dmesh.make_mesh(time=2)))
    print(f"[14] {cards} CUDA device(s); {C14_SHARDS} time shards on {dev}; cross-card leg: "
          + ("cuda:0 + cuda:1, run" if cards >= 2 else "1 device, not run"), flush=True)
    gen = torch.Generator(device=dev).manual_seed(14)
    stream = torch.cat([x1[:, hist:], torch.randn((2, n1), generator=gen, device=dev)], dim=-1)
    x3 = torch.randn((C3_CHANNELS, 2, C14_BUFFERS * C3_SAMPLES), generator=gen, device=dev)
    torch.cuda.synchronize()

    # K1 over the whole unsharded stream of C14_BUFFERS config-1 buffers, from rest
    k1 = kmf.make_mix_fir_kernel(taps1_np, 2, out_tile=OUT_TILE, b_rows=B_ROWS, device=dev)
    w0pad = (-hist * word1) % (1 << 32)
    one = k1.fn(w0pad, word1, torch.cat([torch.zeros((2, hist), device=dev), stream], dim=-1))
    one = torch.stack([one[0].reshape(-1), one[1].reshape(-1)])
    for label, mesh in legs:
        devs = mesh.axis_devices()
        p14 = len(devs)
        cards_used = sorted({d.index for d in devs})
        clock = "host clock" if len(cards_used) > 1 else "CUDA events"
        # K19: config 1's buffer 0 (halo 128 = K1's hist) and config 3's 32 rows
        # (halo 1024 = K11's overlap at 1024 taps), each equal to the torch copies
        rows3 = x3[..., :C3_SAMPLES].reshape(2 * C3_CHANNELS, -1)
        for what, src, halo in (("config-1 planes", stream[:, :n1], hist),
                                ("config-3 rows", rows3, 1024)):
            shards = dmesh.shard(src, mesh)
            before = _build.LAUNCHES["halo_dma"]
            got = k19.halo_from_left_pallas(shards, halo)
            require(_build.LAUNCHES["halo_dma"] == before + len(cards_used),
                    f"K19 ({label}): not one launch per card")
            ref = dhalo.halo_from_left(shards, halo)
            require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                    f"K19 ({label}, {what}) != dist.halo.halo_from_left")
            outs = [torch.empty_like(a) for a in got]

            def yard(shards=shards, outs=outs, halo=halo):
                outs[0].zero_()
                for p in range(1, p14):
                    outs[p].copy_(shards[p - 1][:, shards[p - 1].shape[-1] - halo:])

            t = in_turns(torch, {"K19": lambda s=shards, h=halo: k19.halo_from_left_pallas(s, h),
                                 "copy_": yard}, 2 * REPS, cards_used)
            k19_ms, copy_ms = np.median(t["K19"]), np.median(t["copy_"])
            print(f"[14] K19 {label}, {p14} shards of {what} {tuple(shards[0].shape)}, halo "
                  f"{halo}: == dist.halo.halo_from_left (torch.equal), {len(cards_used)} "
                  f"launch(es) per call; K19 {k19_ms:.4f} ms, copy_ yardstick {copy_ms:.4f} ms, "
                  f"ratio {k19_ms / copy_ms:.3f} ({2 * REPS} turns, {clock})", flush=True)
            del shards, got, ref, outs
        # K20 and K1 on time shards, C14_BUFFERS buffers with the carried tail
        kf = dmesh.per_device(lambda d: khf.make_halo_fused_kernel(
            taps1_np, 2, out_tile=OUT_TILE, b_rows=B_ROWS, device=d), devs)
        k1s = dmesh.per_device(lambda d: kmf.make_mix_fir_kernel(
            taps1_np, 2, out_tile=OUT_TILE, b_rows=B_ROWS, device=d), devs)
        tail_a = tail_b = torch.zeros((2, hist), device=devs[0])
        ya, yb = [], []
        for b in range(C14_BUFFERS):
            shards = dmesh.shard(stream[:, b * n1:(b + 1) * n1], mesh)
            w0 = (b * n1 * word1) % (1 << 32)
            tail_a, y = khf.mix_fir_halo_sharded(kf, w0, word1, tail_a, shards, mesh)
            ya.append(torch.cat([v.to(dev) for v in y], dim=-1))
            tail_b, y = dfused.mix_fir_time_sharded(k1s, w0, word1, tail_b, shards, mesh)
            yb.append(torch.cat([v.to(dev) for v in y], dim=-1))
        ya, yb = torch.cat(ya, dim=-1), torch.cat(yb, dim=-1)
        require(torch.equal(ya, one), f"K20 ({label}) != K1 over the unsharded stream")
        require(torch.equal(yb, one), f"mix_fir_time_sharded ({label}) != K1 unsharded")
        require(torch.equal(tail_a, tail_b) and torch.equal(tail_a.to(dev), stream[:, -hist:]),
                f"K20 / mix_fir_time_sharded ({label}): carried tails differ")
        t = in_turns(torch, {
            "K20": lambda: khf.mix_fir_halo_sharded(kf, 0, word1, tail_a, shards, mesh),
            "mix_fir_time_sharded": lambda: dfused.mix_fir_time_sharded(k1s, 0, word1, tail_b,
                                                                        shards, mesh),
            "K1 unsharded": lambda: k1.fn(w0pad, word1, x1)}, 2 * REPS, cards_used)
        med = {k: float(np.median(v)) for k, v in t.items()}
        print(f"[14] K20 {label}, {p14} shards x {C14_BUFFERS} buffers of {n1} samples: == K1 "
              f"unsharded and == mix_fir_time_sharded (torch.equal), tails equal; per buffer "
              + ", ".join(f"{k} {v:.4f} ms ({n1 / v / 1e3:.1f} Ms/s)" for k, v in med.items())
              + f" ({2 * REPS} turns, {clock})", flush=True)
        del kf, k1s, ya, yb, shards, y, tail_a, tail_b
    del one, stream

    # K11 on C14_FFT_SHARDS time shards (phase 10's chunks), C14_BUFFERS buffers
    mesh5 = dmesh.make_mesh(time=C14_FFT_SHARDS, devices=[dev] * C14_FFT_SHARDS)
    k11 = kfc.make_fftconv_kernel(lowpass(1024, C3_CUTOFF), 4096, num_channels=C3_CHANNELS,
                                  b_frames=16, karatsuba=True, device=dev)
    tail = torch.zeros((C3_CHANNELS, 2, k11.overlap), device=dev)
    rs, is_ = [], []
    for b in range(C14_BUFFERS):
        shards = dmesh.shard(x3[..., b * C3_SAMPLES:(b + 1) * C3_SAMPLES], mesh5)
        tail, yr, yi = dfused.fftconv_time_sharded(k11, tail, shards, mesh5)
        rs.append(torch.cat(yr, dim=-1))
        is_.append(torch.cat(yi, dim=-1))
    xin = torch.cat([torch.zeros((C3_CHANNELS, 2, k11.overlap), device=dev), x3], dim=-1)
    r1, i1 = kfc.fftconv_pallas(k11, xin)
    require(torch.equal(torch.cat(rs, dim=-1), r1) and torch.equal(torch.cat(is_, dim=-1), i1),
            "fftconv_time_sharded != one K11 launch")
    require(torch.equal(tail, x3[..., -k11.overlap:]), "fftconv_time_sharded: carried tail")
    del rs, is_, r1, i1, xin
    xb = torch.cat([tail, x3[..., :C3_SAMPLES]], dim=-1)
    t = in_turns(torch, {"sharded": lambda: dfused.fftconv_time_sharded(k11, tail, shards, mesh5),
                         "K11 one launch": lambda: kfc.fftconv_pallas(k11, xb)}, 2 * REPS)
    print(f"[14] fftconv_time_sharded: {C3_CHANNELS} ch x {C14_BUFFERS} buffers of {C3_SAMPLES} "
          f"samples over {C14_FFT_SHARDS} shards == one K11 launch over both (torch.equal), tail "
          f"equal; per buffer sharded {np.median(t['sharded']):.4f} ms, one launch "
          f"{np.median(t['K11 one launch']):.4f} ms ({2 * REPS} turns)", flush=True)
    del x3, xb, shards, tail

    # the distributed config-5 pipeline at the complex tier: build_config5's
    # mesh form, then the pre-filter and channelizer streams (C14_BUFFERS
    # buffers) and the PSK demod on the channel shards
    mesh4 = legs[0][1]
    b1 = build_config5(C5_COMPLEX_FRAMES, C5_CHANNELS, device=dev)
    bm = build_config5(C5_COMPLEX_FRAMES, C5_CHANNELS, mesh=mesh4)
    idx1, soft1 = b1.step(*b1.example)
    idxm, softm = bm.step(*bm.example)
    dsoft = float((softm - soft1).abs().max())
    require(torch.equal(idxm, idx1) and dsoft <= 2e-5,
            f"build_config5 mesh form: indices equal {torch.equal(idxm, idx1)}, soft {dsoft}")
    t = in_turns(torch, {"mesh": lambda: bm.step(*bm.example),
                         "single": lambda: b1.step(*b1.example)}, REPS)
    x5 = b1.example[0]
    pre = lowpass(C14_PRE_TAPS, 0.45)
    proto = design_prototype(C5_CHANNELS, 8)
    nb = x5.shape[-1] // C14_BUFFERS
    tail_f = torch.zeros(C14_PRE_TAPS - 1, dtype=torch.complex64, device=dev)
    tail_c = torch.zeros(pad_prototype(proto, C5_CHANNELS).shape[0] - 1, dtype=torch.complex64,
                         device=dev)
    tail_c1 = tail_c
    fouts, couts, cexact = [], [], []
    y1 = fir_full(pre, x5)
    for b in range(C14_BUFFERS):
        tail_f, ys = dhalo.fir_time_sharded_stream(pre, tail_f,
                                                   dmesh.shard(x5[b * nb:(b + 1) * nb], mesh4),
                                                   mesh4)
        tail_c, banks = dchan.channelize_time_sharded_stream(proto, tail_c, ys, C5_CHANNELS,
                                                             mesh4)
        fouts.append(dmesh.unshard(ys, dev))
        couts.append(banks)
        tail_c1, exact = dchan.channelize_time_sharded_stream(
            proto, tail_c1, dmesh.shard(y1[b * nb:(b + 1) * nb], mesh4), C5_CHANNELS, mesh4)
        cexact.append(dmesh.unshard(exact, dev, dim=0))
    yf = torch.cat(fouts)
    f_eq = bool(torch.equal(yf, y1))
    bank1 = channelize_full(proto, y1, C5_CHANNELS)
    c_eq = bool(torch.equal(torch.cat(cexact, dim=-1), bank1))
    psk = make_psk_params(0.0, decim=1, sps=C5_SPS, order=C5_ORDER, rrc_span=4, device=dev)
    shards_c = tuple(torch.cat([c[q] for c in couts], dim=-1) for q in range(C14_SHARDS))
    outs = dmesh.map_shards(lambda bk: psk_apply(psk, psk_init(psk, (bk.shape[0],)), bk)[1],
                            mesh4, shards_c)
    pidx = torch.cat([o[0] for o in outs])
    psoft = torch.cat([o[1] for o in outs])
    ridx, rsoft = psk_apply(psk, psk_init(psk, (C5_CHANNELS,)), bank1)[1]
    p_soft = float((psoft - rsoft).abs().max())
    print(f"[14] config 5 mesh form ({C14_SHARDS} shards, {C5_CHANNELS} ch x {C5_COMPLEX_FRAMES} "
          f"frames): indices == single device, soft max diff {dsoft:.3e} (floor 2e-5); step "
          f"{np.median(t['mesh']):.3f} ms against {np.median(t['single']):.3f} ms single-device "
          f"({REPS} turns); pipeline ({C14_BUFFERS} buffers, pre-filter lowpass"
          f"({C14_PRE_TAPS}, 0.45)): FIR stream == fir_full {f_eq}, channelizer stream == "
          f"channelize_full {c_eq}, PSK on channel shards: indices "
          f"== single-device pipeline {bool(torch.equal(pidx, ridx))}, soft max diff "
          f"{p_soft:.3e} (floor 2e-5)", flush=True)
    require(f_eq, "pipeline FIR stream != fir_full (torch.equal)")
    require(c_eq, "pipeline channelizer stream != channelize_full (torch.equal)")
    require(torch.equal(pidx, ridx) and p_soft <= 2e-5,
            f"pipeline PSK: indices equal {torch.equal(pidx, ridx)}, soft {p_soft}")
    del b1, bm, idx1, soft1, idxm, softm, x5, y1, yf, fouts, couts, cexact, bank1, shards_c

    # bodies with no collective: codeword-sharded K14, block-sharded K16,
    # channel-sharded FSK demod, each equal to the unsharded call
    led = build_ldpc("edges", C12_EDGES_BATCH, device=dev)
    llr = led.example[0]
    ref = led.step(llr)
    got = dmesh.map_shards(led.step, mesh4, dmesh.shard(llr, mesh4, dim=0))
    ldpc_eq = all(torch.equal(torch.cat([g[j] for g in got]), ref[j]) for j in range(3))
    trb = build_turbo(C12_TURBO_T, batch=C12_TURBO_BATCH, layout="kernel", device=dev)
    ref = trb.step(*trb.example)
    bt = C12_TURBO_BATCH // C14_SHARDS
    got = dmesh.map_shards(lambda a, b, c: turbo_decode_pallas(trb.meta["tc"], a, b, c,
                                                               iters=trb.meta["iters"],
                                                               b_tile=bt),
                           mesh4, *(dmesh.shard(v, mesh4, dim=0) for v in trb.example))
    turbo_eq = all(torch.equal(torch.cat([g[j] for g in got]), ref[j]) for j in range(2))
    nsym, decim, sps, fdev = C14_FSK_SYMBOLS, 4, 8, 0.05
    bits = random_bits(np.random.default_rng(14), (C14_FSK_CHANNELS, nsym))
    xf = torch.as_tensor(fsk_baseband(bits, decim * sps, fdev / decim)
                         * tone(nsym * decim * sps, 0.11), device=dev)
    prm = make_fsk_params(0.11, 64, 0.03, decim, sps, fdev, device=dev)
    meshc = dmesh.make_mesh(channel=C14_SHARDS, devices=[dev] * C14_SHARDS)
    got = dmesh.map_shards(lambda v: fsk_apply(prm, fsk_init(prm, (v.shape[0],)), v)[1], meshc,
                           dmesh.shard(xf, meshc, "channel", dim=0), axis="channel")
    rx, soft = fsk_apply(prm, fsk_init(prm, (C14_FSK_CHANNELS,)), xf)[1]
    gsoft = torch.cat([g[1] for g in got])
    fsk_bits = bool(torch.equal(torch.cat([g[0] for g in got]), rx))
    fsk_rel = float(torch.linalg.norm(gsoft - soft) / torch.linalg.norm(soft))
    print(f"[14] sharded bodies over {C14_SHARDS} shards: K14 decode of {C12_EDGES_BATCH} "
          f"codewords == unsharded {ldpc_eq}; K16 turbo of {C12_TURBO_BATCH} blocks == unsharded "
          f"{turbo_eq}; FSK demod of {C14_FSK_CHANNELS} channels: bits == unsharded {fsk_bits}, "
          f"soft == unsharded (torch.equal) {bool(torch.equal(gsoft, soft))} (rel L2 "
          f"{fsk_rel:.3e})", flush=True)
    require(ldpc_eq and turbo_eq, "sharded K14 / K16 decode != unsharded")
    require(fsk_bits and torch.equal(gsoft, soft),
            f"sharded FSK: bits {fsk_bits}, soft not equal (rel L2 {fsk_rel})")


def op_count(torch, fn) -> int:
    """Torch operations one call of fn dispatches, views left out. Almost
    each launches one kernel on the card (an allocation such as `empty`
    launches none), so this is about the launch count of a plain-torch path."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def error_mask(rng: np.random.Generator, shape: tuple, counts) -> np.ndarray:
    """Boolean [B, n]: counts[b] distinct random positions set in row b."""
    ranks = np.argsort(np.argsort(rng.random(shape), axis=1), axis=1)
    return ranks < np.broadcast_to(np.asarray(counts), (shape[0],))[:, None]


def phase15(torch, dev) -> None:
    """The classical FEC tier (plain torch, no kernel of ours): the CCSDS
    concatenated link, RS, Viterbi, BCH, Golay, polar SC and SCL, the
    scrambler and HDLC framing, each GPU result equal (torch.equal) to the
    port's own CPU run on the same numpy-made inputs, each timed (CUDA-event
    median) with its coded Mb/s and its torch operations a call."""
    import binascii

    from srcdsp_tpu_torch import bch, fec, gf2, golay, hdlc, interleave, polar, rs

    cpu = torch.device("cpu")
    card = card_line()

    def same(a, b) -> bool:
        return len(a) == len(b) and all(torch.equal(x.cpu(), y) for x, y in zip(a, b))

    def report(tag, ms, coded_bits, ops, extra=""):
        print(f"[15] {tag}: {ms:.3f} ms per call, {coded_bits / ms / 1e3:.1f} Mb/s coded, "
              f"{ops} torch ops a call{extra} ({card})", flush=True)

    # --- 1. CCSDS concatenated link: CRC-32, RS(255,223), I = 4, K=7 r1/2, BPSK
    nmsg, depth = C15_MESSAGES, C15_DEPTH
    ngroups = nmsg // depth
    spec = gf2.make_crc(0x04C11DB7, 32, 0xFFFFFFFF, 0xFFFFFFFF, reflect=True)
    cc = fec.make_conv_code(7, (0o171, 0o133))
    rs_code = {d: rs.make_rs_code(255, 223, device=d) for d in (dev, cpu)}
    msg_np = np.random.default_rng(0).integers(0, 256, (nmsg, 223), dtype=np.uint8)
    msb = torch.arange(7, -1, -1)

    def crc_of(m):
        s = gf2.crc_update(spec, gf2.crc_init(spec, device=m.device),
                           gf2.byte_tensor_bits(m, lsb_first=True))
        return gf2.crc_value(spec, s)

    def transmit(m):
        cw = rs.rs_encode(rs_code[m.device], m)
        groups = interleave.block_interleave(cw.reshape(ngroups, depth * 255), depth, 255)
        info = gf2.byte_tensor_bits(groups)                  # MSB first, [G, 8160]
        return cw, info, fec.conv_encode(cc, info)           # [G, 2 (8160 + 6)]

    def to_words(hat):
        rx = (hat.reshape(ngroups, depth * 255, 8) << msb.to(hat.device)).sum(-1)
        return interleave.block_deinterleave(rx.to(torch.uint8), depth, 255).reshape(nmsg, 255)

    sigma = float(np.sqrt(1.0 / (2 * 0.5 * 10 ** (2.5 / 10))))   # Eb/N0 2.5 dB at rate 1/2
    runs = []
    for d in (dev, cpu):
        m = torch.as_tensor(msg_np, device=d)
        crc_tx = crc_of(m)
        cw, info, coded = transmit(m)
        noise = (sigma * np.random.default_rng(1).standard_normal(tuple(coded.shape))).astype(
            np.float32)
        soft = fec.bpsk_soft(coded) + torch.as_tensor(noise, device=d)
        hat = fec.viterbi_decode(cc, soft)
        recv = to_words(hat)
        out, ok = rs.rs_decode(rs_code[d], recv)
        runs.append((crc_tx, cw, coded, soft, hat, recv, out, ok, crc_of(out), info))
    crc_tx, cw, coded, soft, hat, recv, out, ok, crc_rx, info = runs[0]
    want = [binascii.crc32(m.tobytes()) for m in msg_np]
    sym_errs = int((recv != cw).sum())
    bit_errs = int((hat != info).sum())
    link_same = same(runs[0][:9], runs[1][:9])
    ms_vit = median_ms(torch, lambda: fec.viterbi_decode(cc, soft), reps=3)
    ms_rs = median_ms(torch, lambda: rs.rs_decode(rs_code[dev], recv))
    print(f"[15] CCSDS link ({nmsg} x RS(255,223), I = {depth}, {ngroups} K=7 frames of "
          f"{info.shape[-1]} info bits, {coded.shape[-1] // 2} trellis steps, Eb/N0 2.5 dB): "
          f"inner bit errors {bit_errs}, symbol errors {sym_errs}; every word ok "
          f"{bool(ok.all())}, equal to its message {bool(torch.equal(out.cpu(), torch.as_tensor(msg_np)))}; "
          f"CRC-32 == binascii.crc32 {crc_tx.cpu().tolist() == want}, after decoding "
          f"{crc_rx.cpu().tolist() == want}; GPU == CPU (torch.equal) {link_same}", flush=True)
    require(crc_tx.cpu().tolist() == want, "CCSDS link: CRC-32 on the card != binascii.crc32")
    require(sym_errs > 0, "CCSDS link: the inner decoder left no symbol error")
    require(bool(ok.all()) and torch.equal(out.cpu(), torch.as_tensor(msg_np)),
            "CCSDS link: a word not recovered")
    require(crc_rx.cpu().tolist() == want, "CCSDS link: CRC-32 after decoding differs")
    require(link_same, "CCSDS link: GPU != CPU")
    report("CCSDS viterbi_decode", ms_vit, coded.numel(), op_count(torch, lambda: fec.viterbi_decode(cc, soft)))
    report("CCSDS rs_decode", ms_rs, recv.numel() * 8, op_count(torch, lambda: rs.rs_decode(rs_code[dev], recv)))
    del runs, crc_tx, cw, coded, soft, hat, recv, out, ok, crc_rx, info

    # --- 2. RS alone: 512 words, 16 byte errors each (bench/fec_onchip.py rs)
    rng = np.random.default_rng(0)
    msg_np = rng.integers(0, 256, (C15_RS_BATCH, 223), dtype=np.uint8)
    cw_np = rs.rs_encode(rs_code[cpu], torch.as_tensor(msg_np)).numpy()
    mask = error_mask(rng, cw_np.shape, 16)
    recv_np = cw_np ^ np.where(mask, rng.integers(1, 256, cw_np.shape), 0).astype(np.uint8)
    recv = torch.as_tensor(recv_np, device=dev)
    got = rs.rs_decode(rs_code[dev], recv)
    ref = rs.rs_decode(rs_code[cpu], torch.as_tensor(recv_np))
    ms = median_ms(torch, lambda: rs.rs_decode(rs_code[dev], recv))
    fixed = bool(got[1].all()) and torch.equal(got[0].cpu(), torch.as_tensor(msg_np))
    report(f"RS(255,223) alone, {C15_RS_BATCH} words x 16 byte errors", ms, recv.numel() * 8,
           op_count(torch, lambda: rs.rs_decode(rs_code[dev], recv)),
           f"; all corrected and ok {fixed}; GPU == CPU {same(got, ref)}")
    require(fixed and same(got, ref), "RS alone: not all corrected, or GPU != CPU")

    # --- 3. Viterbi alone: B 512, T 512, noise 0.6 (bench/fec_onchip.py viterbi)
    u = np.random.default_rng(0).integers(0, 2, (C15_VIT_BATCH, C15_VIT_T))
    coded_np = fec.conv_encode(cc, torch.as_tensor(u)).numpy()
    noise = (C15_VIT_NOISE * np.random.default_rng(1).standard_normal(coded_np.shape)).astype(
        np.float32)
    soft_np = (1.0 - 2.0 * coded_np).astype(np.float32) + noise
    soft = torch.as_tensor(soft_np, device=dev)
    got = fec.viterbi_decode(cc, soft)
    ref = fec.viterbi_decode(cc, torch.as_tensor(soft_np))
    ms = median_ms(torch, lambda: fec.viterbi_decode(cc, soft))
    ber = float((got.cpu().numpy() != u).mean())
    report(f"Viterbi alone, K=7, B {C15_VIT_BATCH}, T {C15_VIT_T}, noise {C15_VIT_NOISE}", ms,
           soft.numel(), op_count(torch, lambda: fec.viterbi_decode(cc, soft)),
           f"; BER {ber}; GPU == CPU {same([got], [ref])}")
    require(same([got], [ref]), "Viterbi alone: GPU != CPU")

    # --- 4. BCH(31,21), POCSAG: 4096 words, 2 bit errors each
    bch_code = {d: bch.make_bch_code(5, 2, device=d) for d in (dev, cpu)}
    rng = np.random.default_rng(0)
    msg_np = rng.integers(0, 2, (C15_BCH_BATCH, 21))
    cw_np = bch.bch_encode(bch_code[cpu], torch.as_tensor(msg_np)).numpy()
    recv_np = cw_np ^ error_mask(rng, cw_np.shape, 2)
    recv = torch.as_tensor(recv_np, device=dev)
    got = bch.bch_decode(bch_code[dev], recv)
    ref = bch.bch_decode(bch_code[cpu], torch.as_tensor(recv_np))
    ms = median_ms(torch, lambda: bch.bch_decode(bch_code[dev], recv))
    fixed = bool(got[1].all()) and torch.equal(got[0].cpu(), torch.as_tensor(msg_np, dtype=torch.int32))
    report(f"BCH(31,21) t 2, {C15_BCH_BATCH} words x 2 bit errors", ms, recv.numel(),
           op_count(torch, lambda: bch.bch_decode(bch_code[dev], recv)),
           f"; all corrected and ok {fixed}; GPU == CPU {same(got, ref)}")
    require(fixed and same(got, ref), "BCH: not all corrected, or GPU != CPU")

    # --- 5. Golay(24,12): 65,536 words with 0-3 errors, 4,096 with 4
    gc = golay.make_golay()
    rng = np.random.default_rng(0)
    data_np = rng.integers(0, 2, (C15_GOLAY_WORDS + C15_GOLAY_FOUR, 12))
    cw_np = golay.golay_encode(gc, torch.as_tensor(data_np)).numpy()
    counts = np.concatenate([np.arange(C15_GOLAY_WORDS) % 4, np.full(C15_GOLAY_FOUR, 4)])
    recv_np = cw_np ^ error_mask(rng, cw_np.shape, counts)
    recv = torch.as_tensor(recv_np, device=dev)
    got = golay.golay_decode(gc, recv)
    ref = golay.golay_decode(gc, torch.as_tensor(recv_np))
    ms = median_ms(torch, lambda: golay.golay_decode(gc, recv))
    nc = C15_GOLAY_WORDS
    fixed = (bool(got[2][:nc].all()) and torch.equal(got[0][:nc].cpu(), torch.as_tensor(
        data_np[:nc], dtype=torch.int32)) and torch.equal(got[1][:nc].cpu(), torch.as_tensor(
            counts[:nc], dtype=torch.int32)))
    flagged = not bool(got[2][nc:].any())
    report(f"Golay(24,12), {nc} words x 0-3 errors + {C15_GOLAY_FOUR} x 4", ms, recv.numel(),
           op_count(torch, lambda: golay.golay_decode(gc, recv)),
           f"; 0-3 corrected {fixed}, every 4-error word flagged {flagged}; GPU == CPU "
           f"{same(got, ref)}")
    require(fixed and flagged and same(got, ref), "Golay: a word miscorrected, or GPU != CPU")

    # --- 6. polar N 256, K 128, 3 dB (bench/polar_onchip.py): SC at B 32,768, SCL-8 at B 1,024
    pc = polar.make_polar(C15_POLAR_N, C15_POLAR_K)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, (C15_SC_BATCH, pc.k))
    cw_np = polar.polar_encode(pc, torch.as_tensor(u)).numpy()
    sig = float(10.0 ** (-C15_POLAR_SNR / 20.0))
    llr_np = (2.0 / sig ** 2 * ((1.0 - 2.0 * cw_np) + sig * rng.standard_normal(cw_np.shape))
              ).astype(np.float32)
    llr = torch.as_tensor(llr_np, device=dev)
    got = polar.polar_decode(pc, llr)
    ref = polar.polar_decode(pc, torch.as_tensor(llr_np))
    ms = median_ms(torch, lambda: polar.polar_decode(pc, llr))
    ber = float((got[0].cpu().numpy() != u).mean())
    report(f"polar SC, N {pc.n}, K {pc.k}, {C15_POLAR_SNR} dB, B {C15_SC_BATCH}", ms, llr.numel(),
           op_count(torch, lambda: polar.polar_decode(pc, llr)),
           f"; BER {ber}; GPU == CPU {same(got, ref)}")
    require(same(got, ref), "polar SC: GPU != CPU")
    nb, lsz = C15_SCL_BATCH, C15_SCL_L
    llr_s = llr[:nb].contiguous()

    def scl():
        return polar.polar_decode_list(pc, llr_s, lsz)

    outs = [scl(), polar.polar_decode_list_onehot(pc, llr_s, lsz),
            polar.polar_decode_list_onehot(pc, llr_s, lsz, fast=True)]
    ref = polar.polar_decode_list(pc, torch.as_tensor(llr_np[:nb]), lsz)
    agree = all(same(outs[0], [o.cpu() for o in v]) for v in outs)
    ber = float((outs[0][0][:, 0].cpu().numpy() != u[:nb]).mean())
    print(f"[15] polar SCL L {lsz}, B {nb}: gather == one-hot == fast (torch.equal) {agree}; "
          f"GPU == CPU {same(outs[0], ref)}; BER {ber}", flush=True)
    require(agree and same(outs[0], ref), "polar SCL: forms disagree or GPU != CPU")
    report(f"polar SCL-{lsz}, B {nb}", median_ms(torch, scl, reps=3), llr_s.numel(),
           op_count(torch, scl))
    del outs, ref, llr, llr_s, got

    # --- 7. framing: the 802.11 scrambler over 32 streams of 2^20 bits in one
    # call and in two uneven chunks; an HDLC round trip of 2^20 bits
    scr = gf2.make_scrambler((4, 7), 7)
    bits_np = np.random.default_rng(0).integers(0, 2, (C15_SCR_STREAMS, C15_SCR_BITS))
    split = C15_SCR_BITS // 3 + 1

    def scramble_on(d, chunks):
        s = gf2.gf2_init(scr, 0x5D, device=d)
        x = torch.as_tensor(bits_np, device=d)
        ys = []
        for a, b in zip((0,) + chunks, chunks + (C15_SCR_BITS,)):
            s, y = gf2.scramble(scr, s, x[:, a:b])
            ys.append(y)
        return s, torch.cat(ys, dim=-1)

    one = scramble_on(dev, ())
    two = scramble_on(dev, (split,))
    ref = scramble_on(cpu, ())
    chunks_same = all(torch.equal(a, b) for a, b in zip(one, two))
    ms = median_ms(torch, lambda: scramble_on(dev, ()), reps=3)
    report(f"802.11 scrambler, {C15_SCR_STREAMS} x {C15_SCR_BITS} bits", ms, bits_np.size,
           op_count(torch, lambda: scramble_on(dev, ())),
           f"; two chunks (split {split}) == one call {chunks_same}; GPU == CPU {same(one, ref)}")
    require(chunks_same and same(one, ref), "scrambler: chunks != one call, or GPU != CPU")

    pay_np = np.random.default_rng(1).integers(0, 2, C15_HDLC_BITS).astype(np.int32)
    pay = torch.as_tensor(pay_np, device=dev)
    st = hdlc.stuff_bits(pay)
    st_ref = hdlc.stuff_bits(torch.as_tensor(pay_np))
    stuffed = hdlc.compact_bits(st[0], st[1])
    frame = torch.as_tensor(np.concatenate([hdlc.FLAG, stuffed, hdlc.FLAG]), device=dev)
    flags = hdlc.find_flags(frame)
    where = torch.nonzero(flags).flatten().cpu().tolist()
    body = frame[8:-8]
    de = hdlc.destuff_bits(body)
    de_ref = hdlc.destuff_bits(body.cpu())
    back = hdlc.compact_bits(de[0], de[1])
    round_trip = bool(np.array_equal(back, pay_np))
    hdlc_same = (same(st, st_ref) and same(de, de_ref)
                 and torch.equal(flags.cpu(), hdlc.find_flags(frame.cpu())))
    ms_st = median_ms(torch, lambda: hdlc.stuff_bits(pay))
    ms_de = median_ms(torch, lambda: hdlc.destuff_bits(body))
    ms_fl = median_ms(torch, lambda: hdlc.find_flags(frame))
    print(f"[15] HDLC, {pay.numel()} payload bits -> {stuffed.size} stuffed: round trip {round_trip}, "
          f"flags at {where} (frame of {frame.numel()}); GPU == CPU {hdlc_same}", flush=True)
    report("HDLC stuff_bits", ms_st, pay.numel(), op_count(torch, lambda: hdlc.stuff_bits(pay)))
    report("HDLC destuff_bits", ms_de, body.numel(), op_count(torch, lambda: hdlc.destuff_bits(body)))
    report("HDLC find_flags", ms_fl, frame.numel(), op_count(torch, lambda: hdlc.find_flags(frame)))
    require(round_trip and where == [0, frame.numel() - 8] and hdlc_same,
            "HDLC: round trip, flags or GPU == CPU failed")


def warp_clock(x: np.ndarray, amp: float, period: float) -> np.ndarray:
    """Resample each row at t(n) = n + amp*sin(2*pi*n/period): a bounded,
    sinusoidally wandering symbol clock (linear interpolation, float64)."""
    n = np.arange(x.shape[-1] - int(np.ceil(amp)) - 1, dtype=np.float64)
    t = n + amp * np.sin(2 * np.pi * n / period)
    i0 = np.floor(t).astype(np.int64)
    f = t - i0
    return ((1 - f) * x[..., i0] + f * x[..., i0 + 1]).astype(np.complex64)


def sustained_clock(x: np.ndarray, rho: float) -> np.ndarray:
    """Resample each row at t(n) = n*(1 + rho): a clock rho fast, whose
    offset accumulates whole symbols."""
    nmax = int((x.shape[-1] - 2) / (1 + rho))
    t = np.arange(nmax, dtype=np.float64) * (1 + rho)
    i0 = np.floor(t).astype(np.int64)
    f = t - i0
    return ((1 - f) * x[..., i0] + f * x[..., i0 + 1]).astype(np.complex64)


def best_errors(tx: np.ndarray, rx: np.ndarray, order: int, settle: int, lags: int = 24) -> int:
    """Fewest errors of rx against tx over lags -lags..lags and, for an
    M-PSK order > 2, the M constellation rotations (the carrier loop's
    ambiguity), after `settle` symbols; order 2 compares bits as they are."""
    best = None
    for lag in range(-lags, lags + 1):
        ts, rs = settle + max(lag, 0), settle + max(-lag, 0)
        n = min(tx.shape[-1] - ts, rx.shape[-1] - rs) - 16
        a, b = tx[ts:ts + n], rx[rs:rs + n]
        for rot in range(order if order > 2 else 1):
            err = int(np.count_nonzero((b + rot) % order != a))
            best = err if best is None else min(best, err)
    return best


def phase16(torch, dev, launches) -> None:
    """The synchronization and block-equalizer tier (plain torch; the coded
    OFDM modem decodes through K15): each step at the JAX probes' full
    width, its decisions held against the port's own CPU run of the same
    call on the same numpy-made inputs and against the transmitted data,
    timed (CUDA events; the closed loops by the host clock), with the torch
    operations one call dispatches. K15's launches are read before and
    after the modem."""
    from srcdsp_tpu_torch.chains import feedforward, ofdm, ofdm_planes, ook, scfde, scfde_planes
    from srcdsp_tpu_torch.chains import tracking_planes as tp
    from srcdsp_tpu_torch.chains.fsk import make_fsk_params
    from srcdsp_tpu_torch.chains.modem import map_codewords_to_symbols
    from srcdsp_tpu_torch.chains.ofdm_modem import make_ofdm_coded_modem
    from srcdsp_tpu_torch.chains.psk import make_psk_params
    from srcdsp_tpu_torch.chains.qam import qam_constellation
    from srcdsp_tpu_torch.chains.tracking import compact_ragged
    from srcdsp_tpu_torch.kernels.ldpc_pallas import plan_qc
    from srcdsp_tpu_torch.ops.fir import fir_full
    from srcdsp_tpu_torch.ops.resample import resample_full
    from srcdsp_tpu_torch.qcldpc import (make_dual_diagonal_base, make_qc_ldpc,
                                         qc_encode_dual_diagonal)
    from srcdsp_tpu_torch.testing.signals import fsk_baseband, ook_baseband

    cpu = torch.device("cpu")
    card = card_line()
    c = C16_CHANNELS

    def report(tag, ms, samples, ops, clock="CUDA-event median of 5", extra=""):
        print(f"[16] {tag}: {ms:.3f} ms per call ({clock}), {samples / ms / 1e3:.1f} Ms/s "
              f"aggregate, {ops} torch ops a call, {ms * 1e3 / ops:.1f} us an op{extra} "
              f"({card})", flush=True)

    def rel_l2(a, b) -> float:
        return float(torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b))

    def shaped_qpsk(rng, nsym, sps):
        """[C, nsym*sps] QPSK at (m + 0.5)/4 turns, RRC-shaped on the card."""
        data = rng.integers(0, 4, (c, nsym))
        sym = np.exp(2j * np.pi * (data + 0.5) / 4).astype(np.complex64)
        taps = make_psk_params(0.0, 1, sps, 4, device=dev).taps
        return data, resample_full(taps, torch.as_tensor(sym, device=dev), up=sps,
                                   down=1).cpu().numpy(), taps

    # --- 1. feedforward PSK, bounded: 8 x 8*2^16, QPSK, sps 4, block 128 ----
    rng = np.random.default_rng(0)
    n = C16_FF_SAMPLES
    data, shaped, taps = shaped_qpsk(rng, n // 4 + 64, 4)
    x = warp_clock(shaped, 1.5, 2048.0)
    x = (x * np.exp(2j * np.pi * 1e-4 * np.arange(x.shape[-1]))[None]).astype(np.complex64)
    y = fir_full(taps, torch.as_tensor(x, device=dev))
    k = (y.shape[-1] // C16_FF_BLOCK) * C16_FF_BLOCK
    yr, yi = y.real[:, :k].contiguous(), y.imag[:, :k].contiguous()

    def ff(a, b):
        return feedforward.ff_psk_demod_planes(a, b, 4, 4, block=C16_FF_BLOCK)

    idx = ff(yr, yi)[0]
    idx_c = ff(yr.cpu(), yi.cpu())[0]
    same = bool(torch.equal(idx.cpu(), idx_c))
    errs = [best_errors(data[ch], idx[ch].cpu().numpy(), 4, C16_SETTLE) for ch in range(c)]
    report(f"feedforward PSK bounded ({c} x {k}, QPSK sps 4, block {C16_FF_BLOCK}, warp 1.5 / "
           f"2048, CFO 1e-4)", median_ms(torch, lambda: ff(yr, yi)), c * k,
           op_count(torch, lambda: ff(yr, yi)), extra=f"; == CPU run {same}; symbol errors "
           f"after {C16_SETTLE} {errs}")
    require(same and max(errs) == 0, f"feedforward PSK: == CPU {same}, errors {errs}")

    # --- 2. feedforward PSK, ragged: the same at a 3000 ppm fast clock -------
    rng = np.random.default_rng(0)
    data, shaped, taps = shaped_qpsk(rng, int(n * (1 + C16_RHO)) // 4 + 64, 4)
    y = fir_full(taps, torch.as_tensor(sustained_clock(shaped, C16_RHO), device=dev))
    k = (y.shape[-1] // C16_FF_BLOCK) * C16_FF_BLOCK
    yr, yi = y.real[:, :k].contiguous(), y.imag[:, :k].contiguous()

    def ffr(a, b):
        out = feedforward.ff_psk_demod_ragged(a, b, 4, 4, block=C16_FF_BLOCK)
        return out[0], out[2]

    idx, valid = ffr(yr, yi)
    idx_c, valid_c = ffr(yr.cpu(), yi.cpu())
    same = bool(torch.equal(idx.cpu(), idx_c) and torch.equal(valid.cpu(), valid_c))
    got = compact_ragged(idx, valid)
    counts = [g.size for g in got]
    errs = [best_errors(data[ch], got[ch], 4, C16_SETTLE) for ch in range(c)]
    report(f"feedforward PSK ragged ({c} x {k}, {C16_RHO * 1e6:.0f} ppm)",
           median_ms(torch, lambda: ffr(yr, yi)), c * k, op_count(torch, lambda: ffr(yr, yi)),
           extra=f"; idx and valid == CPU run {same}; emitted {min(counts)}..{max(counts)} "
           f"symbols against {k // 4} nominal; symbol errors {errs}")
    require(same, "feedforward PSK ragged: decisions or valid mask != CPU run")
    require(min(counts) > k // 4 + 10, f"ragged count {counts} does not follow the clock")
    require(max(errs) == 0, f"feedforward PSK ragged: symbol errors {errs}")
    del y, yr, yi, shaped, x

    # --- 3./4. closed-loop PSK and FSK tracking planes, 2 blocks each --------
    def track(name, params_of, init, apply, planes, block, order, tx):
        outs = []
        for d in (dev, cpu):
            params = params_of(d)
            st = init(params, c)
            blocks = []
            t0 = time.perf_counter()
            for b in range(C16_TRACK_BLOCKS):
                st, o = apply(params, st, planes[:, :, b * block:(b + 1) * block].to(d))
                blocks.append(o[0])
            out = torch.cat(blocks, dim=-1).cpu()     # waits for the card
            if not outs:
                secs = time.perf_counter() - t0
                st_card, p_card = st, params
            outs.append(out)
        mismatch = float((outs[0] != outs[1]).to(torch.float32).mean())
        got = outs[0].numpy()
        if order == 2:
            got = got.astype(np.int64)
        errs = [best_errors(tx[ch], got[ch], order, C16_SETTLE, lags=160) for ch in range(c)]
        ms = secs * 1e3 / C16_TRACK_BLOCKS
        x0 = planes[:, :, :block].to(dev)
        ops = op_count(torch, lambda: apply(p_card, st_card, x0))
        report(f"{name} ({c} x block {block}, {C16_TRACK_BLOCKS} blocks; the probe ran 8: "
               f"a depth cut for time)", ms, c * block, ops, clock="host clock, one run",
               extra=f"; mismatch against the CPU run {mismatch:.2e}; errors after "
               f"{C16_SETTLE} {errs}; {ops / (got.shape[-1] // C16_TRACK_BLOCKS):.1f} ops a "
               f"symbol")
        require(mismatch <= 1e-3, f"{name}: mismatch against the CPU run {mismatch}")
        require(max(errs) == 0, f"{name}: errors after settle {errs}")

    rng = np.random.default_rng(0)
    nblk = C16_TRACK_BLOCKS * C16_PSK_BLOCK
    data, shaped, _ = shaped_qpsk(rng, nblk // 4 + 64, 4)
    x = warp_clock(shaped, 1.5, 2048.0)[:, :nblk]
    planes = torch.as_tensor(np.stack([x.real, x.imag], axis=1).astype(np.float32))
    track("closed-loop PSK tracking planes (QPSK sps 4, warp 1.5 / 2048)",
          lambda d: make_psk_params(0.0, 1, 4, 4, device=d), tp.psk_track_planes_init,
          tp.psk_track_planes_apply, planes, C16_PSK_BLOCK, 4, data)

    nblk = C16_TRACK_BLOCKS * C16_FSK_BLOCK
    bits = np.random.default_rng(2).integers(0, 2, (c, nblk // 16 + 64))
    x = warp_clock(fsk_baseband(bits, 16, 0.02), 1.5, 4096.0)[:, :nblk]
    planes = torch.as_tensor(np.stack([x.real, x.imag], axis=1).astype(np.float32))
    track("closed-loop FSK tracking planes (decim 2, sps 8, dev 0.02, warp 1.5 / 4096)",
          lambda d: make_fsk_params(0.0, 64, 0.45 / 2, 2, 8, 0.04, device=d),
          tp.fsk_track_planes_init, tp.fsk_track_planes_apply, planes, C16_FSK_BLOCK, 2, bits)
    del planes, x, shaped

    # --- 5. OFDM planes receiver: 8 x 16,384 symbols, 16-QAM ---------------
    spec = ofdm.make_ofdm_spec(64, 16, 52, 16)
    rng = np.random.default_rng(0)
    pts = qam_constellation(16)
    pilot = pts[rng.integers(0, 16, 52)]
    data_idx = rng.integers(0, 16, (c, C16_OFDM_SYMBOLS, 52))
    grid = np.concatenate([np.broadcast_to(pilot, (c, 1, 52)), pts[data_idx]], axis=1)
    tx = ofdm.ofdm_modulate(spec, torch.as_tensor(grid.reshape(-1, 52), device=dev))
    tx = tx.cpu().numpy().reshape(c, -1)
    y = tx.astype(np.complex128)
    y[:, 1:] += 0.2 * np.exp(0.5j) * tx[:, :-1]
    y = y + 0.01 * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    args = [torch.as_tensor(np.ascontiguousarray(a, np.float32))
            for a in (y.real, y.imag, pilot.real, pilot.imag)]
    rx = {d: ofdm_planes.make_ofdm_rx_planes(spec, device=d) for d in (dev, cpu)}
    on_card = [a.to(dev) for a in args]
    idx, (zr, zi) = rx[dev](*on_card)
    idx_c, (zr_c, zi_c) = rx[cpu](*args)
    same = bool(torch.equal(idx.cpu(), idx_c))
    ser = float((idx.cpu().numpy() != data_idx).mean())
    soft = max(rel_l2(zr, zr_c), rel_l2(zi, zi_c))
    report(f"OFDM planes receiver ({c} x {C16_OFDM_SYMBOLS} symbols, nfft 64, cp 16, 52 "
           f"active, 16-QAM, 2-tap channel, noise 0.01)", median_ms(torch, lambda: rx[dev](*on_card)),
           c * y.shape[-1], op_count(torch, lambda: rx[dev](*on_card)),
           extra=f"; idx == CPU run {same}; SER {ser}; soft rel L2 {soft:.2e}")
    require(same and ser == 0.0 and soft <= 1e-5, f"OFDM planes: == CPU {same}, SER {ser}, "
            f"soft {soft}")
    del y, tx, grid, args, on_card, zr, zi, zr_c, zi_c

    # --- 6. SC-FDE planes receiver: 8 x 4,096 blocks, n 256, QPSK ----------
    rng = np.random.default_rng(0)
    sp = {d: scfde.make_scfde_spec(256, 32, device=d) for d in (dev, cpu)}
    pts = qam_constellation(4)
    data_idx = rng.integers(0, 4, (c, C16_SCFDE_BLOCKS, 256))
    tx = torch.stack([scfde.scfde_tx(sp[dev], torch.as_tensor(pts[data_idx[ch]], device=dev))
                      for ch in range(c)]).cpu().numpy()
    y = tx.astype(np.complex128)
    y[:, 2:] += 0.3 * np.exp(1.1j) * tx[:, :-2]
    y = y + 0.02 * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    args = [torch.as_tensor(np.ascontiguousarray(a, np.float32)) for a in (y.real, y.imag)]
    rx = {d: scfde_planes.make_scfde_rx_planes(sp[d], order=4, snr=200.0, device=d)
          for d in (dev, cpu)}
    on_card = [a.to(dev) for a in args]
    idx, (zr, zi) = rx[dev](*on_card)
    idx_c, (zr_c, zi_c) = rx[cpu](*args)
    same = bool(torch.equal(idx.cpu(), idx_c))
    ser = float((idx.cpu().numpy() != data_idx).mean())
    soft = max(rel_l2(zr, zr_c), rel_l2(zi, zi_c))
    report(f"SC-FDE planes receiver ({c} x {C16_SCFDE_BLOCKS} blocks, n 256, cp 32, QPSK, "
           f"3-tap channel, noise 0.02, snr 200)", median_ms(torch, lambda: rx[dev](*on_card)),
           c * y.shape[-1], op_count(torch, lambda: rx[dev](*on_card)),
           extra=f"; idx == CPU run {same}; SER {ser}; soft rel L2 {soft:.2e}")
    require(same and ser == 0.0, f"SC-FDE planes: == CPU {same}, SER {ser}")
    del y, tx, args, on_card, zr, zi, zr_c, zi_c

    # --- 7. coded OFDM modem through K15: 8 x 512 codewords, z 128 ---------
    z, nw = C16_MODEM_Z, C16_MODEM_WORDS
    base = make_dual_diagonal_base(4, 12, z, seed=0)
    plan = plan_qc(base, z)
    n_cw, k_cw = 12 * z, 8 * z
    spc = n_cw // 4
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.integers(0, 2, (c * nw, k_cw)), device=dev)
    cw = qc_encode_dual_diagonal(base, z, u)
    sidx = map_codewords_to_symbols(cw, 16).cpu().numpy().reshape(c, nw * spc)
    pts = qam_constellation(16)
    s_data = -(-(nw * spc) // 52)
    fill = rng.integers(0, 16, (c, s_data * 52 - nw * spc))
    pilot = pts[rng.integers(0, 16, 52)]
    grid = np.concatenate([np.broadcast_to(pilot, (c, C16_MODEM_PILOTS, 52)),
                           pts[np.concatenate([sidx, fill], axis=1)].reshape(c, s_data, 52)],
                          axis=1)
    tx = ofdm.ofdm_modulate(spec, torch.as_tensor(grid.reshape(-1, 52), device=dev))
    tx = tx.cpu().numpy().reshape(c, -1)
    y = tx.astype(np.complex128)
    y[:, 1:] += 0.2 * np.exp(0.5j) * tx[:, :-1]
    sigma = 10.0 ** (-C16_MODEM_SNR / 20.0) / np.sqrt(2.0)
    y = y + sigma * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    args = [torch.as_tensor(np.ascontiguousarray(a, np.float32))
            for a in (y.real, y.imag, pilot.real, pilot.imag)]
    pipe = {d: make_ofdm_coded_modem(spec, make_qc_ldpc(base, z, device=d), plan,
                                     num_channels=c, nw=nw, iters=6,
                                     n_pilot=C16_MODEM_PILOTS, device=d)
            for d in (dev, cpu)}
    on_card = [a.to(dev) for a in args]
    k15_before = launches["ldpc_qc"]
    bits_t, ok = pipe[dev](*on_card)
    k15_launches = launches["ldpc_qc"] - k15_before
    bits_c, ok_c = pipe[cpu](*args)
    same = bool(torch.equal(bits_t.cpu(), bits_c) and torch.equal(ok.cpu(), ok_c))
    decoded = bool(torch.equal(bits_t.T, cw.to(torch.int32)))
    ms = median_ms(torch, lambda: pipe[dev](*on_card))
    report(f"coded OFDM modem (OFDM planes -> demap -> K15, {c} x {nw} codewords, z {z}, n "
           f"{n_cw}, 6 iterations, 16-QAM, {C16_MODEM_SNR:.0f} dB, {C16_MODEM_PILOTS} pilot "
           f"symbols)", ms, c * y.shape[-1],
           op_count(torch, lambda: pipe[dev](*on_card)),
           extra=f"; {c * nw * n_cw / ms / 1e3:.1f} Mb/s coded; ok all {bool(ok.all())}, "
           f"decoded == transmitted ({c * nw} codewords) {decoded}, == CPU run (plain K15) "
           f"{same}; K15 launches in the first call {k15_launches}")
    require(k15_launches >= 1, "coded OFDM modem: K15 never launched")
    require(bool(ok.all()) and decoded, "coded OFDM modem: a codeword not recovered")
    require(same, "coded OFDM modem: card != CPU run")
    del y, tx, grid, args, on_card, bits_t, bits_c

    # --- 8. OOK: 32 x 2^20 samples, sps 8, rise 3 ---------------------------
    rng = np.random.default_rng(0)
    nbit = C16_OOK_SAMPLES // C16_OOK_SPS
    bits = rng.integers(0, 2, (C16_OOK_CHANNELS, nbit))
    x = torch.as_tensor(ook_baseband(bits, C16_OOK_SPS, rise=3))
    par = ook.make_ook_params(C16_OOK_SPS)
    xd = x.to(dev)
    got, strobes = ook.ook_demod_full(par, xd)
    got_c, strobes_c = ook.ook_demod_full(par, x)
    same = bool(torch.equal(got.cpu(), got_c))
    errs = [best_errors(bits[ch], got[ch].cpu().numpy(), 2, C16_SETTLE, lags=4)
            for ch in range(C16_OOK_CHANNELS)]
    report(f"OOK ({C16_OOK_CHANNELS} x {C16_OOK_SAMPLES}, sps {C16_OOK_SPS}, rise 3)",
           median_ms(torch, lambda: ook.ook_demod_full(par, xd)), x.numel(),
           op_count(torch, lambda: ook.ook_demod_full(par, xd)),
           extra=f"; bits == CPU run {same}; strobes rel L2 {rel_l2(strobes, strobes_c):.2e}; "
           f"bit errors after {C16_SETTLE} {max(errs)} (worst channel)")
    require(same and max(errs) == 0, f"OOK: == CPU {same}, errors {errs}")


def tone_snr_db(a: np.ndarray, f: float, skip: int = 512) -> np.ndarray:
    """Per row of real audio a [C, N]: the SNR in dB of a tone at f cycles a
    sample, by a least-squares cos/sin fit after `skip` samples."""
    a = np.asarray(a, np.float64)[..., skip:]
    a = a - a.mean(axis=-1, keepdims=True)
    k = np.arange(a.shape[-1])
    basis = np.stack([np.cos(2 * np.pi * f * k), np.sin(2 * np.pi * f * k)])   # [2, N]
    coef = a @ basis.T * (2.0 / a.shape[-1])                                    # [C, 2]
    resid = a - coef @ basis
    return 10 * np.log10((coef ** 2).sum(-1) / 2 / np.maximum((resid ** 2).mean(-1), 1e-30))


def phase17(torch, dev) -> None:
    """The CSS modem and the rest of the plane-tier chains (plain torch, no
    kernel of ours), each step on the card held against the port's own CPU
    run of the same call on the same numpy-made inputs (the batched channel
    steps on their first C17_CPU_CHANNELS channels), timed (CUDA events; the
    host-driven loops by the host clock), with the torch operations one call
    dispatches."""
    from srcdsp_tpu_torch.chains import (analog, blindscan, css, css_planes, dqpsk, dsss,
                                         equalizer, fhss, framesync, mlse, msk)
    from srcdsp_tpu_torch.ops.fft_planes import fft_planes_flops
    from srcdsp_tpu_torch.ops.fir import fir_full
    from srcdsp_tpu_torch.ops.window import root_raised_cosine
    from srcdsp_tpu_torch.testing.signals import fsk_baseband, gmsk_baseband, tone

    cpu = torch.device("cpu")
    card = card_line()
    c, n, cc = C17_CHANNELS, C17_SAMPLES, C17_CPU_CHANNELS

    def report(tag, ms, samples, ops, clock="CUDA-event median of 5", extra=""):
        print(f"[17] {tag}: {ms:.3f} ms per call ({clock}), {samples / ms / 1e3:.1f} Ms/s "
              f"aggregate, {ops} torch ops a call, {ms * 1e3 / ops:.1f} us an op{extra} "
              f"({card})", flush=True)

    def rel_l2(a, b) -> float:
        a, b = a.cpu(), b.cpu()
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    def host_ms(fn):
        """One call of fn by the host clock, the card synchronized around it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def awgn(rng, shape, sigma):
        return sigma * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))

    # --- (a) the coded CSS link: bench/css_modem_onchip.py's shape -------------
    rng = np.random.default_rng(0)
    p = css.make_css_params(sf=C17_SF, cr=C17_CR)
    nsym = css.css_frame_nsym(p, C17_PLEN)
    pls = [bytes(rng.integers(0, 256, C17_PLEN, dtype=np.uint8)) for _ in range(C17_FRAMES)]
    shifts = np.concatenate([css.css_encode_frame(p, q) for q in pls])
    tx = css.css_modulate(p, shifts)
    x = (tx + awgn(rng, tx.size, np.sqrt(10 ** (-C17_SNR / 10) / 2))).astype(np.complex64)
    fr = x.reshape(-1, p.n)
    planes = [torch.as_tensor(np.ascontiguousarray(a, np.float32)) for a in (fr.real, fr.imag)]
    on_card = [a.to(dev) for a in planes]
    llr_fn = {d: css_planes.make_css_llr_planes(p, device=d) for d in (dev, cpu)}
    llr = llr_fn[dev](*on_card)
    llr_c = llr_fn[cpu](*planes)
    soft = rel_l2(llr, llr_c)
    llr3 = llr.reshape(C17_FRAMES, nsym, p.sf)
    pays, oks = css.css_decode_frames_soft_batch(p, llr3, C17_PLEN)
    pays_c, oks_c = css.css_decode_frames_soft_batch(p, llr_c.reshape(C17_FRAMES, nsym, p.sf),
                                                     C17_PLEN)
    n_ok = sum(bool(o) and q == w for o, q, w in zip(oks, pays, pls))
    same = pays == pays_c and bool(np.array_equal(oks, oks_c))
    s_sym = fr.shape[0]
    ms_llr = median_ms(torch, lambda: llr_fn[dev](*on_card))
    ms_dec = median_ms(torch, lambda: css.css_decode_frames_soft_batch(p, llr3, C17_PLEN))
    gflop = 4 * 2 * s_sym * p.n * p.n / 1e9
    report(f"CSS LLR planes (sf {p.sf}, {s_sym} symbols = {C17_FRAMES} frames of "
           f"{C17_PLEN} bytes, cr {C17_CR}, {C17_SNR:.0f} dB; folded DFT, {gflop:.1f} GFLOP)",
           ms_llr, s_sym * p.n, op_count(torch, lambda: llr_fn[dev](*on_card)),
           extra=f"; {gflop / ms_llr:.1f} TFLOP/s; LLR rel L2 against the CPU run {soft:.2e}")
    report(f"CSS batch soft decode ({C17_FRAMES} frames, float64 ML + GF(2) CRC on the card)",
           ms_dec, s_sym * p.n, op_count(torch, lambda: css.css_decode_frames_soft_batch(
               p, llr3, C17_PLEN)),
           extra=f"; frames back {n_ok}/{C17_FRAMES}; payloads and flags == CPU run {same}; "
           f"{C17_FRAMES / ms_dec:.1f} frames a ms")
    print(f"[17] coded CSS link: {s_sym * p.sf / (ms_llr + ms_dec) / 1e3:.1f} Mb/s coded "
          f"({s_sym * p.sf} coded bits a call; LLR {ms_llr:.3f} + decode {ms_dec:.3f} ms), "
          f"{C17_FRAMES * C17_PLEN * 8 / (ms_llr + ms_dec) / 1e3:.1f} Mb/s of payload "
          f"({card})", flush=True)
    require(n_ok == C17_FRAMES, f"coded CSS: {n_ok} of {C17_FRAMES} frames back")
    require(soft <= 1e-5, f"coded CSS: LLR rel L2 {soft} against the CPU run")
    require(same, "coded CSS: batch decode on the card != CPU run")
    del x, tx, fr, planes, on_card, llr, llr_c, llr3

    # --- (b) CSS demod planes: bench/css_onchip.py's defaults, and sf 11 ----
    for sf, direct in ((C17_SF, True), (C17_SF, False), (C17_SF_WIDE, False)):
        rng = np.random.default_rng(0)
        pd = css.make_css_params(sf=sf)
        ks = rng.integers(0, pd.n, C17_DEMOD_SYMS)
        xs = css.css_modulate(pd, ks) * np.exp(0.3j)
        xs = (xs + awgn(rng, xs.size, np.sqrt(10 ** (-C17_DEMOD_SNR / 10) / 2))
              ).astype(np.complex64).reshape(C17_DEMOD_SYMS, pd.n)
        planes = [torch.as_tensor(np.ascontiguousarray(a, np.float32)) for a in (xs.real, xs.imag)]
        on_card = [a.to(dev) for a in planes]
        fn = {d: css_planes.make_css_demod_planes(pd, direct=direct, device=d) for d in (dev, cpu)}
        k = fn[dev](*on_card)[0]
        k_c = fn[cpu](*planes)[0]
        same = bool(torch.equal(k.cpu(), k_c))
        ser = float((k.cpu().numpy() != ks).mean())
        ms = median_ms(torch, lambda: fn[dev](*on_card))
        flops = (8 * C17_DEMOD_SYMS * pd.n * pd.n if direct
                 else fft_planes_flops(C17_DEMOD_SYMS, pd.n) + 6 * C17_DEMOD_SYMS * pd.n)
        form = "direct fold" if direct else "four-step"
        report(f"CSS demod planes, {form} (sf {sf}, {C17_DEMOD_SYMS} symbols, "
               f"{C17_DEMOD_SNR:.0f} dB)", ms, C17_DEMOD_SYMS * pd.n,
               op_count(torch, lambda: fn[dev](*on_card)),
               extra=f"; {flops / ms / 1e9:.1f} TFLOP/s; shifts == CPU run {same}; SER {ser}")
        require(same and ser == 0.0, f"CSS demod sf {sf} {form}: == CPU {same}, SER {ser}")
        del xs, planes, on_card

    # --- (c) the burst receiver over a stream of 16 bursts ------------------
    # Gaps drawn uniformly over 200-4000 chips (any offset from the frame grid,
    # N/2 included) and CFOs uniformly over [-2.5, 2.5] bins (any fraction):
    # the repaired sync (chains/css.css_sync) resolves the two wraps the
    # reference's commits to. Every burst is gated: its payload back, and the
    # card's results and starts equal to the CPU run's. Two more bursts sit
    # on the wraps, N/2 off the grid (a CFO fraction of 0.3) and a CFO of
    # exactly 1.5 bins: both must decode, with the CPU run's payloads and
    # flags; at the exact half-bin fraction float rounding picks the side of
    # the wrap, so the start may differ from the CPU run's by one chip.
    rng = np.random.default_rng(1)
    pls = [bytes(rng.integers(0, 256, C17_PLEN, dtype=np.uint8)) for _ in range(C17_BURSTS)]

    def burst_stream(gaps, cfos, payloads):
        parts, starts, pos = [], [], 0
        for gap, cfo, q in zip(gaps, cfos, payloads):
            b = css.css_transmit(p, q)
            parts += [np.zeros(gap), b * np.exp(2j * np.pi * cfo / p.n * np.arange(b.size))]
            starts.append(pos + gap + css.preamble_len(p))
            pos += gap + b.size
        xs = np.concatenate(parts + [np.zeros(2000)])
        sigma = np.sqrt(10 ** (-C17_STREAM_SNR / 10) / 2)
        return (xs + awgn(rng, xs.size, sigma)).astype(np.complex64), starts

    gaps = [int(g) for g in rng.integers(200, 4001, C17_BURSTS)]
    cfos = rng.uniform(-2.5, 2.5, C17_BURSTS)
    xs, starts = burst_stream(gaps, cfos, pls)
    xd = torch.as_tensor(xs, device=dev)
    got, ms = host_ms(lambda: css.css_receive_stream(p, xd, C17_PLEN))
    got_c = css.css_receive_stream(p, xs, C17_PLEN, device=cpu)
    back = [g[0] for g in got] == pls
    same = got == got_c
    report(f"CSS burst receiver ({C17_BURSTS} bursts, {xs.size} chips, CFO uniform over -2.5..2.5 "
           f"bins, gaps uniform over 200-4000 chips, {C17_STREAM_SNR:.0f} dB)", ms, xs.size,
           op_count(torch, lambda: css.css_receive_stream(p, xd, C17_PLEN)),
           clock="host clock, one run",
           extra=f"; grid offsets {[int(s_ % p.n) for s_ in starts]}, CFO fractions "
           f"{[round(float(c_ - np.round(c_)), 3) for c_ in cfos]}; payloads back {back}; results "
           f"and starts == CPU run {same}; starts == transmitted {[g[2] for g in got] == starts}")
    require(back and same, f"CSS stream: payloads back {back}, == CPU run {same}")
    xs, amb_starts = burst_stream([2 * p.n + p.n // 2, 700], [0.3, 1.5], pls[:2])
    amb = css.css_receive_stream(p, torch.as_tensor(xs, device=dev), C17_PLEN)
    amb_c = css.css_receive_stream(p, xs, C17_PLEN, device=cpu)
    decoded = [g[0] for g in amb] == pls[:2] and all(g[1] for g in amb)
    agree = (len(amb) == len(amb_c) == 2
             and [g[:2] for g in amb] == [g[:2] for g in amb_c]
             and amb[0][2] == amb_c[0][2] and abs(amb[1][2] - amb_c[1][2]) <= 1)
    print(f"[17] CSS sync wraps (a burst N/2 off the grid, a CFO of exactly 1.5 bins): decoded "
          f"{decoded}, starts {[g[2] for g in amb]} (transmitted {amb_starts}); CPU run "
          f"{[(g[0] == q, g[1], g[2]) for g, q in zip(amb_c, pls)]}; == CPU run {agree} ({card})",
          flush=True)
    require(decoded and agree, f"CSS sync wraps: decoded {decoded}, == CPU run {agree}")
    del xs, xd

    # --- (d) the blind survey: 2^22 samples, three signals; detect_css --------
    rng = np.random.default_rng(0)
    ns = C17_SCAN_SAMPLES
    xs = awgn(rng, ns, 0.02)
    sym = np.exp(2j * np.pi * (rng.integers(0, 4, ns // 8) + 0.5) / 4)
    up = np.zeros(ns, np.complex128)
    up[::8] = sym
    xs += np.convolve(up, root_raised_cosine(8, 8))[:ns] * tone(ns, 0.15)
    xs += 0.7 * fsk_baseband(rng.integers(0, 2, ns // 16), 16, 0.01) * tone(ns, -0.22)
    xs += 0.5 * tone(ns, 0.35)
    xs = xs.astype(np.complex64)
    xd = torch.as_tensor(xs, device=dev)
    dets = blindscan.scan(xd, nfft=C17_SCAN_NFFT)
    dets_c = blindscan.scan(xs, nfft=C17_SCAN_NFFT, device=cpu)
    same = (len(dets) == len(dets_c)
            and all(a.bandwidth == b.bandwidth and abs(a.center - b.center) <= 1e-6
                    for a, b in zip(dets, dets_c)))
    top3 = sorted(round(d.center, 3) for d in dets[:3])
    found = bool(np.allclose(top3, [-0.22, 0.15, 0.35], atol=0.01))
    report(f"blind scan (nfft {C17_SCAN_NFFT} over {ns} samples: QPSK, CPFSK, a tone)",
           median_ms(torch, lambda: blindscan.scan(xd, nfft=C17_SCAN_NFFT)), ns,
           op_count(torch, lambda: blindscan.scan(xd, nfft=C17_SCAN_NFFT)),
           extra=f"; {len(dets)} detections, top three at {top3}; == CPU run {same}")
    require(same and found, f"blind scan: == CPU {same}, centers {top3}")
    rng = np.random.default_rng(5)
    p9 = css.make_css_params(sf=C17_DETECT_SF)
    xs = css.css_modulate(p9, rng.integers(0, p9.n, C17_SCAN_SAMPLES // 4 // p9.n))
    xs = np.concatenate([np.zeros(173), xs])[: C17_SCAN_SAMPLES // 4]
    xs = xs * np.exp(2j * np.pi * 0.013 * np.arange(xs.size))
    xs = (xs + awgn(rng, xs.size, np.sqrt(10 ** 0.5 / 2))).astype(np.complex64)
    xd = torch.as_tensor(xs, device=dev)
    res = blindscan.detect_css(xd)
    res_c = blindscan.detect_css(xs, device=cpu)
    same = (res["detected"], res["sf"], res["direction"]) == (
        res_c["detected"], res_c["sf"], res_c["direction"]) and all(
        abs(res["scores"][k_] - res_c["scores"][k_]) <= 0.01 + 1e-9 for k_ in res_c["scores"])
    report(f"detect_css ({xs.size} chips of sf {C17_DETECT_SF} at -5 dB, CFO 0.013, offset 173)",
           median_ms(torch, lambda: blindscan.detect_css(xd)), xs.size,
           op_count(torch, lambda: blindscan.detect_css(xd)),
           extra=f"; detected {res['detected']}, sf {res['sf']}, {res['direction']}, score "
           f"{res['score']}; == CPU run {same}")
    require(res["detected"] and res["sf"] == C17_DETECT_SF and same,
            f"detect_css: {res}, == CPU {same}")
    del xs, xd, up

    # --- (e) the rest, batched channels at 32 x 2^20 samples ------------------
    # frame sync: a 64-symbol QPSK preamble, 8 bursts a channel at 10 dB
    rng = np.random.default_rng(42)
    pre = np.exp(2j * np.pi * (rng.integers(0, 4, 64) + 0.5) / 4).astype(np.complex64)
    xs = awgn(rng, (c, n), 10 ** (-0.5) / np.sqrt(2)).astype(np.complex64)
    slots = np.stack([np.sort(rng.choice(n // 4096 - 2, 8, replace=False)) + 1 for _ in range(c)])
    fs_starts = slots * 4096 + rng.integers(0, 2048, (c, 8))
    for ch in range(c):
        for s in fs_starts[ch]:
            xs[ch, s:s + 64] += pre
    fsp = {d: framesync.make_frame_sync_params(pre, device=d) for d in (dev, cpu)}
    xd = torch.as_tensor(xs, device=dev)

    def fs_run(d, v):
        return framesync.frame_sync_apply(fsp[d], framesync.frame_sync_init(fsp[d], (v.shape[0],)),
                                          v)[1]

    score, mask, first = fs_run(dev, xd)
    score_c, mask_c, _ = fs_run(cpu, torch.as_tensor(xs[:cc]))
    same = bool(torch.equal(mask[:cc].cpu(), mask_c))
    peaks = [np.flatnonzero(m_) + int(first) - 63 for m_ in mask.cpu().numpy()]
    hit = all(np.array_equal(pk, np.unique(st)) for pk, st in zip(peaks, fs_starts))
    report(f"frame sync ({c} x {n}, 64-symbol preamble, 8 bursts a channel, 10 dB)",
           median_ms(torch, lambda: fs_run(dev, xd)), c * n, op_count(torch, lambda: fs_run(dev, xd)),
           extra=f"; masks == CPU run {same} (channels 0-{cc - 1}); scores rel L2 "
           f"{rel_l2(score[:cc], score_c):.2e}; every burst start found {hit}")
    require(same and hit and rel_l2(score[:cc], score_c) <= 1e-5,
            f"frame sync: == CPU {same}, starts {hit}")
    del xs, xd, score, mask, score_c

    # MSK: GMSK BT 0.3 at sps 8, 12 dB Eb/N0, the Laurent matched filter
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (c, n // 8))
    xs = gmsk_baseband(bits, 8, bt=0.3)
    xs = (xs + awgn(rng, xs.shape, np.sqrt(8 / 10 ** 1.2 / 2))).astype(np.complex64)
    c0 = msk.laurent_c0(8, bt=0.3, c_span=4)
    xd = torch.as_tensor(xs, device=dev)
    b_, s_ = msk.msk_coherent_demod(xd, 8, c0)
    b_c, s_c = msk.msk_coherent_demod(torch.as_tensor(xs[:cc]), 8, c0)
    same = bool(torch.equal(b_[:cc].cpu(), b_c))
    ber = float((b_.cpu().numpy()[:, 8:] != bits[:, 1:b_.shape[-1] + 1][:, 8:]).mean())
    report(f"MSK coherent demod ({c} x {n}, GMSK BT 0.3, sps 8, 12 dB)",
           median_ms(torch, lambda: msk.msk_coherent_demod(xd, 8, c0)), c * n,
           op_count(torch, lambda: msk.msk_coherent_demod(xd, 8, c0)),
           extra=f"; bits == CPU run {same}; soft rel L2 {rel_l2(s_[:cc], s_c):.2e}; BER {ber}")
    require(same and ber < 1e-5 and rel_l2(s_[:cc], s_c) <= 1e-5, f"MSK: == CPU {same}, BER {ber}")
    del xs, xd, b_, s_

    # pi/4-DQPSK: decim 4, sps 8, center 0.11, 8 blocks of 2^17, 10 dB a sample
    rng = np.random.default_rng(2)
    dib = rng.integers(0, 4, (c, n // 32))
    syms = np.exp(1j * np.cumsum((2.0 * dib + 1.0) * (np.pi / 4.0), axis=-1))
    up = torch.zeros((c, n), dtype=torch.complex64, device=dev)
    up[:, ::32] = torch.as_tensor(syms.astype(np.complex64), device=dev)
    bb = fir_full(torch.as_tensor(root_raised_cosine(32, 8), device=dev), up) * 32.0
    xd = (bb * torch.as_tensor(tone(n, 0.11), device=dev)).cpu().numpy()
    xs = (xd + awgn(rng, xd.shape, np.sqrt(np.mean(np.abs(xd) ** 2) / 10 / 2))).astype(np.complex64)
    xd = torch.as_tensor(xs, device=dev)
    dqp = {d: dqpsk.make_dqpsk_params(0.11, 4, 8, device=d) for d in (dev, cpu)}
    idx, z = dqpsk.dqpsk_demod_stream(dqp[dev], xd, n // 8, (c,))
    idx_c, z_c = dqpsk.dqpsk_demod_stream(dqp[cpu], torch.as_tensor(xs[:cc]), n // 8, (cc,))
    same = bool(torch.equal(idx[:cc].cpu(), idx_c))
    ser = float(ber_per_channel(dib, idx.cpu().numpy(), settle=C16_SETTLE).max())
    report(f"pi/4-DQPSK ({c} x {n}, decim 4, sps 8, 8 blocks, 10 dB)",
           median_ms(torch, lambda: dqpsk.dqpsk_demod_stream(dqp[dev], xd, n // 8, (c,))), c * n,
           op_count(torch, lambda: dqpsk.dqpsk_demod_stream(dqp[dev], xd, n // 8, (c,))),
           extra=f"; dibits == CPU run {same}; z rel L2 {rel_l2(z[:cc], z_c):.2e}; SER after "
           f"{C16_SETTLE} symbols {ser} (worst channel)")
    require(same and ser == 0.0 and rel_l2(z[:cc], z_c) <= 1e-5, f"DQPSK: == CPU {same}, SER {ser}")
    del up, bb, xd, xs, idx, z

    # DSSS: SF 63, a two-path channel (0.8 at 5 chips) at -8 dB chip SNR, 2^20 chips
    rng = np.random.default_rng(0)
    dp = {d: dsss.make_dsss_params(device=d) for d in (dev, cpu)}
    nsym_d = n // 63
    dbits = rng.integers(0, 2, nsym_d)
    dbits[0] = 0
    chips = np.repeat(1.0 - 2.0 * dbits, 63) * np.tile(dsss.pn_msequence((6, 1), 6), nsym_d)
    delay = 29
    direct = np.zeros(n)
    direct[delay:delay + chips.size] = chips[: n - delay]
    xs = direct + 0.8 * np.exp(1.1j) * np.concatenate([np.zeros(5), direct[:-5]])
    xs = (xs * np.exp(0.4j) + awgn(rng, n, 10 ** 0.4 / np.sqrt(2))).astype(np.complex64)
    xd = torch.as_tensor(xs, device=dev)

    def rake(d, v):
        base = dsss.dsss_acquire(dp[d], v)
        metric = dsss.dsss_finger_search(dp[d], v)
        top2 = torch.topk(metric, 2).indices.cpu().numpy()
        delays = sorted((int(base) - int(t_)) % 63 for t_ in top2)
        return base, delays, dsss.dsss_rake_demod(dp[d], v, base, delays)

    base, delays, (rb, rs) = rake(dev, xd)
    base_c, delays_c, (rb_c, rs_c) = rake(cpu, torch.as_tensor(xs))
    same = int(base) == int(base_c) and delays == delays_c and bool(torch.equal(rb.cpu(), rb_c))
    m_ = min(rb.shape[0], nsym_d - 1)
    errs = int((rb.cpu().numpy()[:m_] != dbits[:m_]).sum())
    report(f"DSSS acquire + 2-finger RAKE (SF 63, {n} chips, paths 1 and 0.8 at 5 chips, "
           f"-8 dB)", median_ms(torch, lambda: rake(dev, xd)), n,
           op_count(torch, lambda: rake(dev, xd)),
           extra=f"; phase {int(base)} (sent {(63 - delay) % 63}), fingers {delays}; == CPU run "
           f"{same}; soft rel L2 {rel_l2(rs, rs_c):.2e}; bit errors {errs} of {m_}")
    require(same and int(base) == (63 - delay) % 63 and delays == [0, 5] and errs <= m_ // 1000,
            f"DSSS: == CPU {same}, phase {int(base)}, fingers {delays}, errors {errs}")
    del xs, xd

    # FHSS: dehop 32 x 2^20 (hops of 256 over 6 frequencies), acquire on one channel
    fp_ = fhss.make_fhss_params(np.asarray([-0.35, -0.2, -0.05, 0.1, 0.25, 0.4]),
                                np.asarray([0, 3, 1, 5, 2, 4, 0, 5, 3, 2, 4, 1]), 256)
    rng = np.random.default_rng(1)
    bb = (awgn(rng, (c, n), 0.25) + 1.0).astype(np.complex64)
    hop = fhss.fhss_hop(fp_, torch.as_tensor(bb, device=dev), seq_phase=7)
    back = fhss.fhss_dehop(fp_, hop, seq_phase=7)
    back_c = fhss.fhss_dehop(fp_, hop[:cc].cpu(), seq_phase=7)
    off = 3 * 256 // 8
    cap = torch.cat([torch.zeros(off, dtype=torch.complex64, device=dev), hop[0, :n // 8]])
    cap = cap + torch.as_tensor(awgn(rng, cap.shape[0], 0.16).astype(np.complex64), device=dev)
    acq = fhss.fhss_acquire(fp_, cap)
    acq_c = fhss.fhss_acquire(fp_, cap.cpu())
    err = rel_l2(back, torch.as_tensor(bb))
    report(f"FHSS dehop ({c} x {n}, hops of 256 over 6 frequencies)",
           median_ms(torch, lambda: fhss.fhss_dehop(fp_, hop, seq_phase=7)), c * n,
           op_count(torch, lambda: fhss.fhss_dehop(fp_, hop, seq_phase=7)),
           extra=f"; rel L2 against the CPU run {rel_l2(back[:cc], back_c):.2e}, against the "
           f"sent baseband {err:.2e}")
    _, ms = host_ms(lambda: fhss.fhss_acquire(fp_, cap))
    report(f"FHSS acquire ({cap.shape[0]} samples, 8 coarse offsets x 12 phases)", ms,
           cap.shape[0], op_count(torch, lambda: fhss.fhss_acquire(fp_, cap)),
           clock="host clock, one run",
           extra=f"; (offset, phase) {acq} (sent ({off}, 7)), == CPU run {acq == acq_c}")
    require(acq == acq_c == (off, 7) and err <= 1e-5 and rel_l2(back[:cc], back_c) <= 1e-5,
            f"FHSS: acquire {acq} / {acq_c}, dehop error {err}")
    del bb, hop, back, back_c, cap

    # block LMS (trained) and CMA: 8 x 2^16 QPSK symbols over [1, 0.45-0.2j, -0.25+0.1j]
    rng = np.random.default_rng(2)
    ce, ne = C17_EQ_CHANNELS, C17_EQ_SAMPLES
    s_eq = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, (ce, ne)))).astype(np.complex64)
    h1 = np.array([1.0, 0.45 - 0.2j, -0.25 + 0.1j])
    x_eq = np.stack([np.convolve(r, h1)[:ne] for r in s_eq])
    x_eq = (x_eq + awgn(rng, x_eq.shape, np.sqrt(np.mean(np.abs(x_eq) ** 2) * 1e-3 / 2))
            ).astype(np.complex64)
    xd, sd = torch.as_tensor(x_eq, device=dev), torch.as_tensor(s_eq, device=dev)

    def lms(d, v, s):
        return equalizer.lms_equalize(v, equalizer.eq_init(11, channel_shape=(v.shape[0],),
                                                           device=d), mu=0.1, block=64, d=s)

    def cma(d, v):
        return equalizer.cma_equalize(v, equalizer.eq_init(11, channel_shape=(v.shape[0],),
                                                           device=d), mu=0.05, block=64)

    def slicer(y):
        return equalizer.psk_slicer(y.cpu(), 4, offset=np.pi / 4)

    for name, run, run_c in (
            ("block LMS, trained", lambda: lms(dev, xd, sd),
             lambda: lms(cpu, torch.as_tensor(x_eq[:cc]), torch.as_tensor(s_eq[:cc]))),
            ("CMA, blind", lambda: cma(dev, xd), lambda: cma(cpu, torch.as_tensor(x_eq[:cc])))):
        (st, y, mse), ms = host_ms(run)
        st_c, y_c, mse_c = run_c()
        soft = rel_l2(y[:cc], y_c)
        dec_same = bool(torch.equal(slicer(y[:cc, ne // 2:]), slicer(y_c[:, ne // 2:])))
        report(f"{name} ({ce} x {ne}, 11 taps, block 64: {ne // 64} sequential updates)", ms,
               ce * ne, op_count(torch, run), clock="host clock, one run",
               extra=f"; y rel L2 against the CPU run {soft:.2e}, taps {rel_l2(st.w[:cc], st_c.w):.2e}; "
               f"decisions on the second half == CPU run {dec_same}; last-block MSE "
               f"{float(mse[:, -1].max()):.4f}")
        require(soft <= 1e-5 and dec_same, f"{name}: rel L2 {soft}, decisions equal {dec_same}")
    del xd, sd

    # the per-symbol loops: MLSE (null channel, BPSK, 12 dB), RLS (L 11), DFE (9 + 8)
    rng = np.random.default_rng(2)
    h = np.asarray([0.5, 0.7071, 0.5])
    tr = mlse.make_mlse(h, order=2)
    idx_m = rng.integers(0, 2, C17_MLSE_SYMBOLS)
    y = np.convolve(1.0 - 2.0 * idx_m, h)[: idx_m.size].astype(np.complex128)
    y = (y + awgn(rng, y.size, np.sqrt(np.mean(np.abs(y) ** 2) / 10 ** 1.2 / 2))).astype(np.complex64)
    yd = torch.as_tensor(y, device=dev)
    got, ms = host_ms(lambda: mlse.mlse_equalize(tr, yd))
    got_c = mlse.mlse_equalize(tr, torch.as_tensor(y))
    same = bool(torch.equal(got.cpu(), got_c))
    ber = float((got.cpu().numpy()[4:] != idx_m[4:]).mean())
    ops = op_count(torch, lambda: mlse.mlse_equalize(tr, yd))
    report(f"MLSE (null channel [0.5, 0.7071, 0.5], BPSK, {C17_MLSE_SYMBOLS} symbols, 12 dB)",
           ms, C17_MLSE_SYMBOLS, ops, clock="host clock, one run",
           extra=f"; decisions == CPU run {same}; BER {ber}; {ops / C17_MLSE_SYMBOLS:.1f} ops a "
           f"symbol")
    require(same and ber < 0.02, f"MLSE: == CPU {same}, BER {ber}")

    rng = np.random.default_rng(0)
    s_r = np.exp(1j * (2 * np.pi * (rng.integers(0, 4, C17_RLS_SYMBOLS) + 0.5) / 4))
    x_r = np.convolve(s_r, [0.25, 1.0, 0.35 - 0.2j, 0.15j])[: s_r.size]
    x_r = (x_r + awgn(rng, x_r.size, 0.02)).astype(np.complex64)
    s_r = s_r.astype(np.complex64)
    rng = np.random.default_rng(7)
    s_d = np.exp(1j * (2 * np.pi * (rng.integers(0, 4, C17_DFE_SYMBOLS) + 0.5) / 4))
    x_d = np.convolve(s_d, [1.0, 0.0, 0.55, 0.0, 0.4, 0.0, 0.3])[: s_d.size]
    x_d = (x_d + awgn(rng, x_d.size, 0.03)).astype(np.complex64)
    s_d = s_d.astype(np.complex64)
    for name, nsy, run in (
            ("RLS, trained (L 11, lambda 0.995)", C17_RLS_SYMBOLS,
             lambda d: equalizer.rls_equalize(torch.as_tensor(x_r, device=d),
                                              equalizer.rls_init(11, device=d), lam=0.995,
                                              d=torch.as_tensor(s_r, device=d))),
            ("DFE, trained (9 + 8 taps, mu 0.02)", C17_DFE_SYMBOLS,
             lambda d: equalizer.dfe_equalize(torch.as_tensor(x_d, device=d),
                                              equalizer.dfe_init(9, 8, device=d), mu=0.02,
                                              d=torch.as_tensor(s_d, device=d)))):
        (st, y, err), ms = host_ms(lambda: run(dev))
        st_c, y_c, err_c = run(cpu)
        soft = rel_l2(y, y_c)
        dec_same = bool(torch.equal(slicer(y[nsy // 4:]), slicer(y_c[nsy // 4:])))
        ops = op_count(torch, lambda: run(dev))
        report(f"{name}, {nsy} symbols", ms, nsy, ops, clock="host clock, one run",
               extra=f"; y rel L2 against the CPU run {soft:.2e}; decisions after {nsy // 4} == "
               f"CPU run {dec_same}; tail |e|^2 {float(err[-256:].mean()):.4f}; "
               f"{ops / nsy:.1f} ops a symbol")
        require(soft <= 1e-5 and dec_same, f"{name}: rel L2 {soft}, decisions {dec_same}")

    # FM, AM, SSB and the FM stereo receiver: 32 x 2^20 IQ samples, one call each
    k = np.arange(n)
    f_a = 0.002 + 0.0001 * np.arange(c)[:, None]
    audio = torch.as_tensor((0.7 * np.sin(2 * np.pi * f_a * k)).astype(np.float32), device=dev)
    left = 0.5 * np.cos(2 * np.pi * 0.001 * k)
    mpx = np.stack([analog.fm_stereo_mpx(left, 0.5 * np.cos(2 * np.pi * (0.0022 + 1e-5 * ch) * k),
                                         FM_PILOT / 4) for ch in range(c)])
    ssb_audio = 0.6 * np.sin(2 * np.pi * f_a * k)
    cases = (
        ("FM (decim 4, audio decim 2, de-emphasis tau 20)",
         lambda d: analog.make_fm_params(0.03, 4, 0.08, audio_decim=2, deemph_tau=20.0, device=d),
         analog.fm_init, analog.fm_apply,
         analog.fm_modulate(audio, 0.02, center=0.03), f_a[:, 0] * 8),
        ("AM (center 0.21, decim 4, audio decim 2)",
         lambda d: analog.make_am_params(0.21, 4, audio_decim=2, device=d),
         analog.am_init, analog.am_apply, analog.am_modulate(audio, 0.5, center=0.21),
         f_a[:, 0] * 8),
        ("SSB upper (center 0.22, decim 2, bandwidth 0.04)",
         lambda d: analog.make_ssb_params(0.22, 2, 0.04, device=d),
         analog.ssb_init, analog.ssb_apply,
         torch.as_tensor(analog.ssb_modulate(ssb_audio, 0.22), device=dev), f_a[:, 0] * 2),
        ("FM stereo receiver (center 0.07, decim 4, audio decim 4, 96 taps, tau 8)",
         lambda d: analog.make_fm_stereo_rx(0.07, 4, 0.08, FM_PILOT, audio_decim=4, num_taps=96,
                                            deemph_tau=8.0, device=d),
         analog.fm_stereo_rx_init, analog.fm_stereo_rx_apply,
         analog.fm_modulate(torch.as_tensor(mpx.astype(np.float32), device=dev), 0.02,
                            center=0.07), np.full(c, 0.001 * 16)))
    del audio, mpx
    for name, make, init, apply, iq, f_out in cases:
        par = {d: make(d) for d in (dev, cpu)}
        a = apply(par[dev], init(par[dev], (c,)), iq)[1]
        a_c = apply(par[cpu], init(par[cpu], (cc,)), iq[:cc].cpu())[1]
        soft = rel_l2(a[:cc], a_c)
        left_a = (a[:, 0] if a.ndim == 3 else a).cpu().numpy()
        snr = min(tone_snr_db(left_a[ch:ch + 1], f_out[ch], skip=left_a.shape[-1] // 4)[0]
                  for ch in range(c))
        ms = median_ms(torch, lambda: apply(par[dev], init(par[dev], (c,)), iq))
        report(f"{name} ({c} x {n})", ms, c * n,
               op_count(torch, lambda: apply(par[dev], init(par[dev], (c,)), iq)),
               extra=f"; audio rel L2 against the CPU run {soft:.2e}; worst channel's tone SNR "
               f"{snr:.1f} dB past the first quarter")
        require(soft <= 1e-5 and snr > 25.0, f"{name}: rel L2 {soft}, SNR {snr}")
        del iq, a



def phase18(torch, dev) -> None:
    """The ops tier (plain torch, no kernel of ours): radar, CFAR, the front-end
    impairment estimators, FAM and the acceleration search, DPD, FRESH, array
    processing and MIMO detection at their users' sizes, each step on the card
    held against the port's own CPU run of the same call (the batched steps on
    their first C18_CPU_CHANNELS channels) and against the reference tests'
    physics, timed (CUDA events; host-driven steps by the host clock), with the
    torch operations one call dispatches."""
    from srcdsp_tpu_torch import array, mimo
    from srcdsp_tpu_torch.chains import ofdm, psk, tx
    from srcdsp_tpu_torch.chains.qam import qam_constellation
    from srcdsp_tpu_torch.demap import psk_points
    from srcdsp_tpu_torch.ops import accel, cfar, cyclo, dpd, fresh, fresh_planes, impairments
    from srcdsp_tpu_torch.ops import radar
    from srcdsp_tpu_torch.ops.fir import fir_full
    from srcdsp_tpu_torch.ops.window import root_raised_cosine
    from srcdsp_tpu_torch.testing.channel import add_noise_snr, multipath_apply
    from srcdsp_tpu_torch.testing.signals import chirp, tone

    cpu = torch.device("cpu")
    card = card_line()
    cc = C18_CPU_CHANNELS

    def report(tag, ms, ops, clock="CUDA-event median of 5", rate="", extra=""):
        print(f"[18] {tag}: {ms:.3f} ms per call ({clock}){rate}, {ops} torch ops a call, "
              f"{ms * 1e3 / ops:.1f} us an op{extra}; peak memory since the step began "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})", flush=True)

    def rel_l2(a, b) -> float:
        a, b = a.cpu(), b.cpu()
        return float(torch.linalg.norm((a - b).reshape(-1)) / torch.linalg.norm(b.reshape(-1)))

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def near_mask_mismatch(mask, mask_c, power, thr_c, tol):
        """Cells where the card's mask differs from the CPU's, and how many of
        them lie further than `tol` (relative) from the CPU's threshold."""
        diff = mask.cpu() != mask_c
        far = (power.cpu() - thr_c).abs() > tol * thr_c.abs()
        return int(diff.sum()), int((diff & far).sum())

    def float64_threshold(pw, guard, train, pfa, greatest):
        w = guard + train
        pp = torch.cat([pw[..., 1:w + 1].flip(-1), pw, pw[..., -w - 1:-1].flip(-1)], dim=-1)
        c = torch.nn.functional.pad(torch.cumsum(pp, dim=-1), (1, 0))
        n = pw.shape[-1]
        lead = (c[..., w - guard:w - guard + n] - c[..., :n]) / train
        lag = (c[..., 2 * w + 1:2 * w + 1 + n] - c[..., w + guard + 1:w + guard + 1 + n]) / train
        if greatest:
            return cfar.cfar_alpha(train, pfa) * torch.maximum(lead, lag)
        return cfar.cfar_alpha(2 * train, pfa) * 0.5 * (lead + lag)

    def cn(gen, shape):
        z = torch.randn((2, *shape), generator=gen, device=dev)
        return torch.complex(z[0], z[1]) * np.float32(np.sqrt(0.5))

    def free(reset=True):
        """Return the freed tensors' memory; reset the peak for the next step."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if reset:
            torch.cuda.reset_peak_memory_stats()

    # --- (a) pulse-Doppler radar: 256 x 8192 cube, 8 targets --------------------
    free()
    rng = np.random.default_rng(0)
    p_, n_ = C18_PULSES, C18_RANGE
    ref = chirp(C18_CHIRP, -0.2, 0.2)
    delays = rng.choice(np.arange(200, n_ - C18_CHIRP - 200, 700), C18_TARGETS, replace=False)
    dopps = rng.choice(np.arange(-100, 100, 12), C18_TARGETS, replace=False)
    cube = ((rng.standard_normal((p_, n_)) + 1j * rng.standard_normal((p_, n_))) / np.sqrt(2))
    k = np.arange(p_)[:, None]
    for dl, fd in zip(delays, dopps):
        cube[:, dl: dl + C18_CHIRP] += 0.5 * ref[None, :] * np.exp(2j * np.pi * fd * k / p_)
    cube = cube.astype(np.complex64)
    noise = ((rng.standard_normal((p_, n_)) + 1j * rng.standard_normal((p_, n_))) / np.sqrt(2)
             ).astype(np.complex64)
    cube_d = torch.as_tensor(cube, device=dev)

    def rdmap(c):
        m = radar.range_doppler(c, ref)
        return (m.real ** 2 + m.imag ** 2).contiguous()

    pw = rdmap(cube_d)
    mask, thr = radar.cfar_2d(pw, guard=2, train=4, pfa=1e-6)
    dets, det_ms = host_ms(lambda: radar.detections(pw, mask))
    pw_c = rdmap(torch.as_tensor(cube))
    mask_c, thr_c = radar.cfar_2d(pw_c, guard=2, train=4, pfa=1e-6)
    dets_c = radar.detections(pw_c, mask_c)
    cells = {(p_ // 2 + int(fd), int(dl)) for dl, fd in zip(delays, dopps)}
    found = cells <= {(int(r[0]), int(r[1])) for r in dets}
    same_dets = ({(int(r[0]), int(r[1])) for r in dets} & cells
                 == {(int(r[0]), int(r[1])) for r in dets_c} & cells)
    mis, mis_far = near_mask_mismatch(mask, mask_c, pw, thr_c, 2e-2)
    map_err = rel_l2(pw, pw_c)
    nmask, _ = radar.cfar_2d(rdmap(torch.as_tensor(noise, device=dev)), guard=1, train=4, pfa=1e-3)
    pfa = float(nmask.float().mean())
    ms_rd = median_ms(torch, lambda: rdmap(cube_d))
    ms_cf = median_ms(torch, lambda: radar.cfar_2d(pw, guard=2, train=4, pfa=1e-6))
    report(f"radar range-Doppler map + |.|^2 ({p_} pulses x {n_} bins, chirp {C18_CHIRP})", ms_rd,
           op_count(torch, lambda: rdmap(cube_d)), rate=f", {p_ * n_ / ms_rd / 1e3:.1f} Ms/s",
           extra=f"; map rel L2 to the CPU run {map_err:.2e}")
    report("radar 2-D CA-CFAR (guard 2, train 4, pfa 1e-6)", ms_cf,
           op_count(torch, lambda: radar.cfar_2d(pw, guard=2, train=4, pfa=1e-6)),
           extra=f"; detections {len(dets)} ({det_ms:.1f} ms, host); all {C18_TARGETS} targets at "
           f"their cells {found}, == CPU run {same_dets}; masks differ on {mis} cells ({mis_far} "
           f"further than 2e-2 from the threshold); noise-cube pfa {pfa:.3e} (design 1e-3)")
    require(found and same_dets and mis_far == 0 and map_err <= 1e-5
            and 0.3e-3 < pfa < 3e-3,
            f"radar: targets {found}, == CPU {same_dets}, masks far {mis_far}, map {map_err}, "
            f"pfa {pfa}")
    del cube_d, pw, mask, thr, pw_c, mask_c, thr_c, nmask
    free()

    # --- (b) CFAR over 64 x 2^20 cells; impairments and the blanker over 32 x 2^20 --
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    c_, n_ = C18_CFAR_CHANNELS, C18_SAMPLES
    power = 3.7 * torch.empty((c_, n_), device=dev).exponential_(generator=gen)
    for name, fn, band in (("ca_cfar", cfar.ca_cfar, (0.5e-2, 2e-2)),
                           ("go_cfar_split", cfar.go_cfar_split, (0.1e-2, 2e-2))):
        det, thr = fn(power, guard=2, train=16, pfa=1e-2)
        det_c, thr_c = fn(power[:cc].cpu(), guard=2, train=16, pfa=1e-2)
        rate = float(det.float().mean())
        mis, mis_far = near_mask_mismatch(det[:cc], det_c, power[:cc], thr_c, 2e-2)
        err = rel_l2(thr[:cc], thr_c)
        # the reference's float32 running sums over 2^20 cells against float64 ones
        # (channel 0): the training sums are differences of sums that reach 4e6
        thr64 = float64_threshold(power[:1].double(), 2, 16, 1e-2, name == "go_cfar_split")
        err64 = (float(((thr[:1].double() - thr64).abs() / thr64).max()),
                 float(((thr_c[:1].double() - thr64.cpu()).abs() / thr64.cpu()).max()))
        ms = median_ms(torch, lambda: fn(power, guard=2, train=16, pfa=1e-2))
        report(f"{name} ({c_} x {n_} cells, guard 2, train 16, pfa 1e-2)", ms,
               op_count(torch, lambda: fn(power, guard=2, train=16, pfa=1e-2)),
               rate=f", {c_ * n_ / ms / 1e3:.1f} Mcells/s",
               extra=f"; false-alarm rate {rate:.4e}; thresholds rel L2 to the CPU run {err:.2e} "
               f"(worst cell against float64 sums: card {err64[0]:.2e}, CPU {err64[1]:.2e}); masks "
               f"differ on {mis} of {cc * n_} cells ({mis_far} further than 2e-2 from the "
               f"threshold)")
        require(band[0] < rate < band[1] and mis_far == 0 and err <= 1e-2,
                f"{name}: rate {rate}, mismatches far {mis_far}, thresholds {err}")
    del power, det, thr
    free()
    c_ = C18_IMP_CHANNELS
    rng = np.random.default_rng(1)
    gains, skews = rng.uniform(1.02, 1.15, c_), rng.uniform(-0.08, 0.08, c_)
    dcs = rng.uniform(-0.05, 0.05, c_) + 1j * rng.uniform(-0.05, 0.05, c_)
    freqs = rng.uniform(-0.2, 0.2, c_)
    kk = torch.arange(n_, dtype=torch.float64, device=dev)
    ph = torch.remainder(torch.as_tensor(freqs, device=dev)[:, None] * kk[None, :], 1.0)
    ang = (2 * np.pi * ph).to(torch.float32)
    clean = torch.polar(torch.ones_like(ang), ang)
    clean = clean + 0.1 * cn(gen, (c_, n_))
    i_, q_ = clean.real, clean.imag
    g_t = torch.as_tensor(gains, dtype=torch.float32, device=dev)[:, None]
    s_t = torch.as_tensor(skews, dtype=torch.float32, device=dev)[:, None]
    bad = torch.complex(i_, g_t * (torch.cos(s_t) * q_ + torch.sin(s_t) * i_))
    bad = bad + torch.as_tensor(dcs.astype(np.complex64), device=dev)[:, None]
    del clean, i_, q_, ph, kk, ang

    def estimators(x):
        st = impairments.moments_update(impairments.moments_init((x.shape[0],), device=x.device), x)
        dc = impairments.dc_offset(st)
        y1 = x - dc[:, None]
        g, phi = impairments.iq_imbalance_estimate(y1)
        y2 = impairments.iq_imbalance_correct(y1, g, phi)
        return (dc, g, phi, impairments.cfo_kay(y2), impairments.cfo_fft_peak(y2),
                impairments.snr_m2m4(y2))

    est = estimators(bad)
    est_c = estimators(bad[:cc].cpu())
    dc, g, phi, f_kay, f_fft, snr = (v.cpu().numpy() for v in est)
    worst = dict(dc=float(np.abs(dc - dcs).max()), gain=float(np.abs(g - gains).max()),
                 skew=float(np.abs(phi - skews).max()), kay=float(np.abs(f_kay - freqs).max()),
                 fft=float(np.abs(f_fft - freqs).max()),
                 snr_db=float(np.abs(10 * np.log10(snr) - 20.0).max()))
    est_err = max(rel_l2(a[:cc], b) for a, b in zip(est, est_c))
    st1 = impairments.moments_update(impairments.moments_init((c_,), device=dev), bad)
    st16 = impairments.moments_init((c_,), device=dev)
    for blk in bad.chunk(16, dim=-1):
        st16 = impairments.moments_update(st16, blk)
    g1, p1 = impairments.iq_imbalance_estimate(st1)
    g16, p16 = impairments.iq_imbalance_estimate(st16)
    stream_gap = (float((g1 - g16).abs().max() / g1.abs().max()), float((p1 - p16).abs().max()))
    ms = median_ms(torch, lambda: estimators(bad))
    report(f"impairment estimators (DC, IQ gain/skew, correction, Kay, FFT peak, M2M4; {c_} x {n_})",
           ms, op_count(torch, lambda: estimators(bad)), rate=f", {c_ * n_ / ms / 1e3:.1f} Ms/s",
           extra=f"; worst errors {worst}; == CPU run rel {est_err:.2e}; 16 blocks streamed "
           f"against one shot: gain {stream_gap[0]:.1e}, skew {stream_gap[1]:.1e}")
    require(worst["dc"] < 0.01 and worst["gain"] < 0.01 and worst["skew"] < 0.005
            and worst["kay"] < 1e-4 and worst["fft"] < 0.25 / n_ + 1e-6 and worst["snr_db"] < 0.5
            and est_err <= 1e-4 and stream_gap[0] <= 1e-5 and stream_gap[1] <= 1e-6,
            f"impairments: {worst}, == CPU {est_err}, streamed {stream_gap}")
    imp_pos = torch.as_tensor(np.stack([rng.choice(n_, 64, replace=False) for _ in range(c_)]),
                              device=dev)
    hits = bad.clone()
    rows = torch.arange(c_, device=dev)[:, None].expand(-1, 64)
    hits[rows, imp_pos] += 30.0
    cleaned, bmask = impairments.blank_impulses(hits)
    cleaned_c, bmask_c = impairments.blank_impulses(hits[:cc].cpu())
    flagged = bmask.sum(dim=-1).cpu().numpy()
    caught = bool(torch.gather(bmask, 1, imp_pos).all())
    same_b = bool(torch.equal(bmask[:cc].cpu(), bmask_c)
                  and torch.equal(cleaned[:cc].cpu(), cleaned_c))
    ms = median_ms(torch, lambda: impairments.blank_impulses(hits))
    report(f"impulse blanker ({c_} x {n_}, 64 impulses a channel)", ms,
           op_count(torch, lambda: impairments.blank_impulses(hits)),
           rate=f", {c_ * n_ / ms / 1e3:.1f} Ms/s",
           extra=f"; every impulse flagged {caught}; flagged a channel {int(flagged.min())}.."
           f"{int(flagged.max())}; mask and output == CPU run {same_b}")
    require(caught and flagged.max() <= 3 * 64 and same_b,
            f"blanker: caught {caught}, flagged {flagged.max()}, == CPU {same_b}")
    del bad, hits, cleaned, bmask, est, st1, st16
    free()

    # --- (c) FAM at Np 256 x P 1024 (BPSK, QPSK); the acceleration search --------
    rng = np.random.default_rng(2)
    nfam = (C18_FAM_P - 1) * C18_FAM_NP // 4 + C18_FAM_NP
    h = root_raised_cosine(8, 8, 0.35)

    def linear(order, fc, noise):
        nsym = nfam // 8 + 8
        data = rng.integers(0, order, nsym)
        sym = (2.0 * data - 1.0) if order == 2 else np.exp(2j * np.pi * (data + 0.5) / order)
        up = np.zeros(nsym * 8, np.complex128)
        up[::8] = sym
        x = 8 * np.convolve(up, h)[:nfam] * tone(nfam, fc)
        return (x + noise * (rng.standard_normal(nfam) + 1j * rng.standard_normal(nfam))
                ).astype(np.complex64)

    # the reference tests' fixtures: clean BPSK and QPSK at 0.12 for the
    # conjugate SCF, BPSK at 0 with noise 0.3 (a third of its power) for the baud line
    bpsk, qpsk, bpsk_n = linear(2, 0.12, 0.0), linear(4, 0.12, 0.0), linear(2, 0.0, 0.3)
    xb = torch.as_tensor(bpsk, device=dev)
    fam = dict(np_=C18_FAM_NP, p=C18_FAM_P)
    rb = cyclo.fam_scf(xb, conj=True, **fam)
    peaks_b = cyclo.detect_cycles(rb)
    axis, pb = cyclo.cycle_profile(rb, normalize=False)
    at2fc = (axis - 0.24).abs() <= 2.0 / 512           # the profile's bins around 2 fc
    prof_b, line_b = float(pb.max()), float(pb[at2fc].max())
    rb_c = cyclo.fam_scf(bpsk, conj=True, device=cpu, **fam)
    scf_err = rel_l2(rb.scf, rb_c.scf)
    peaks_bc = cyclo.detect_cycles(rb_c)
    ms = median_ms(torch, lambda: cyclo.fam_scf(xb, conj=True, **fam))
    ops = op_count(torch, lambda: cyclo.fam_scf(xb, conj=True, **fam))
    del rb, rb_c, pb
    free(reset=False)
    rq = cyclo.fam_scf(torch.as_tensor(qpsk, device=dev), conj=True, **fam)
    peaks_q = cyclo.detect_cycles(rq)
    pq = cyclo.cycle_profile(rq, normalize=False)[1]
    prof_q, line_q = float(pq.max()), float(pq[at2fc].max())
    del rq, pq
    free(reset=False)
    rn = cyclo.fam_scf(torch.as_tensor(bpsk_n, device=dev), conj=False, **fam)
    peaks_n = cyclo.detect_cycles(rn)
    _, prof_ms = host_ms(lambda: cyclo.detect_cycles(rn))
    del rn
    free(reset=False)
    near = lambda pk, a: any(abs(x - a) < 2e-3 for x, _ in pk)           # noqa: E731
    conj_b, conj_q = near(peaks_b, 0.24), near(peaks_q, 0.24)
    baud = near(peaks_n, 0.125) or near(peaks_n, -0.125)
    same_pk = sorted(a for a, _ in peaks_b) == sorted(a for a, _ in peaks_bc)
    report(f"FAM SCF, conjugate (Np {C18_FAM_NP}, P {C18_FAM_P}, {nfam} samples; [Np, Np, P] "
           f"complex64 {C18_FAM_P * C18_FAM_NP ** 2 * 8 / 2 ** 20:.0f} MiB)", ms, ops,
           extra=f"; SCF rel L2 to the CPU run {scf_err:.2e}, cycles == CPU run {same_pk}; "
           f"BPSK 2fc line {conj_b} (QPSK, normalized to its own alpha = 0: {conj_q}); unnormalized "
           f"profile BPSK/QPSK at 2fc {line_b / line_q:.1f}, at their maxima "
           f"{prof_b / prof_q:.1f}; BPSK baud line {baud}; detect_cycles {prof_ms:.1f} ms (host)")
    # the reference's discriminator (tests/unit/test_cyclo.py): the 2fc line in
    # BPSK's conjugate SCF, and BPSK's unnormalized profile over 4x QPSK's, read
    # at 2fc (the reference reads the global maxima at Np 64, P 256; over this
    # grid's 67M points QPSK's largest estimate grows: the maxima are 4.7x apart
    # at Np 128, P 1024 and 4.3x at Np 256). QPSK's own profile, normalized by
    # its small alpha = 0 value, shows peaks anywhere, so its detection list is
    # only printed.
    require(conj_b and line_b > 4 * line_q and baud and scf_err <= 1e-5
            and same_pk, f"FAM: conj BPSK {conj_b}, QPSK {conj_q}, ratio {line_b / line_q}, "
            f"baud {baud}, == CPU {scf_err} {same_pk}")
    del xb
    free()
    na = C18_ACCEL_N
    f0, r0 = 0.123, 100.0 / na ** 2
    t = np.arange(na, dtype=np.float64)
    xa = np.exp(2j * np.pi * (f0 * t + 0.5 * r0 * t * t))
    xa = (xa + np.sqrt(10 ** 1.5 / 2) * (rng.standard_normal(na) + 1j * rng.standard_normal(na))
          ).astype(np.complex64)
    xa_d = torch.as_tensor(xa, device=dev)
    md = C18_ACCEL_RATES / na ** 2
    rates = accel.accel_grid(na, md)
    res, ms = host_ms(lambda: accel.accel_search(xa_d, max_drift=md))
    res_c = accel.accel_search(xa, max_drift=md, device=cpu)
    fr = np.mod(rates[:, None] * (t * t)[None, :] / 2.0, 1.0)
    phasors_equal = bool(np.array_equal(accel.dechirp_phasors(rates, na, dev).cpu().numpy(),
                                        np.exp(-2j * np.pi * fr).astype(np.complex64)))
    del fr
    step = rates[1] - rates[0]
    ok_acc = abs(res.freq - f0) < 1.0 / na and abs(res.drift - r0) < step
    same_acc = (np.unravel_index(np.argmax(res.metric), res.metric.shape)
                == np.unravel_index(np.argmax(res_c.metric), res_c.metric.shape))
    report(f"acceleration search (N {na}, {rates.size} rates, a tone drifting {r0 * na * na:.0f} "
           f"bins at -15 dB)", ms, op_count(torch, lambda: accel.accel_search(xa_d, max_drift=md)),
           clock="host clock, one run, the metric's copy back included",
           extra=f"; freq error {abs(res.freq - f0) * na:.3f} bins, drift error "
           f"{abs(res.drift - r0) / step:.3f} grid steps, ratio {res.ratio:.1f}; dechirp phasors == "
           f"numpy's {phasors_equal}; peak cell == CPU run {same_acc}, metric rel L2 "
           f"{float(np.linalg.norm(res.metric - res_c.metric) / np.linalg.norm(res_c.metric)):.2e}")
    require(ok_acc and phasors_equal and same_acc,
            f"accel: {res.freq} {res.drift}, phasors {phasors_equal}, == CPU {same_acc}")
    del xa_d, res, res_c
    free()

    # --- (d) DPD: ILA on the memory PA, then 32 x 2^20 in 8 blocks -------------
    pa_c = np.array([1.0 + 0.0j, 0.06 - 0.02j, -0.01 + 0.01j, -0.08 + 0.03j, 0.02 + 0.01j,
                     0.0 - 0.005j, 0.012 - 0.004j, -0.004j, 0.001 + 0.0j], np.complex64)
    taps = np.hamming(33) / np.sum(np.hamming(33))

    def drive(x):
        y = fir_full(torch.as_tensor(taps.astype(np.float32), device=x.device), x)[..., 32:]
        return 0.6 * y / torch.sqrt((y.abs() ** 2).mean(dim=-1, keepdim=True))

    def pa(z):
        return dpd.pa_memory_polynomial(pa_c, 5, 3, z)

    def nmse_db(ref_, y):
        return float(10 * torch.log10((y - ref_).abs().pow(2).mean() / ref_.abs().pow(2).mean()))

    xt = drive(cn(gen, (C18_DPD_TRAIN + 32,)))
    (params, g), ms = host_ms(lambda: dpd.dpd_train_ila(pa, xt, 5, 3, iters=3))
    params_c, g_c = dpd.dpd_train_ila(pa, xt.cpu(), 5, 3, iters=3)
    raw = nmse_db(dpd.lin_gain_ls(xt, pa(xt)) * xt, pa(xt))
    lin = nmse_db(g * xt, pa(dpd.dpd_full(params, xt)))
    lin_c = nmse_db(g_c * xt.cpu(), pa(dpd.dpd_full(params_c, xt.cpu())))
    coef_err = rel_l2(params.coeffs, params_c.coeffs)
    report(f"DPD ILA (order 5, memory 3, 3 iterations over {C18_DPD_TRAIN} samples)", ms,
           op_count(torch, lambda: dpd.dpd_train_ila(pa, xt, 5, 3, iters=3)),
           clock="host clock, one run",
           extra=f"; NMSE {raw:.2f} dB raw -> {lin:.2f} dB linearized (CPU run {lin_c:.2f}); "
           f"coefficients rel L2 to the CPU run {coef_err:.2e}")
    # the fit solves the float32 normal equations of a basis whose Gram has a
    # condition number near 2e5: card and CPU round the Gram differently (on an
    # H100 80GB HBM3 at 700 W: coefficients 1.71e-2 apart, NMSE 0.30 dB apart)
    require(lin < raw - 20.0 and abs(lin - lin_c) <= 1.0 and coef_err <= 5e-2,
            f"DPD ILA: {raw} -> {lin} (CPU {lin_c}), coefficients {coef_err}")
    xd = drive(cn(gen, (C18_DPD_CHANNELS, C18_SAMPLES + 32)))
    whole = dpd.dpd_full(params, xd)
    st, pos, blocks_equal = dpd.dpd_init(params, (C18_DPD_CHANNELS,)), 0, True
    for blk in xd.chunk(C18_DPD_BLOCKS, dim=-1):
        st, y = dpd.dpd_apply(params, st, blk)
        blocks_equal &= bool(torch.equal(y, whole[:, pos: pos + y.shape[-1]]))
        pos += y.shape[-1]
    del st, y
    p_cpu = params._replace(coeffs=params.coeffs.cpu())
    cpu_equal = bool(torch.equal(dpd.dpd_full(p_cpu, xd[:cc].cpu()), whole[:cc].cpu()))
    ms = median_ms(torch, lambda: dpd.dpd_full(params, xd))
    report(f"DPD apply ({C18_DPD_CHANNELS} x {C18_SAMPLES} one shot)", ms,
           op_count(torch, lambda: dpd.dpd_full(params, xd)),
           rate=f", {xd.numel() / ms / 1e3:.1f} Ms/s",
           extra=f"; {C18_DPD_BLOCKS} blocks == one shot (torch.equal) {blocks_equal}; == CPU run "
           f"(torch.equal) {cpu_equal}")
    require(blocks_equal, "DPD: blocks differ from the one-shot run on the card")
    require(cpu_equal or rel_l2(whole[:cc], dpd.dpd_full(p_cpu, xd[:cc].cpu())) <= 1e-6,
            "DPD: card differs from the CPU run")
    del xd, whole, xt
    free()

    # --- (e) FRESH: bench/fresh_onchip.py's widths ------------------------------
    rng = np.random.default_rng(0)
    nf, ntr, taps_f = C18_FRESH_N, C18_FRESH_TRAIN, C18_FRESH_TAPS

    def bpsk_sig(nsym, sps, fc):
        hh = root_raised_cosine(sps, 8, 0.9)
        sym = 1.0 - 2.0 * rng.integers(0, 2, nsym).astype(np.float64)
        up = np.zeros(nsym * sps)
        up[::sps] = sym
        bb = np.convolve(up, hh, "same")
        return (bb * np.exp(2j * np.pi * fc * np.arange(bb.size))).astype(np.complex64)

    a = bpsk_sig(nf // 8 + 8, 8, 0.02)[:nf]
    b = bpsk_sig(nf // 5 + 8, 5, 0.035)[:nf]
    x = (a + b + 0.03 * (rng.standard_normal(nf) + 1j * rng.standard_normal(nf))).astype(np.complex64)
    br = fresh.merge_branches(fresh.bpsk_branches(0.02, 1 / 8), fresh.bpsk_branches(0.035, 1 / 5))
    x_d, a_d = torch.as_tensor(x, device=dev), torch.as_tensor(a, device=dev)
    f, ms_design = host_ms(lambda: fresh.fresh_design(x_d[:ntr], a_d[:ntr], br, taps=taps_f))
    fw = fresh.fresh_design(x_d[:ntr], a_d[:ntr], (fresh.FreshBranch(0.0, False),), taps=taps_f)
    fn = fresh_planes.make_fresh_planes(f, stride=128, device=dev)
    nn = ((nf - ntr - fn.hist) // 128) * 128
    seg = x_d[ntr: ntr + nn + fn.hist]
    sr, si = seg.real[None].contiguous(), seg.imag[None].contiguous()
    yr, yi = fn(sr, si, ntr)
    y_pl = torch.complex(yr, yi)[0]
    f_c = f._replace(weights=f.weights.cpu())
    fn_c = fresh_planes.make_fresh_planes(f_c, stride=128, device=cpu)
    yr_c, yi_c = fn_c(sr.cpu(), si.cpu(), ntr)
    y_c = torch.complex(yr_c, yi_c)[0]
    scale = float(y_c.abs().pow(2).mean().sqrt())
    close = bool(torch.allclose(y_pl.cpu(), y_c, atol=5e-3 * scale, rtol=0))
    y_ap = fresh.fresh_apply(f, x_d[ntr:], n0=ntr)[: y_pl.shape[0]]
    y_w = fresh.fresh_apply(fw, x_d[ntr:], n0=ntr)[: y_pl.shape[0]]
    dref = a_d[ntr:][taps_f - 1 - f.delay: taps_f - 1 - f.delay + y_pl.shape[0]]

    def sinr(y):
        return float(10 * torch.log10(dref.abs().pow(2).mean() / (y - dref).abs().pow(2).mean()))

    s_pl, s_ap, s_w = sinr(y_pl), sinr(y_ap), sinr(y_w)
    ms = median_ms(torch, lambda: fn(sr, si, ntr))
    report(f"FRESH planes ({len(br)} branches, {taps_f} taps, {nn} samples)", ms,
           op_count(torch, lambda: fn(sr, si, ntr)), rate=f", {nn / ms / 1e3:.1f} Ms/s",
           extra=f"; design {ms_design:.1f} ms (host clock, {ntr} training samples); == CPU run "
           f"(atol 5e-3 of the RMS) {close}; SINR planes {s_pl:.2f} dB, fresh_apply {s_ap:.2f}, "
           f"Wiener {s_w:.2f}")
    require(close and abs(s_pl - s_ap) < 0.2 and s_pl > s_w + 6.0 and s_pl > 9.0,
            f"FRESH: == CPU {close}, SINR planes {s_pl}, apply {s_ap}, Wiener {s_w}")
    del x_d, a_d, seg, sr, si, yr, yi, y_pl, y_ap, y_w, dref
    free()

    # --- (f) array: 16-element ULA, 2^20 snapshots, 2 sources + a jammer ---------
    e_, ns = C18_ELEMENTS, C18_SNAPSHOTS
    thetas = np.array([-0.35, 0.2, 0.6])
    steer_src = array.ula_steering(e_, 0.5, thetas, device=dev)
    pows = torch.as_tensor([1.0, 1.0, 4.0], device=dev)
    src = cn(gen, (3, ns)) * pows.sqrt()[:, None]
    snaps = (steer_src.T @ src.to(torch.complex64)) + np.float32(np.sqrt(0.1)) * cn(gen, (e_, ns))
    del src

    def covariance(xs):
        stc = array.cov_init(e_, device=xs.device)
        for blk in xs.chunk(C18_COV_BLOCKS, dim=-1):
            stc = array.cov_update(stc, blk)
        return array.cov_finalize(stc, loading=1e-3)

    grid = np.linspace(-1.2, 1.2, C18_ANGLES)
    steer = array.ula_steering(e_, 0.5, grid, device=dev)

    def spectra(r):
        st_ = steer.to(r.device)
        return (array.bartlett_spectrum(r, st_), array.mvdr_spectrum(r, st_),
                array.music_spectrum(r, st_, 3))

    r = covariance(snaps)
    r_c = covariance(snaps.cpu())
    r_err = rel_l2(r, r_c)
    specs = spectra(r)

    def top(spec, k):
        s_ = spec.cpu().numpy()
        loc = np.flatnonzero((s_[1:-1] > s_[:-2]) & (s_[1:-1] > s_[2:])) + 1
        return np.sort(grid[loc[np.argsort(s_[loc])[::-1][:k]]])

    found = [bool(np.allclose(top(sp, 3), thetas, atol=tol))
             for sp, tol in zip(specs, (0.05, 0.01, 0.005))]
    same_pk = [bool(np.array_equal(top(a_, 3), top(b_, 3)))
               for a_, b_ in zip(specs, spectra(r_c))]
    ms_cov = median_ms(torch, lambda: covariance(snaps))
    ms_sp = median_ms(torch, lambda: spectra(r))
    report(f"array covariance ({e_} elements x {ns} snapshots in {C18_COV_BLOCKS} blocks)", ms_cov,
           op_count(torch, lambda: covariance(snaps)), rate=f", {e_ * ns / ms_cov / 1e3:.1f} Ms/s",
           extra=f"; rel L2 to the CPU run {r_err:.2e}")
    report(f"Bartlett, MVDR, MUSIC over {C18_ANGLES} angles", ms_sp,
           op_count(torch, lambda: spectra(r)),
           extra=f"; sources found (Bartlett, MVDR, MUSIC) {found}; peaks == CPU run {same_pk}")
    require(all(found) and all(same_pk) and r_err <= 1e-5,
            f"array: found {found}, == CPU {same_pk}, covariance {r_err}")
    del snaps, r, r_c, specs
    free()
    # MVDR -> beamform -> chains.psk (tests/e2e/test_array_link.py's composition)
    order, decim, sps, center = 4, 2, 4, 0.12
    rxp = psk.make_psk_params(center, decim=decim, sps=sps, order=order, device=dev)
    txp = tx.make_linear_tx(center, rxp.taps, sps=decim * sps, device=dev)
    data = torch.as_tensor(rng.integers(0, order, C18_LINK_SYMS), device=dev)
    _, sig = tx.linear_tx_apply(txp, tx.linear_tx_init(txp), tx.psk_map(psk.diff_encode(data, order),
                                                                         order))
    jam = torch.as_tensor(rng.integers(0, order, C18_LINK_SYMS), device=dev)
    _, jsig = tx.linear_tx_apply(txp, tx.linear_tx_init(txp), tx.psk_map(jam, order))
    a2 = array.ula_steering(e_, 0.5, [-0.4, 0.5], device=dev)
    xl = a2[0][:, None] * sig[None, :] + 2.0 * a2[1][:, None] * jsig[None, :]
    xl = xl + np.float32(0.02 * np.sqrt(2)) * cn(gen, tuple(xl.shape))

    def link(xs):
        w = array.mvdr_weights(array.sample_covariance(xs, loading=1e-3), a2[0].to(xs.device))
        y = array.beamform(w, xs)
        p_ = rxp if xs.is_cuda else psk.make_psk_params(center, decim, sps, order, device="cpu")
        return psk.psk_demod_stream(p_, y, 1 << 15)[0]

    (idx), ms = host_ms(lambda: link(xl))
    one = psk.psk_demod_stream(rxp, xl[0], 1 << 15)[0]
    ser = float(ser_per_channel(data.cpu().numpy()[None], idx.cpu().numpy()[None], order)[0])
    ser1 = float(ser_per_channel(data.cpu().numpy()[None], one.cpu().numpy()[None], order)[0])
    idx_c = link(xl.cpu())
    same_l = bool(torch.equal(idx.cpu(), idx_c))
    report(f"MVDR -> beamform -> chains.psk ({e_} elements, {C18_LINK_SYMS} QPSK symbols, jammer "
           f"+6 dB)", ms, op_count(torch, lambda: link(xl)), clock="host clock, one run",
           extra=f"; SER after settling {ser} (one element alone {ser1:.3f}); symbols == CPU run "
           f"{same_l}")
    require(ser == 0.0 and ser1 > 0.1 and same_l, f"array link: SER {ser}, one element {ser1}, "
            f"== CPU {same_l}")
    del xl, sig, jsig, idx, one
    free()

    # --- (g) MIMO: ZF / MMSE / ML ------------------------------------------------
    rng = np.random.default_rng(3)

    def scene(pts, nt, n, snr_db, cond=1.0):
        idx_ = torch.as_tensor(rng.integers(0, pts.size, (nt, n)), device=dev)
        hh = (rng.standard_normal((nt, nt)) + 1j * rng.standard_normal((nt, nt))) / np.sqrt(2)
        if cond != 1.0:
            u_, sv, vt = np.linalg.svd(hh)
            sv[-1] /= cond
            hh = (u_ * sv) @ vt
        hh = hh.astype(np.complex64)
        yy = torch.as_tensor(hh, device=dev) @ torch.as_tensor(pts.astype(np.complex64), device=dev)[idx_]
        sigma = float(np.sqrt(float(yy.abs().pow(2).mean()) / 10 ** (snr_db / 10) / 2))
        yy = yy + np.float32(sigma * np.sqrt(2)) * cn(gen, tuple(yy.shape))
        return idx_, hh, yy, 10 ** (snr_db / 10)

    def sliced(pts, xhat):
        pt = torch.as_tensor(pts.astype(np.complex64), device=xhat.device)
        return torch.argmin((xhat[..., None] - pt).abs(), dim=-1)

    q16, q4 = qam_constellation(16), np.asarray(psk_points(4))
    lat16, lat4_4, lat16_4 = (mimo.make_ml_lattice(q16, 2), mimo.make_ml_lattice(q4, 4),
                              mimo.make_ml_lattice(q16, 4))
    idx_, hh, yy, snr = scene(q16, 2, C18_MIMO_N, 80.0)
    dets = {"ZF": lambda: sliced(q16, mimo.zf_detect(hh, yy)),
            "MMSE": lambda: sliced(q16, mimo.mmse_detect(hh, yy, snr)),
            "ML": lambda: mimo.ml_detect(hh, yy, *lat16)}
    for name, fn_ in dets.items():
        got = fn_()
        exact = bool(torch.equal(got.to(idx_.dtype), idx_))
        ms = median_ms(torch, fn_)
        report(f"MIMO {name} 2x2 16-QAM, {C18_MIMO_N} vectors at 80 dB", ms, op_count(torch, fn_),
               rate=f", {C18_MIMO_N / ms / 1e3:.1f} M vectors/s", extra=f"; == sent {exact}")
        require(exact, f"MIMO {name} 2x2 16-QAM at 80 dB differs from what was sent")
    ml_c = mimo.ml_detect(hh, yy[:, :4096].cpu(), *lat16)
    same_ml = bool(torch.equal(mimo.ml_detect(hh, yy[:, :4096], *lat16).cpu(), ml_c))
    for name, (pts, nt, n, lat) in (("4x4 QPSK", (q4, 4, C18_MIMO_N, lat4_4)),
                                    ("4x4 16-QAM (65,536 candidates)", (q16, 4, C18_ML16_N, lat16_4))):
        idx_, hh, yy, _ = scene(pts, nt, n, 80.0)
        got = mimo.ml_detect(hh, yy, *lat)
        exact = bool(torch.equal(got.to(idx_.dtype), idx_))
        ms = median_ms(torch, lambda: mimo.ml_detect(hh, yy, *lat))
        got_c = mimo.ml_detect(hh, yy[:, :1024].cpu(), *lat)
        same = bool(torch.equal(got[:, :1024].cpu(), got_c))
        report(f"MIMO ML {name}, {n} vectors at 80 dB", ms,
               op_count(torch, lambda: mimo.ml_detect(hh, yy, *lat)),
               rate=f", {n / ms / 1e3:.3f} M vectors/s",
               extra=f"; [N, C] cross {n * lat[0].shape[0] * 4 / 2 ** 30:.2f} GiB in float32; == sent "
               f"{exact}; first 1,024 == CPU run {same}")
        require(exact and same, f"MIMO ML {name}: == sent {exact}, == CPU {same}")
    idx_, hh, yy, snr = scene(q4, 2, C18_MIMO_N, 14.0, cond=8.0)
    sers = [float((v.to(idx_.dtype) != idx_).float().mean()) for v in (
        mimo.ml_detect(hh, yy, *mimo.make_ml_lattice(q4, 2)),
        sliced(q4, mimo.mmse_detect(hh, yy, snr)), sliced(q4, mimo.zf_detect(hh, yy)))]
    print(f"[18] MIMO 2x2 QPSK, ill-conditioned (cond 8) at 14 dB over {C18_MIMO_N} vectors: SER "
          f"ML {sers[0]:.4f} <= MMSE {sers[1]:.4f} <= ZF {sers[2]:.4f}; ML 2x2 16-QAM first 4,096 "
          f"== CPU run {same_ml} ({card})", flush=True)
    require(sers[0] <= sers[1] <= sers[2] and sers[0] < 0.5 * sers[2] and same_ml,
            f"MIMO ordering {sers}, == CPU {same_ml}")
    del idx_, hh, yy
    free()
    # the 2x2 MIMO-OFDM link (tests/e2e/test_mimo_ofdm.py) over 1,024 data symbols
    spec = ofdm.make_ofdm_spec(64, 16, 52, 16)
    nsym, act = C18_OFDM_SYMS, spec.active.size
    idx_o = rng.integers(0, 16, (2, nsym, act))
    pilot = np.exp(1j * 2 * np.pi * rng.integers(0, 4, act) / 4).astype(np.complex64)
    txs = []
    for t_ in range(2):
        p1 = pilot if t_ == 0 else np.zeros_like(pilot)
        p2 = pilot if t_ == 1 else np.zeros_like(pilot)
        grid_ = np.concatenate([p1[None], p2[None], q16[idx_o[t_]]]).astype(np.complex64)
        txs.append(ofdm.ofdm_modulate(spec, torch.as_tensor(grid_, device=dev)))
    chans = [[np.asarray([1.0, 0.4 - 0.2j, 0.15j], np.complex64),
              np.asarray([0.6j, 0.3, 0.1], np.complex64)],
             [np.asarray([0.7, -0.25j, 0.1], np.complex64),
              np.asarray([0.9 - 0.3j, 0.2, -0.1j], np.complex64)]]
    rxs = [add_noise_snr(rng, sum(multipath_apply(chans[r_][t_], txs[t_]) for t_ in range(2)), 25.0)
           for r_ in range(2)]

    def mimo_ofdm(rx_list):
        fq = torch.stack([ofdm.ofdm_fft(spec, r_) for r_ in rx_list])          # [Nr, 2+S, A]
        pil = torch.as_tensor(pilot, device=fq.device)
        hb = torch.stack([fq[:, 0, :] / pil, fq[:, 1, :] / pil], dim=1)       # [Nr, Nt, A]
        return torch.stack([mimo.ml_detect(hb[:, :, a_], fq[:, 2:, a_], *lat16)
                            for a_ in range(act)])                             # [A, Nt, S]

    got, ms = host_ms(lambda: mimo_ofdm(rxs))
    want = torch.as_tensor(np.stack([idx_o[:, :, a_] for a_ in range(act)]), device=dev)
    ser_o = float((got.to(want.dtype) != want).float().mean())
    same_o = bool(torch.equal(got.cpu(), mimo_ofdm([r_.cpu() for r_ in rxs])))
    report(f"2x2 MIMO-OFDM link (64-point, 52 bins, 16-QAM, {nsym} symbols, 25 dB, per-bin ML)",
           ms, op_count(torch, lambda: mimo_ofdm(rxs)), clock="host clock, one run",
           extra=f"; SER {ser_o:.5f}; == CPU run {same_o}")
    require(ser_o < 0.002 and same_o, f"MIMO-OFDM: SER {ser_o}, == CPU {same_o}")
    del txs, rxs, got
    free()


def phase19(torch, dev) -> None:
    """The fifteen protocol receivers (plain torch, no kernel of ours), each at
    a capture its users record: the capture made with numpy from a seed, put
    on the card, decoded through the receiver's entry point (the FSK chain,
    envelopes, filters and GPS products on the card; framing, codecs and
    candidate searches on the host, from one copy), every message, page,
    group, header, image, time and nav bit sent gated to come back, and a
    prefix of the capture decoded on the card gated equal to the port's own
    CPU run. Each step prints its time (the whole call by the host clock; the
    card's share by CUDA events where it is one call), its rate and the torch
    operations a call dispatches. The receivers take one symbol-timing phase
    for a whole capture (one `fsk_apply`, as in the reference), so the bursts
    of a capture start on one bit grid."""
    from srcdsp_tpu_torch.chains import (acars, adsb, ais, apt, ax25, ble, cw, dcf77, gps,
                                         navtex, pocsag, rds, rtty, same, sstv)
    from srcdsp_tpu_torch.chains.analog import fm_stereo_mpx
    from srcdsp_tpu_torch.chains.fsk import complex_audio, fsk_capture_bits
    from srcdsp_tpu_torch.device import to_host
    from srcdsp_tpu_torch.testing.signals import gmsk_baseband

    cpu = torch.device("cpu")
    card = card_line()

    def report(tag, ms, rate, ops, card_ms=None, extra=""):
        share = "" if card_ms is None else f"; card part {card_ms:.3f} ms (CUDA-event median of 5)"
        print(f"[19] {tag}: {ms:.1f} ms per call (host clock, one warm run){share}, {rate}, {ops} "
              f"torch ops a call{extra} ({card})", flush=True)

    def timed(fn):
        """(result, ms, ops): a first call warms the caches, a second counts
        the torch ops, a third is timed by the host clock."""
        fn()
        ops = op_count(torch, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, ops

    def rel_l2(a, b) -> float:
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        a, b = (a.cdouble(), b.cdouble()) if a.is_complex() else (a.double(), b.double())
        return float(torch.linalg.norm((a - b).reshape(-1)) / torch.linalg.norm(b.reshape(-1)))

    def cnoise(rng, n, sigma):
        return (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)

    def text(rng, n, alphabet="ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 "):
        return "".join(rng.choice(list(alphabet), n))

    # --- AIS: one minute of one channel, 500 type-1 frames in random slots ----------
    t_step = time.perf_counter()
    rng = np.random.default_rng(190)
    slots = rng.choice(C19_AIS_SLOTS, C19_AIS_FRAMES, replace=False)
    sent = {}
    line = rng.integers(0, 2, (C19_AIS_SLOTS, 256)).astype(np.int32)
    for s_ in np.sort(slots):
        pl = bytes([0x04]) + bytes(rng.integers(0, 256, 20).astype(np.uint8))   # type 1
        lv = ais.build_ais_frame(pl)
        line[s_, :lv.size] = lv
        sent[int(s_)] = pl
    x = gmsk_baseband(line.reshape(-1), 8, bt=0.4)
    x = (x * np.exp(2j * np.pi * 0.003 * np.arange(x.size)) + cnoise(rng, x.size, 0.05)
         ).astype(np.complex64)
    x_d = torch.as_tensor(x, device=dev)
    fsk_args = (0.0, 64, 0.45 / 2, 4, 0.25 / 4, 2, 0.95)

    def ais_rx(xx):
        return ais.decode_all_ais_frames(fsk_capture_bits(xx, *fsk_args), max_ends_per_start=8)

    got, ms, ops = timed(lambda: ais_rx(x_d))
    card_ms = median_ms(torch, lambda: fsk_capture_bits(x_d, *fsk_args))
    want = [sent[k] for k in sorted(sent)]
    back = [p for p, _ in got] == want
    pre = C19_AIS_PREFIX
    same_cpu = ais_rx(x_d[:pre]) == ais_rx(torch.as_tensor(x[:pre]))
    report(f"AIS, 1 minute at 9,600 bd ({C19_AIS_SLOTS} slots, {x.size} complex64 samples, "
           f"{x.nbytes / 1e6:.1f} MB), GMSK BT 0.4, CFO 0.003, noise 0.05",
           ms, f"{x.size / ms / 1e3:.1f} Ms/s", ops, card_ms,
           f"; {len(got)} of {C19_AIS_FRAMES} frames back, in order and equal {back}; first "
           f"{pre} samples == CPU run {same_cpu}")
    require(back and same_cpu, f"AIS: {len(got)} frames, equal {back}, == CPU {same_cpu}")
    del x_d

    # --- AX.25 / APRS: 60 s of Bell-202 audio at 13.2 kHz, 30 frames ------------------
    rng = np.random.default_rng(191)
    fs, sps = 13200.0, 11
    fm, fsp = 1200.0 / fs, 2200.0 / fs
    audio = np.zeros(int(C19_AX25_SECONDS * fs), np.float32)
    infos = []
    for k in range(C19_AX25_FRAMES):
        info = f"!{4900 + k:04d}.50N/07201.75W-{text(rng, 24)}"
        infos.append(info.encode())
        a = ax25.afsk_modulate(ax25.build_aprs_frame(f"N{k % 10}CALL", info), sps, fm, fsp)
        s0 = k * (audio.size // C19_AX25_FRAMES) + sps * int(rng.integers(0, 700))
        audio[s0: s0 + a.size] = a
    audio = (audio + 0.08 * rng.standard_normal(audio.size)).astype(np.float32)
    a_d = torch.as_tensor(audio, device=dev)
    got, ms, ops = timed(lambda: ax25.decode_ax25_audio(a_d, sps, fm, fsp))
    card_ms = median_ms(torch, lambda: fsk_capture_bits(complex_audio(a_d), 0.5 * (fm + fsp), 64,
                                                        0.8 * (fsp - fm), sps, 0.5 * (fsp - fm)))
    back = [r["info"] for r in got] == infos
    pre = C19_AX25_PREFIX
    same_cpu = (ax25.decode_ax25_audio(a_d[:pre], sps, fm, fsp)
                == ax25.decode_ax25_audio(audio[:pre], sps, fm, fsp, device=cpu))
    report(f"AX.25/APRS, {C19_AX25_SECONDS} s of Bell-202 audio at 13.2 kHz ({audio.size} samples), "
           f"{C19_AX25_FRAMES} frames, noise 0.08", ms, f"{audio.size / ms / 1e3:.2f} Ms/s",
           ops, card_ms,
           f"; {len(got)} of {C19_AX25_FRAMES} frames back, equal {back}; first {pre} samples "
           f"== CPU run {same_cpu}")
    require(back and same_cpu, f"AX.25: {len(got)} frames, equal {back}, == CPU {same_cpu}")
    del a_d

    # --- BLE: 1,024 advertising packets on channel 37 as 1,024 channels --------------
    rng = np.random.default_rng(192)
    payloads = [bytes(rng.integers(0, 256, 31).astype(np.uint8)) for _ in range(C19_BLE_PACKETS)]
    rows = np.zeros((C19_BLE_PACKETS, C19_BLE_BITS), np.int32)
    for k, pl in enumerate(payloads):
        fr = ble.build_adv_frame(pl, channel=37)
        rows[k] = rng.integers(0, 2, C19_BLE_BITS)
        rows[k, 40: 40 + fr.size] = fr
    x = gmsk_baseband(rows, 8, bt=0.5)
    x = (x * np.exp(2j * np.pi * 0.004 * np.arange(x.shape[-1]))
         + cnoise(rng, x.shape, 0.05)).astype(np.complex64)
    x_d = torch.as_tensor(x, device=dev)
    ble_args = (0.004, 64, 0.45 / 2, 4, 0.25 / 4, 2, 0.95)

    def ble_rx(xx):
        bits = to_host(fsk_capture_bits(xx, *ble_args))
        return [ble.decode_adv_frame(r, channel=37) for r in bits]

    got, ms, ops = timed(lambda: ble_rx(x_d))
    card_ms = median_ms(torch, lambda: fsk_capture_bits(x_d, *ble_args))
    back = [(p, ok) for p, ok, _ in got] == [(p, True) for p in payloads]
    pre = C19_BLE_PREFIX
    same_cpu = ble_rx(x_d[:pre]) == ble_rx(torch.as_tensor(x[:pre]))
    report(f"BLE, {C19_BLE_PACKETS} advertising packets (31-byte payloads, GFSK BT 0.5, CFO 0.004, "
           f"noise 0.05) as {C19_BLE_PACKETS} channels of one FSK call", ms,
           f"{C19_BLE_PACKETS / ms * 1e3:.0f} packets/s", ops,
           card_ms, f"; every payload back with its CRC {back}; first {pre} channels == CPU run "
           f"{same_cpu}")
    require(back and same_cpu, f"BLE: back {back}, == CPU {same_cpu}")
    del x_d

    # --- ADS-B: 1 s at 2 Msps, 1,000 DF17 frames at random arrivals ------------------
    rng = np.random.default_rng(193)
    n = C19_ADSB_SAMPLES
    cell = n // C19_ADSB_FRAMES
    frames, env = [], np.zeros(n, np.float32)
    for k in range(C19_ADSB_FRAMES):
        f = adsb.build_frame(np.concatenate([[1, 0, 0, 0, 1], rng.integers(0, 2, 83)]))
        w = adsb.modulate(f)
        s0 = k * cell + int(rng.integers(0, cell - w.size))
        env[s0: s0 + w.size] = w
        frames.append(f)
    iq_d = torch.as_tensor(env + cnoise(rng, n, 0.1), device=dev)

    def adsb_rx(iq):
        return adsb.decode_all_frames(iq.abs())

    got, ms, ops = timed(lambda: adsb_rx(iq_d))
    back = len(got) == len(frames) and all(np.array_equal(b, f) for (b, _), f in zip(got, frames))
    pre = C19_ADSB_PREFIX
    g1, g2 = adsb_rx(iq_d[:pre]), adsb_rx(iq_d[:pre].cpu())
    same_cpu = [s for _, s in g1] == [s for _, s in g2] and all(
        np.array_equal(a, b) for (a, _), (b, _) in zip(g1, g2))
    report(f"ADS-B, 1 s at 2 Msps ({n} samples, |IQ| on the card), {C19_ADSB_FRAMES} DF17 frames, "
           f"noise 0.1", ms, f"{n / ms / 1e3:.2f} Ms/s", ops,
           None, f"; {len(got)} of {len(frames)} frames back, equal {back}; first {pre} samples "
           f"== CPU run {same_cpu}")
    require(back and same_cpu, f"ADS-B: {len(got)} frames, equal {back}, == CPU {same_cpu}")
    del iq_d

    # --- ACARS: 16 blocks in 30 s at 48 kHz ----------------------------------------
    rng = np.random.default_rng(194)
    fs = 48000.0
    audio = (0.1 * rng.standard_normal(int(C19_ACARS_SECONDS * fs))).astype(np.float32)
    texts = []
    for k in range(C19_ACARS_BLOCKS):
        t_ = text(rng, 80).encode()
        texts.append(t_)
        a = acars.acars_modulate(acars.build_acars_frame(t_, address=f".N{10000 + k}",
                                                         bid=str(k % 10)), 20, fs)
        s0 = k * (audio.size // C19_ACARS_BLOCKS) // 20 * 20 + 20 * int(rng.integers(0, 1000))
        audio[s0: s0 + a.size] += a
    a_d = torch.as_tensor(audio, device=dev)
    got, ms, ops = timed(lambda: acars.decode_acars_audio(a_d, 20, fs))
    card_ms = median_ms(torch, lambda: acars.demod_acars_bits(a_d, 20, fs))
    back = [r["text"].encode() for r in got] == texts and all(r["bcs_ok"] for r in got)
    pre = C19_ACARS_PREFIX
    same_cpu = (acars.decode_acars_audio(a_d[:pre], 20, fs)
                == acars.decode_acars_audio(audio[:pre], 20, fs, device=cpu))
    report(f"ACARS, {C19_ACARS_SECONDS} s at 48 kHz ({audio.size} samples), {C19_ACARS_BLOCKS} blocks, noise 0.1",
           ms, f"{audio.size / ms / 1e3:.2f} Ms/s",
           ops, card_ms,
           f"; {len(got)} of {C19_ACARS_BLOCKS} blocks back, BCS clean and equal {back}; first "
           f"{pre} samples == CPU run {same_cpu}")
    require(back and same_cpu, f"ACARS: {len(got)} blocks, equal {back}, == CPU {same_cpu}")
    del a_d

    # --- POCSAG: 30 s at 1,200 bd, 20 pages ------------------------------------------
    rng = np.random.default_rng(195)
    pages = []
    for k in range(C19_POCSAG_PAGES):
        ric = int(rng.integers(8, 1 << 21))
        words = (pocsag.encode_numeric("".join(rng.choice(list("0123456789 -"), 15)))
                 if k % 2 else pocsag.encode_alpha(text(rng, 30)))
        pages.append((ric, int(rng.integers(0, 4)), words))
    bits = pocsag.encode_transmission(pages)
    sps = 8
    bb = pocsag.pocsag_baseband(bits, sps, 0.05)
    x = np.zeros(C19_POCSAG_SECONDS * 1200 * sps, np.complex64)
    x[9600: 9600 + bb.size] = bb
    x = (x + cnoise(rng, x.size, 0.05)).astype(np.complex64)
    x_d = torch.as_tensor(x, device=dev)

    def pocsag_rx(xx):
        return pocsag.decode_transmission(fsk_capture_bits(xx, 0.0, 64, 0.45, sps, 0.05))

    got, ms, ops = timed(lambda: pocsag_rx(x_d))
    card_ms = median_ms(torch, lambda: fsk_capture_bits(x_d, 0.0, 64, 0.45, sps, 0.05))
    back = [(p["ric"], p["func"], p["data"]) for p in got] == [(r, f, list(w)) for r, f, w in pages]
    pre = C19_POCSAG_PREFIX
    same_cpu = pocsag_rx(x_d[:pre]) == pocsag_rx(torch.as_tensor(x[:pre]))
    report(f"POCSAG, {C19_POCSAG_SECONDS} s at 1,200 bd ({x.size} samples, sps 8), {C19_POCSAG_PAGES} pages "
           f"({bits.size} air bits)", ms, f"{x.size / ms / 1e3:.2f} Ms/s",
           ops, card_ms,
           f"; {len(got)} of {C19_POCSAG_PAGES} pages back, equal {back}; first {pre} samples == "
           f"CPU run {same_cpu}")
    require(back and same_cpu, f"POCSAG: {len(got)} pages, equal {back}, == CPU {same_cpu}")
    del x_d

    # --- RDS: 10 s of MPX at 228 kHz -------------------------------------------------
    rng = np.random.default_rng(196)
    fs = 228000.0
    fp = 19000.0 / fs
    n = C19_RDS_SAMPLES
    ngroups = n // (2 * 96 * 104)
    groups = [[int(v) for v in rng.integers(0, 1 << 16, 4)] for _ in range(ngroups)]
    gbits = np.concatenate([rds.rds_encode_group(g, "A" if k % 3 else "B")
                            for k, g in enumerate(groups)])
    t = np.arange(n)
    mpx = fm_stereo_mpx(0.4 * np.sin(2 * np.pi * 1100.0 / fs * t),
                        0.4 * np.sin(2 * np.pi * 2700.0 / fs * t), fp)
    mpx = rds.rds_inject_mpx(mpx, gbits, fp, 96, level=0.06)
    mpx = (mpx + 0.01 * rng.standard_normal(n)).astype(np.float32)
    m_d = torch.as_tensor(mpx, device=dev)

    def rds_rx(mm, **kw):
        return rds.rds_sync_decode(rds.rds_demod_mpx(mm, fp, 96, **kw))

    got, ms, ops = timed(lambda: rds_rx(m_d))
    card_ms = median_ms(torch, lambda: rds.rds_demod_mpx(m_d, fp, 96))
    words = [g["words"] for g in got]
    k0 = groups.index(words[0]) if words and words[0] in groups else -1
    back = k0 in (0, 1) and words == groups[k0: k0 + len(words)] and len(words) >= ngroups - 2
    pre = C19_RDS_PREFIX
    same_cpu = rds_rx(m_d[:pre]) == rds_rx(mpx[:pre], device=cpu)
    report(f"RDS, 10 s of MPX at 228 kHz ({n} samples, stereo + RDS, noise 0.01)", ms,
           f"{n / ms / 1e3:.2f} Ms/s", ops, card_ms,
           f"; {len(got)} of {ngroups} groups back, consecutive and equal from group {k0} {back}; "
           f"first {pre} samples == CPU run {same_cpu}")
    require(back and same_cpu, f"RDS: {len(got)} groups from {k0}, equal {back}, == CPU {same_cpu}")
    del m_d

    # --- GPS: cold start over 32 PRNs x 41 Dopplers x 10 ms; a 6 s subframe tracked ---
    rng = np.random.default_rng(197)
    sps, n = 2, 2046
    fs = 1.023e6 * sps
    dop_grid = np.arange(-20, 21) * 500.0 / fs
    sats = {3: (7, 1234, 0.125), 11: (-12, 88, 0.1), 19: (3, 2001, 0.1), 27: (15, 640, 0.09)}
    nb_t = C19_GPS_TRACK_MS
    code_dop = sats[3][0] * 500.0 / 1575.42e6 * n
    nav = np.concatenate([gps.NAV_PREAMBLE, rng.integers(0, 2, nb_t // 20 - 8)]).astype(np.int32)
    x = cnoise(rng, nb_t * n, np.sqrt(0.5))
    blk = np.arange(nb_t)
    for prn, (kd, p0, amp) in sats.items():
        cs = gps.sample_ca(gps.ca_code(prn), sps)
        drift = np.round(blk * kd * 500.0 / 1575.42e6 * n).astype(int)
        chips = np.stack([np.roll(cs, p0 + int(d)) for d in drift]) if prn == 3 else \
            np.tile(np.roll(cs, p0), (nb_t, 1))
        sign = (1.0 - 2.0 * np.repeat(nav, 20)[:nb_t]) if prn == 3 else 1.0
        ph = 2 * np.pi * np.mod(kd * 500.0 / fs * np.arange(nb_t * n, dtype=np.float64), 1.0)
        x += (amp * (chips * np.asarray(sign)[..., None]).reshape(-1)
              * np.exp(1j * (ph + prn))).astype(np.complex64)
    x_d = torch.as_tensor(x, device=dev)
    acq_x = x_d[: C19_GPS_ACQ_MS * n]
    acqs = [gps.make_gps_acq(prn, sps, device=dev) for prn in range(1, 33)]

    def search():
        return [gps.acquire_ca(a, acq_x, dop_grid) for a in acqs]

    res, ms, ops = timed(search)
    card_ms = median_ms(torch, search)
    cells = {a.prn: (int(r["d_idx"]), int(r["p_idx"]), float(r["ratio"])) for a, r in zip(acqs, res)}
    found = all(cells[p][:2] == (kd + 20, p0) for p, (kd, p0, _) in sats.items())
    lo = min(cells[p][2] for p in sats)
    hi = max(c[2] for p, c in cells.items() if p not in sats)
    res_c = [gps.acquire_ca(gps.make_gps_acq(p, sps, device=cpu), x[: C19_GPS_ACQ_MS * n], dop_grid)
             for p in C19_GPS_CPU_PRNS]
    same_cpu = all((int(rc["d_idx"]), int(rc["p_idx"])) == cells[p][:2]
                   and rel_l2(res[p - 1]["metric"], rc["metric"]) <= 1e-5
                   for p, rc in zip(C19_GPS_CPU_PRNS, res_c))
    flop = 32 * 2 * 2 * len(dop_grid) * C19_GPS_ACQ_MS * n * n
    report(f"GPS cold search, 32 PRNs x {len(dop_grid)} Dopplers x {C19_GPS_ACQ_MS} ms at sps 2 "
           f"({flop / 1e9:.1f} GFLOP)", ms, f"{flop / card_ms / 1e9:.2f} TFLOP/s on the card",
           ops, card_ms,
           f"; the {len(sats)} satellites at their cells {found} (ratio >= {lo:.1f}, others <= "
           f"{hi:.1f}); PRNs {C19_GPS_CPU_PRNS} == CPU run {same_cpu}")
    require(found and lo > 2 * hi and same_cpu, f"GPS search: {cells}, == CPU {same_cpu}")
    a3 = acqs[2]

    def track():
        fine = gps.fine_acquire(a3, res[2])
        return gps.track_ca(a3, x_d, res[2], fine, code_doppler=code_dop)

    trk, ms, ops = timed(track)
    card_ms = median_ms(torch, track)
    b = to_host(trk["bits"])
    pol_ok = np.array_equal(b, nav) or np.array_equal(1 - b, nav)
    hits = gps.nav_preamble_detect(trk["bits"])
    pre = C19_GPS_TRACK_PREFIX
    res_c3 = gps.acquire_ca(gps.make_gps_acq(3, sps, device=cpu), x[: C19_GPS_ACQ_MS * n], dop_grid)
    trk_c = gps.track_ca(gps.make_gps_acq(3, sps, device=cpu), x[: pre * n], res_c3,
                         gps.fine_acquire(a3, res_c3), code_doppler=code_dop)
    trk_p = gps.track_ca(a3, x_d[: pre * n], res[2], gps.fine_acquire(a3, res[2]),
                         code_doppler=code_dop)
    same_cpu = (torch.equal(trk_p["bits"].cpu(), trk_c["bits"])
                and rel_l2(trk_p["prompt"], trk_c["prompt"]) <= 1e-5)
    report(f"GPS fine acquisition + tracking of PRN 3, one 6 s subframe ({nb_t} blocks, "
           f"{x.nbytes / 1e6:.0f} MB, code Doppler {code_dop:.5f} samples a block)", ms,
           f"{x.size / ms / 1e3:.1f} Ms/s", ops, card_ms,
           f"; {b.size} nav bits == sent (either polarity) {pol_ok}, bit phase "
           f"{trk['bit_phase']}, TLM preamble at {hits[:2]}; C/N0 {float(trk['cn0_db_hz']):.1f} "
           f"dB-Hz; first {pre} blocks == CPU run {same_cpu}")
    require(pol_ok and hits and hits[0][0] == 0 and same_cpu,
            f"GPS track: bits {pol_ok}, preamble {hits[:2]}, == CPU {same_cpu}")
    del x_d, acq_x, acqs, res, trk

    # --- NAVTEX (5 minutes), RTTY (60 s), SAME (three headers) -----------------------
    rng = np.random.default_rng(198)
    body = text(rng, C19_NAVTEX_CHARS, "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ")
    msg = navtex.navtex_build("E", "A", "42", body)
    x = navtex.navtex_modulate(navtex.sitor_b_encode(navtex._text_codes(msg)), 20, 0.05)
    x = np.concatenate([x, np.zeros(40 * 20, np.complex64)])
    x = (x + cnoise(rng, x.size, 0.1)).astype(np.complex64)
    x_d = torch.as_tensor(x, device=dev)
    got, ms, ops = timed(lambda: navtex.decode_navtex_audio(x_d, 20, 0.05))
    parsed = navtex.navtex_parse(got[0])
    inside = got[0][: got[0].find("NNNN")].count("*")
    back = parsed is not None and parsed["body"] == body and inside == 0
    pre = C19_NAVTEX_PREFIX
    same_cpu = (navtex.decode_navtex_audio(x_d[:pre], 20, 0.05)
                == navtex.decode_navtex_audio(x[:pre], 20, 0.05, device=cpu))
    report(f"NAVTEX, {x.size / 2000 / 60:.1f} minutes at 100 Bd (sps 20, {x.size} samples, "
           f"{len(msg)} characters)", ms, f"{x.size / ms / 1e3:.3f} Ms/s",
           ops, None,
           f"; message back with no erasure inside it {back} ({got[1]} in the noise after NNNN); "
           f"first {pre} samples == CPU run {same_cpu}")
    require(back and same_cpu, f"NAVTEX: back {back}, == CPU {same_cpu}")

    sent_t = text(rng, C19_RTTY_CHARS, "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,?")
    lv = rtty.uart_frame(rtty.ita2_encode(sent_t))
    dev_r = 85.0 / 2000.0
    x = np.concatenate([rtty.rtty_modulate(lv, 22, dev_r), np.ones(400, np.complex64)])
    x = (x + cnoise(rng, x.size, 0.1)).astype(np.complex64)
    x_d = torch.as_tensor(x, device=dev)
    got, ms, ops = timed(lambda: rtty.decode_rtty(x_d, 22, dev_r))
    back = sent_t in got
    pre = C19_RTTY_PREFIX
    same_cpu = (rtty.decode_rtty(x_d[:pre], 22, dev_r)
                == rtty.decode_rtty(x[:pre], 22, dev_r, device=cpu))
    report(f"RTTY, {x.size / 2000:.1f} s at 45.45 Bd, 170 Hz shift (fs 2 kHz, {len(sent_t)} "
           f"characters)", ms, f"{x.size / ms / 1e3:.3f} Ms/s",
           ops, None,
           f"; text back {back}; first {pre} samples == CPU run {same_cpu}")
    require(back and same_cpu, f"RTTY: back {back}, == CPU {same_cpu}")

    fs = 12500.0
    hdrs = [same.same_build("WXR", ev, ["039173", "039051"], "0030", "1051700", "KCLE/NWS")
            for ev in ("TOR", "SVR", "FFW")]
    gap = np.zeros(24 * 260, np.float32)          # about 0.5 s, whole bits
    parts = [gap]
    for h in hdrs:
        for _ in range(3):
            parts += [same.same_modulate(same.same_bytes_bits(h.encode()), fs), gap]
    for _ in range(3):
        parts += [same.same_modulate(same.same_bytes_bits(b"NNNN"), fs), gap]
    audio = np.concatenate(parts)
    audio = (audio + 0.05 * rng.standard_normal(audio.size)).astype(np.float32)
    a_d = torch.as_tensor(audio, device=dev)
    got, ms, ops = timed(lambda: same.decode_same_audio(a_d, fs))
    heads = [same.same_parse(t_) for t_ in got if t_.startswith("ZCZC")]
    back = heads == [same.same_parse(h) for h in hdrs for _ in range(3)] and sum(
        t_.startswith("NNNN") for t_ in got) == 3
    same_cpu = got == same.decode_same_audio(audio, fs, device=cpu)
    report(f"SAME, three headers x 3 bursts + EOM ({audio.size / fs:.1f} s at 12.5 kHz)", ms,
           f"{audio.size / ms / 1e3:.3f} Ms/s",
           ops, None,
           f"; 9 headers and 3 EOMs back {back}; the whole capture == CPU run {same_cpu}")
    require(back and same_cpu, f"SAME: back {back}, == CPU {same_cpu}")
    del x_d, a_d

    # --- APT: one 12-minute pass, 1,440 lines at 20,800 Hz ----------------------------
    rng = np.random.default_rng(199)
    p = apt.make_apt_params(device=dev)
    img = rng.standard_normal((C19_APT_LINES, 909))
    img = np.apply_along_axis(lambda r: np.convolve(r, np.ones(9) / 9.0, "same"), 1, img)
    img = ((img - img.min()) / (img.max() - img.min())).astype(np.float32)
    mpx = apt.apt_modulate(p, apt.apt_build_lines(img))
    cut = 700 * int(p.sps)
    mpx = np.concatenate([mpx[cut:], mpx[:cut]])
    mpx = (mpx + 0.005 * rng.standard_normal(mpx.size)).astype(np.float32)
    m_d = torch.as_tensor(mpx, device=dev)
    dec, ms, ops = timed(lambda: apt.apt_decode_mpx(p, m_d))
    card_ms = median_ms(torch, lambda: apt.apt_words(p, apt.apt_envelope(p, m_d)))
    va = dec["video_a"][1:-1]
    ref = np.roll(img, -1, axis=0)[1: va.shape[0] + 1]
    psnr = 10 * np.log10(float(np.var(img)) / float(np.mean((va - ref) ** 2)))
    back = dec["offset"] == 2080 - 700 and psnr >= 20.0
    pre = C19_APT_PREFIX
    pc = apt.make_apt_params(device=cpu)
    env_rel = rel_l2(apt.apt_envelope(p, m_d[:pre]), apt.apt_envelope(pc, mpx[:pre]))
    same_cpu = env_rel <= 1e-5 and apt.apt_decode_mpx(p, m_d[:pre])["offset"] == \
        apt.apt_decode_mpx(pc, mpx[:pre])["offset"]
    report(f"APT, one 12-minute pass ({C19_APT_LINES} lines, {mpx.size} samples at 20,800 Hz)", ms,
           f"{mpx.size / ms / 1e3:.2f} Ms/s", ops,
           card_ms, f"; line offset {dec['offset']}, video A {psnr:.1f} dB against the image "
           f"({back}); first {pre} samples: envelope rel L2 {env_rel:.2e} to the CPU run, offset "
           f"equal ({same_cpu})")
    require(back and same_cpu, f"APT: offset {dec['offset']}, {psnr} dB, == CPU {same_cpu}")
    del m_d

    # --- SSTV: a full Martin M1 image at 11,025 Hz --------------------------------------
    rng = np.random.default_rng(200)
    p = sstv.make_sstv_params(height=C19_SSTV_LINES, device=dev)
    img = rng.standard_normal((C19_SSTV_LINES, 320, 3))
    for c_ in range(3):
        img[:, :, c_] = np.apply_along_axis(lambda r: np.convolve(r, np.ones(15) / 15.0, "same"),
                                            1, img[:, :, c_])
    img = ((img - img.min()) / (img.max() - img.min())).astype(np.float32)
    audio = sstv.sstv_modulate(p, img)
    audio = (audio + 0.05 * rng.standard_normal(audio.size)).astype(np.float32)
    a_d = torch.as_tensor(audio, device=dev)
    dec, ms, ops = timed(lambda: sstv.sstv_decode(p, a_d))
    card_ms = median_ms(torch, lambda: sstv.sstv_inst_freq(p, a_d))
    err = (dec["image"][:, 2:-2, :] - img[:, 2:-2, :]) ** 2
    snr = 10 * np.log10(float(np.var(img)) / float(err.mean()))
    back = dec["ok"] and dec["vis"] == sstv.MARTIN_M1_VIS and snr > 12.0
    pre = C19_SSTV_PREFIX
    pc = sstv.make_sstv_params(height=C19_SSTV_CPU_LINES, device=cpu)
    pg = sstv.make_sstv_params(height=C19_SSTV_CPU_LINES, device=dev)
    f_rel = rel_l2(sstv.sstv_inst_freq(pg, a_d[:pre]), sstv.sstv_inst_freq(pc, audio[:pre]))
    d1, d2 = sstv.sstv_decode(pg, a_d[:pre]), sstv.sstv_decode(pc, audio[:pre])
    same_cpu = f_rel <= 1e-5 and d1["vis"] == d2["vis"] and float(
        np.abs(d1["image"] - d2["image"]).max()) <= 1e-3
    report(f"SSTV, a Martin M1 image (320 x {C19_SSTV_LINES}, {audio.size} samples at 11,025 Hz, noise 0.05: "
           f"23 dB audio SNR)", ms, f"{audio.size / ms / 1e3:.2f} Ms/s",
           ops, card_ms,
           f"; VIS {dec['vis']}, image {snr:.1f} dB against the sent one ({back}); first {pre} "
           f"samples ({C19_SSTV_CPU_LINES} lines): inst. frequency rel L2 {f_rel:.2e} to the CPU "
           f"run, pixels within 1e-3 ({same_cpu})")
    require(back and same_cpu, f"SSTV: vis {dec['vis']}, {snr} dB, == CPU {same_cpu}")
    del a_d

    # --- CW (60 s at 20 wpm) and DCF77 (60 minutes at 1 kHz) -----------------------------
    rng = np.random.default_rng(201)
    words_cw = " ".join(text(rng, 5, "ABCDEFGHIJKLMNOPQRSTUVWXYZ") for _ in range(C19_CW_WORDS))
    audio = cw.cw_modulate(words_cw, 20.0, 8000.0, 700.0)
    audio = np.concatenate([np.zeros(4000, np.float32), audio, np.zeros(4000, np.float32)])
    audio = (audio + 0.08 * rng.standard_normal(audio.size)).astype(np.float32)
    a_d = torch.as_tensor(audio, device=dev)
    got, ms, ops = timed(lambda: cw.decode_cw(a_d, 8000.0))
    back = got["text"] == words_cw
    same_cpu = got == cw.decode_cw(audio, 8000.0)
    report(f"CW, {audio.size / 8000:.1f} s at 20 wpm (8 kHz, {C19_CW_WORDS} words)", ms,
           f"{audio.size / ms / 1e3:.3f} Ms/s", ops,
           None, f"; text back {back} at {got['wpm']:.1f} wpm, {got['tone_hz']:.1f} Hz; == CPU run "
           f"{same_cpu}")
    require(back and same_cpu, f"CW: {got['text'][:40]!r}, == CPU {same_cpu}")

    times = [dcf77.Dcf77Time(m % 60, 10 + m // 60, 17, 5, 10, 26, True)
             for m in range(C19_DCF77_MINUTES)]
    env = dcf77.dcf77_modulate([dcf77.dcf77_encode_minute(t_) for t_ in times])
    env = np.concatenate([np.full(1234, 1.0, np.float32), env, np.full(800, 1.0, np.float32)])
    env = (env + 0.05 * rng.standard_normal(env.size)).astype(np.float32)
    e_d = torch.as_tensor(env, device=dev)
    got, ms, ops = timed(lambda: dcf77.dcf77_decode(e_d))
    back = got == times
    same_cpu = got == dcf77.dcf77_decode(env)
    report(f"DCF77, {C19_DCF77_MINUTES} minutes at 1 kHz ({env.size} samples)", ms,
           f"{env.size / ms / 1e3:.3f} Ms/s", ops, None,
           f"; {len(got)} of {C19_DCF77_MINUTES} minutes back, equal {back}; == CPU run {same_cpu}")
    require(back and same_cpu, f"DCF77: {len(got)} minutes, equal {back}, == CPU {same_cpu}")
    print(f"[19] phase 19 steps took {time.perf_counter() - t_step:.1f} s", flush=True)


def protocol_files(work: Path, rng: np.random.Generator) -> dict:
    """The fourteen decoder subcommands' captures, made with the port's numpy
    generators (phase 19's and the reference CLI tests', a few messages
    each), written under `work`: name -> (CLI argv with None for the output,
    check(output bytes) -> every message sent came back)."""
    from srcdsp_tpu_torch.chains import (acars, adsb, ais, apt, ax25, css, cw, gps, navtex,
                                         pocsag, rds, rtty, same, sstv)
    from srcdsp_tpu_torch.chains.analog import fm_modulate, fm_stereo_mpx
    from srcdsp_tpu_torch.io.capture import CaptureMeta, write_capture
    from srcdsp_tpu_torch.testing.signals import gmsk_baseband, tone

    def noise(n, sigma):
        return (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)

    def cf32(name, x):
        write_capture(str(work / name), np.asarray(x, np.complex64), CaptureMeta(fmt="cf32"))
        return work / name

    def f32(name, a):
        np.asarray(a, np.float32).tofile(work / name)
        return work / name

    def jl(raw):
        return [json.loads(line) for line in raw.decode().splitlines()]

    cases = {}
    # ADS-B: 8 DF17 frames at 2 Msps (sps_half 1)
    frames = [adsb.build_frame(np.concatenate([[1, 0, 0, 0, 1], rng.integers(0, 2, 83)]))
              for _ in range(8)]
    x = noise(80000, 0.06)
    for k, f in enumerate(frames):
        w = adsb.modulate(f)
        x[k * 10000 + 500: k * 10000 + 500 + w.size] += w.astype(np.complex64)
    want = [np.packbits(f.reshape(-1, 8)).tobytes() for f in frames]
    cases["adsb"] = (["adsb", cf32("adsb.cf32", x), None],
                     lambda raw, w=want: [bytes.fromhex(r["hex"]) for r in jl(raw)] == w)
    # AIS: 6 frames of GMSK at 9,600 bd, 8 samples a bit, CFO
    pls = [bytes([0x04]) + bytes(rng.integers(0, 256, 20).astype(np.uint8)) for _ in range(6)]
    line = np.concatenate([np.concatenate([rng.integers(0, 2, 64), ais.build_ais_frame(p)])
                           for p in pls] + [rng.integers(0, 2, 64)]).astype(np.int32)
    x = gmsk_baseband(line, 8, bt=0.4)
    x = (x * tone(x.size, 0.002) + noise(x.size, 0.04)).astype(np.complex64)
    cases["ais"] = (["ais", cf32("ais.cf32", x), None, "--decim", 2, "--sps", 4],
                    lambda raw, w=pls: [bytes.fromhex(r["hex"]) for r in jl(raw)] == w)
    # RDS: 8 groups under a stereo program at 228 kHz
    fs, sps_half, f_pilot = 228000.0, 96, 19000.0 / 228000.0
    words = [rng.integers(0, 1 << 16, 4).tolist() for _ in range(8)]
    bits = np.concatenate([rds.rds_encode_group(w, "A") for w in words]).astype(np.int32)
    t = np.arange(bits.size * 2 * sps_half + 8000)
    mpx = fm_stereo_mpx(0.3 * np.sin(2 * np.pi * 1000 / fs * t),
                        0.3 * np.sin(2 * np.pi * 2500 / fs * t), f_pilot)
    mpx = rds.rds_inject_mpx(mpx, bits, f_pilot, sps_half, level=0.07)
    iq = fm_modulate(mpx.astype(np.float32), 0.3, device="cpu").numpy()
    cases["rds"] = (["rds", cf32("rds.cf32", iq), None, "--sps-half", sps_half, "--pilot",
                     f_pilot, "--dev", 0.3],
                    lambda raw, w=words: [[int(v, 16) for v in r["words"]]
                                          for r in jl(raw)][:len(w)] == w)
    # GPS: PRN 9 under noise, 6 ms at 2 samples a chip; all 32 PRNs searched
    n1 = 1023 * 2
    x = np.tile(np.roll(gps.sample_ca(gps.ca_code(9), 2), 404), 6)
    x = x * np.exp(2j * np.pi * 4.0 / (2 * n1) * np.arange(x.size))
    x = (x + np.sqrt(50.0) * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
         ).astype(np.complex64)
    cases["gps"] = (["gps", cf32("gps.cf32", x), None, "--sps", 2],
                    lambda raw: [r["prn"] for r in jl(raw)] == [9]
                    and abs(jl(raw)[0]["code_phase_samples"] - 404) < 1.0)
    # POCSAG: 3 numeric pages
    pages = [(0x2A2A1 + 7 * k, 0, pocsag.encode_numeric(f"{31337 + k}")) for k in range(3)]
    pb = pocsag.encode_transmission(pages, preamble_bits=64)
    x = np.concatenate([np.zeros(500, np.complex64),
                        pocsag.pocsag_baseband(pb, 8, 0.05).astype(np.complex64),
                        np.zeros(1024, np.complex64)])
    cases["pocsag"] = (["pocsag", cf32("pocsag.cf32", x + noise(x.size, 0.04)), None, "--sps", 8,
                        "--dev", 0.05, "--decim", 1],
                       lambda raw: [r["numeric"] for r in jl(raw)] == [f"{31337 + k}"
                                                                        for k in range(3)])
    # AX.25 / APRS: 4 frames of Bell-202 audio at 13.2 kHz
    infos = [f"!{4900 + k:04d}.50N/07201.75W-CARD{k}" for k in range(4)]
    audio = np.concatenate([np.concatenate([np.zeros(700, np.float32), ax25.afsk_modulate(
        ax25.build_aprs_frame(f"N{k}CALL", infos[k]), 11, 1200 / 13200, 2200 / 13200)])
        for k in range(4)] + [np.zeros(700, np.float32)])
    cases["ax25"] = (["ax25", f32("ax25.f32", audio), None, "--fs", 13200],
                     lambda raw: [r["info"] for r in jl(raw)] == infos)
    # CSS: 3 bursts at sf 7
    pcss = css.make_css_params(sf=7, cr=4)
    pays = [bytes(rng.integers(0, 256, 16).astype(np.uint8)) for _ in range(3)]
    x = np.concatenate([np.concatenate([np.zeros(300, np.complex64), css.css_transmit(pcss, p)])
                        for p in pays] + [np.zeros(300, np.complex64)])
    cases["css"] = (["css", cf32("css.cf32", x + noise(x.size, 0.05)), None, "--css-sf", 7,
                     "--css-cr", 4, "--css-len", 16],
                    lambda raw, w=pays: [bytes.fromhex(r["hex"]) for r in jl(raw)] == w)
    # APT: 12 lines of a smooth image, FM at dev 0.25
    pa = apt.make_apt_params(device="cpu")
    img = rng.standard_normal((12, 909))
    img = np.apply_along_axis(lambda r: np.convolve(r, np.ones(9) / 9.0, "same"), 1, img)
    img = ((img - img.min()) / (img.max() - img.min())).astype(np.float32)
    iq = fm_modulate((apt.apt_modulate(pa, apt.apt_build_lines(img)) * 0.9).astype(np.float32),
                     0.25, device="cpu").numpy()

    def apt_ok(raw, img=img):
        head = b"P5\n2080 12\n255\n"
        pix = np.frombuffer(raw[len(head):], np.uint8).reshape(12, 2080) / 255.0
        a0, aw = apt.apt_line_layout()["video_a"]
        got = pix[1:-1, a0: a0 + aw]
        return raw.startswith(head) and float(np.mean((img[1:1 + got.shape[0]] - got) ** 2)) < (
            float(np.var(img)) / 20.0)

    cases["apt"] = (["apt", cf32("apt.cf32", iq), None, "--dev", 0.25 * 0.9], apt_ok)
    # ACARS: 3 blocks, AM at complex baseband
    texts = [f"CARD BLOCK {k}".encode() for k in range(3)]
    a = np.concatenate([np.concatenate([np.zeros(900, np.float32), acars.acars_modulate(
        acars.build_acars_frame(t_, address=f".CARD0{k}", label="SA"), 20, 48000.0)])
        for k, t_ in enumerate(texts)] + [np.zeros(900, np.float32)])
    iq = ((1.0 + 0.8 * a) * np.exp(1j * 2 * np.pi * 0.003 * np.arange(a.size))
          ).astype(np.complex64) + noise(a.size, 0.01)
    cases["acars"] = (["acars", cf32("acars.cf32", iq), None],
                      lambda raw: [r["text"].encode() for r in jl(raw)] == texts
                      and all(r["bcs_ok"] for r in jl(raw)))
    # SSTV: Martin M1, 16 lines of a smooth image, raw audio
    ps = sstv.make_sstv_params(height=16, device="cpu")
    simg = np.repeat(rng.random((16, 40, 3)), 8, axis=1).astype(np.float32)

    def sstv_ok(raw, simg=simg):
        head = b"P6\n320 16\n255\n"
        pix = np.frombuffer(raw[len(head):], np.uint8).reshape(16, 320, 3) / 255.0
        err = float(np.mean((pix[:, 2:-2] - simg[:, 2:-2]) ** 2))
        return raw.startswith(head) and 10 * np.log10(float(np.var(simg)) / err) > 14.0

    cases["sstv"] = (["sstv", f32("sstv.f32", sstv.sstv_modulate(ps, simg)), None, "--mpx",
                      "--lines", 16], sstv_ok)
    # NAVTEX, RTTY, SAME, CW
    msg = navtex.navtex_build("K", "B", "12", "NO WARNINGS FOR THE CARD")
    x = navtex.navtex_modulate(navtex.sitor_b_encode(navtex._text_codes(msg)), 20, 0.05)
    cases["navtex"] = (["navtex", cf32("navtex.cf32", np.concatenate(
        [x, np.zeros(800, np.complex64)])), None, "--sps", 20, "--dev", 0.05],
        lambda raw: json.loads(raw)["ok"] and "NO WARNINGS FOR THE CARD" in json.loads(raw)["body"])
    text = "RYRYRY DE CARD TEST 73"
    x = rtty.rtty_modulate(rtty.uart_frame(rtty.ita2_encode(text)), sps_half=10, dev=0.04)
    cases["rtty"] = (["rtty", cf32("rtty.cf32", np.concatenate([x, np.ones(100, np.complex64)])),
                      None, "--sps", 10, "--dev", 0.04], lambda raw: text in raw.decode())
    hdrs = [same.same_build("EAS", ev, "099999", "0015", "2331200", "CARDTEST")
            for ev in ("RWT", "TOR")]
    audio = np.concatenate([np.concatenate([np.zeros(500, np.float32), same.same_modulate(
        same.same_bytes_bits(h_.encode()), 12500.0)]) for h_ in hdrs]
        + [np.zeros(500, np.float32)])
    cases["same"] = (["same", f32("same.f32", audio), None, "--mpx"],
                     lambda raw: [r.get("event") for r in jl(raw)] == ["RWT", "TOR"])
    x = cw.cw_modulate("CQ CQ DE CARD", 20.0, 8000.0, 700.0)
    cases["cw"] = (["cw", f32("cw.f32", np.concatenate([np.zeros(1000, np.float32), x,
                                                         np.zeros(1000, np.float32)])), None,
                    "--mpx"], lambda raw: json.loads(raw)["text"] == "CQ CQ DE CARD")
    return cases


def fault_injection(torch, dev, work: Path) -> None:
    """bench/fault_injection.py on shards of one card: the time-sharded halo
    FIR then the channelizer stream over C20_FAULT_SHARDS shards, 16 channels
    in 6 buffers, a checkpoint after each; every live tensor dropped after
    buffer 3, the state restored into a fresh mesh, the stream continued;
    the result bit-equal to the unbroken single-device run."""
    from srcdsp_tpu_torch import checkpoint
    from srcdsp_tpu_torch.chains.channelizer import channelize_full, design_prototype, pad_prototype
    from srcdsp_tpu_torch.dist import mesh as dmesh
    from srcdsp_tpu_torch.dist.channelize import channelize_time_sharded_stream
    from srcdsp_tpu_torch.dist.halo import fir_time_sharded_stream
    from srcdsp_tpu_torch.ops.fir import fir_full
    from srcdsp_tpu_torch.ops.window import lowpass
    from srcdsp_tpu_torch.testing.signals import complex_awgn

    t0 = time.perf_counter()
    m, nbuf, shards = 16, 6, C20_FAULT_SHARDS
    pre = lowpass(48, 0.45)
    proto = design_prototype(m, taps_per_phase=4)
    tproto = int(pad_prototype(proto, m).shape[0])
    x = torch.as_tensor(complex_awgn(np.random.default_rng(3), (nbuf * C20_FAULT_BUFFER,)),
                        device=dev)
    n = C20_FAULT_BUFFER
    ckpt = str(work / "fault_ck")

    def fresh_state():
        return (torch.zeros(47, dtype=torch.complex64, device=dev),
                torch.zeros(tproto - 1, dtype=torch.complex64, device=dev))

    def run_(start, state, mesh, stop_after=None):
        outs = []
        tail_f, tail_c = state
        for b in range(start, nbuf):
            xb = dmesh.shard(x[b * n:(b + 1) * n], mesh)
            tail_f, y = fir_time_sharded_stream(pre, tail_f, xb, mesh)
            tail_c, banks = channelize_time_sharded_stream(proto, tail_c, y, m, mesh)
            outs.append(dmesh.unshard(banks, dev, dim=0).cpu())
            checkpoint.save(ckpt, (tail_f, tail_c), block_index=b + 1)
            if stop_after is not None and b + 1 == stop_after:
                return outs
        return outs

    ref = channelize_full(proto, fir_full(pre, x), m).cpu()
    outs_a = run_(0, fresh_state(), dmesh.make_mesh(time=shards, devices=[dev] * shards),
                  stop_after=3)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()                  # every live tensor of the run is gone
    state, start = checkpoint.restore(ckpt, fresh_state())
    outs_b = run_(start, state, dmesh.make_mesh(time=shards, devices=[dev] * shards))
    got = torch.cat(outs_a + outs_b, dim=-1)
    same = bool(torch.equal(got, ref))
    print(f"[20] fault injection (bench/fault_injection.py): {nbuf} buffers of {n} samples, "
          f"48-tap FIR -> {m}-channel bank over {shards} time shards of one card, a checkpoint "
          f"after each buffer, the slice dropped after buffer 3 and restored at buffer {start} "
          f"into a fresh mesh: output [{got.shape[0]}, {got.shape[1]}] == the unbroken "
          f"single-device channelize_full(fir_full(...)) bit for bit {same} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    require(same and start == 3, "fault injection: recovered stream != unbroken run")


def phase20(torch, dev) -> int:
    """The port's CLI on the card, file to file (``python -m
    srcdsp_tpu_torch.cli``): a 2^26-sample FSK capture streamed unbroken, the
    same run SIGKILLed once a checkpoint of block >= 16 is on disk and
    resumed, byte-equal, BER 0; a checkpoint in the JAX package's format
    resumed; config 5's form in files (`channelize --demod psk`, then
    `channelize` and `mux`); `fecenc` / `fecdec --code ldpc` over 16,384
    codewords through K14; every other chain once, equal to its `--device
    cpu` run; the fault-injection run of bench/fault_injection.py on shards
    of one card; `debug.checked` on the card. Returns K14's launches made by
    the CLI. The files live in a temporary directory removed at the end."""
    import contextlib
    import io
    import os
    import shutil
    import signal
    import tempfile

    from srcdsp_tpu_torch import checkpoint, cli, tree
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.io.capture import CaptureMeta, read_capture_blocks, write_capture
    from srcdsp_tpu_torch.kernels import _build
    from srcdsp_tpu_torch.testing.signals import fsk_baseband, psk_wideband, random_bits, tone

    card = card_line()
    print(f"[20] card: {card}", flush=True)
    work = Path(tempfile.mkdtemp(prefix="srcdsp_cli_"))
    k14_cli = 0

    on = str(dev)

    def run(argv, device=on):
        """cli.main in this process; (seconds, its stderr)."""
        err = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            cli.main([str(a) for a in argv] + ["--device", device])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, err.getvalue().strip()

    def sub(argv):
        """The CLI as its own process on the card (`python -m`)."""
        return subprocess.Popen([sys.executable, "-m", "srcdsp_tpu_torch.cli"]
                                + [str(a) for a in argv], cwd=str(REPO),
                                env=dict(os.environ, PYTHONPATH=str(REPO)),
                                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def finish(proc, what):
        _, err = proc.communicate(timeout=600)
        require(proc.returncode == 0, f"{what}: exit {proc.returncode}: {err[-2000:]}")
        return err

    def cap(name, x):
        path = work / name
        write_capture(str(path), np.asarray(x, np.complex64), CaptureMeta(fmt="cf32"))
        return path

    def prefix(path, n, name):
        """The first n samples of a cf32 capture as a capture of its own."""
        raw = np.fromfile(path, np.float32, count=2 * n)
        return cap(name, raw[0::2] + 1j * raw[1::2])

    def rel_l2(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))

    def head_equal(card_path, cpu_path, kind):
        """The card's file against the CPU run of a prefix: u8 / text bytes
        equal, f32 / cf32 within rel L2 1e-5 over the CPU run's length."""
        a, b = Path(card_path).read_bytes(), Path(cpu_path).read_bytes()
        if kind == "bytes":
            return a[:len(b)] == b and len(b) > 0, "equal"
        x, y = np.frombuffer(a[:len(b)], np.float32), np.frombuffer(b, np.float32)
        r = rel_l2(x, y)
        return r <= 1e-5 and y.size > 0, f"rel L2 {r:.3g}"

    try:
        # --- 1. crash and resume, for real: 2^26 samples, SIGKILL, resume ----------------
        t_step = time.perf_counter()
        n1 = C20_FSK_SAMPLES
        rng = np.random.default_rng(200)
        bits = random_bits(rng, (n1 // (DECIM * SPS),))
        x = (fsk_baseband(bits, DECIM * SPS, DEV / DECIM) * tone(n1, 0.11)).astype(np.complex64)
        capf = cap("fsk.cf32", x)
        del x
        t_make = time.perf_counter() - t_step
        fsk_argv = ["fsk", capf, None, "--center", "0.11", "--decim", DECIM, "--sps", SPS,
                    "--dev", DEV, "--cutoff", "0.03", "--block", C20_BLOCK]
        with_out = lambda out: [out if a is None else a for a in fsk_argv]   # noqa: E731
        nblk = n1 // C20_BLOCK
        per_blk = C20_BLOCK // (DECIM * SPS)
        t0 = time.perf_counter()
        finish(sub(with_out(work / "unbroken.u8") + ["--device", on]), "fsk unbroken")
        t_sub = time.perf_counter() - t0
        ref = np.fromfile(work / "unbroken.u8", np.uint8)
        require(ref.size == nblk * per_blk, f"fsk unbroken: {ref.size} symbols")
        ck = work / "ck"
        killed = sub(with_out(work / "killed.u8") + ["--ckpt", ck, "--ckpt-every", C20_CKPT_EVERY,
                                                     "--device", on])
        at = None
        while killed.poll() is None:
            if (work / "ck.json").exists():
                blk = json.loads((work / "ck.json").read_text())["block_index"]
                if blk >= C20_KILL_AFTER:
                    killed.send_signal(signal.SIGKILL)
                    at = blk
                    break
            time.sleep(0.002)
        killed.communicate(timeout=600)
        require(at is not None and killed.returncode == -signal.SIGKILL,
                f"fsk: the run ended (exit {killed.returncode}) before a checkpoint of block "
                f">= {C20_KILL_AFTER}")
        on_disk = os.path.getsize(work / "killed.u8")
        err = finish(sub(with_out(work / "killed.u8") + ["--ckpt", ck, "--ckpt-every",
                                                         C20_CKPT_EVERY, "--device", on]),
                     "fsk resume")
        got = np.fromfile(work / "killed.u8", np.uint8)
        same = np.array_equal(got, ref)
        ber = float(ber_per_channel(bits[None], ref[None].astype(np.int32))[0])
        t_first, _ = run(with_out(work / "warm.u8"))
        t_warm, _ = run(with_out(work / "warm.u8"))
        require(np.array_equal(np.fromfile(work / "warm.u8", np.uint8), ref),
                "fsk: in-process run != the subprocess run")
        print(f"[20] fsk, config 4's signal at decim {DECIM}, sps {SPS}: {n1} samples "
              f"({n1 * 8 / 2 ** 20:.0f} MiB cf32, made in {t_make:.1f} s), {nblk} blocks of "
              f"{C20_BLOCK}: unbroken subprocess {t_sub:.2f} s wall ({n1 / t_sub / 1e6:.1f} Ms/s "
              f"file to file, process start included); in process: first {t_first:.3f} s, "
              f"then {t_warm:.3f} s ({n1 / t_warm / 1e6:.1f} Ms/s file to file) ({card})",
              flush=True)
        print(f"[20] SIGKILL after the checkpoint of block {at} ({on_disk} bytes of output on "
              f"disk); resumed: '{err.splitlines()[0]}'; output == unbroken byte for byte "
              f"{same}; checkpoint gone {not checkpoint.exists(str(ck))}; BER {ber} over "
              f"{bits.size} bits after 16 settling symbols", flush=True)
        require(same and not checkpoint.exists(str(ck)) and ber == 0.0,
                f"fsk resume: equal {same}, BER {ber}")

        # per-block legs of the stream, timed on the first blocks (host clock)
        params = make_fsk_params(0.11, 64, 0.03, DECIM, SPS, DEV, device=dev)
        st = fsk_init(params)
        legs = np.zeros(4)
        gen = read_capture_blocks(str(capf), C20_BLOCK)
        legs_out = open(work / "legs.u8", "wb")
        for _ in range(C20_LEG_BLOCKS):
            t0 = time.perf_counter()
            xb = next(gen)
            t1 = time.perf_counter()
            xd = torch.as_tensor(xb, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            st, (b, _) = fsk_apply(params, st, xd)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            legs_out.write(b.cpu().numpy().astype(np.uint8).tobytes())
            legs += np.array([t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3])
        legs_out.close()
        legs = legs / C20_LEG_BLOCKS * 1e3
        print(f"[20] one block of {C20_BLOCK} ({C20_BLOCK * 8 / 2 ** 20:.0f} MiB), mean of "
              f"{C20_LEG_BLOCKS} (host clock): read + decode {legs[0]:.3f} ms, H2D "
              f"{legs[1]:.3f} ms, chain {legs[2]:.3f} ms, D2H + write {legs[3]:.3f} ms; "
              f"{nblk} blocks in process {t_warm * 1e3 / nblk:.3f} ms a block", flush=True)

        # --- 2. a checkpoint in the JAX package's format, resumed by the port ---------------
        st = fsk_init(params)
        with open(work / "jaxfmt.u8", "wb") as f:
            for i, xb in enumerate(read_capture_blocks(str(capf), C20_BLOCK)):
                if i == C20_CKPT_EVERY:
                    break
                st, (b, _) = fsk_apply(params, st, torch.as_tensor(xb, device=dev))
                f.write(b.cpu().numpy().astype(np.uint8).tobytes())
        leaves = [x.cpu().numpy() for x in tree.flatten(st)[0]]
        leaves = [a.astype(np.uint32) if a.dtype == np.int64 else a for a in leaves]
        arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
        arrays["block_index"] = np.asarray(C20_CKPT_EVERY)
        np.savez(work / "jck.npz", **arrays)
        (work / "jck.json").write_text(json.dumps({
            "block_index": C20_CKPT_EVERY, "num_leaves": len(leaves),
            "treedef": "PyTreeDef(CustomNode(namedtuple[FskState], [CustomNode(namedtuple["
                       "NcoState], [*]), CustomNode(namedtuple[FirState], [*]), *, CustomNode("
                       "namedtuple[TimingState], [*, *])]))", "extra": {}}))
        t_j, err = run(with_out(work / "jaxfmt.u8") + ["--ckpt", work / "jck", "--ckpt-every",
                                                        C20_CKPT_EVERY])
        same = np.array_equal(np.fromfile(work / "jaxfmt.u8", np.uint8), ref)
        print(f"[20] a JAX-format checkpoint (uint32 phase word, leaf_0..leaf_{len(leaves) - 1}, "
              f"block_index {C20_CKPT_EVERY}) written from the port's state: '"
              f"{err.splitlines()[0]}' in {t_j:.3f} s; output == unbroken byte for byte {same}",
              flush=True)
        require(same and err.startswith(f"resumed from block {C20_CKPT_EVERY}"),
                "JAX-format checkpoint: resumed output differs")
        for p in work.glob("*.u8"):
            p.unlink()
        capf.unlink()

        # --- 3. config 5's form in files: channelize --demod psk, channelize, mux --------
        m, sps5 = C5_CHANNELS, C5_SPS
        data, _, wb = psk_wideband(np.random.default_rng(201), m, C20_WIDE_SAMPLES // (m * sps5),
                                   C5_ORDER, sps5, device=dev)
        wbf = cap("wide.cf32", wb.cpu().numpy())
        wpre = prefix(wbf, C20_WIDE_PREFIX, "wide_pre.cf32")
        del wb
        chan = ["--channels", m, "--sps", sps5, "--order", C5_ORDER, "--block", C20_BLOCK]
        t_c, _ = run(["channelize", wbf, work / "dm"] + chan + ["--demod", "psk"])
        run(["channelize", wpre, work / "dmc"] + chan + ["--demod", "psk"], device="cpu")
        idx = np.stack([np.fromfile(work / f"dm.ch{c:03d}.u8", np.uint8) for c in range(m)])
        same = all(head_equal(work / f"dm.ch{c:03d}.u8", work / f"dmc.ch{c:03d}.u8", "bytes")[0]
                   for c in range(m))
        ser = ser_per_channel(data, idx.astype(np.int64), C5_ORDER)
        print(f"[20] channelize --demod psk: {C20_WIDE_SAMPLES} wideband samples ({m} QPSK "
              f"channels of psk_wideband, sps {sps5}, the CLI's bank and rrc_span 4) -> {m} u8 "
              f"files in {t_c:.3f} s ({C20_WIDE_SAMPLES / t_c / 1e6:.1f} Ms/s file to file); "
              f"max SER {ser.max()} after diff_decode; each file == the --device cpu run on the "
              f"first {C20_WIDE_PREFIX} samples {same}", flush=True)
        require(same and bool(np.all(ser == 0.0)), f"channelize --demod psk: SER {ser.max()}, "
                f"== CPU {same}")
        t_c2, _ = run(["channelize", wbf, work / "ch"] + chan)
        run(["channelize", wpre, work / "chc"] + chan, device="cpu")
        rels = [head_equal(work / f"ch.ch{c:03d}.cf32", work / f"chc.ch{c:03d}.cf32", "rel")
                for c in range(m)]
        t_m, _ = run(["mux", work / "ch", work / "mux.cf32", "--channels", m,
                      "--block", C20_BLOCK])
        run(["mux", work / "chc", work / "muxc.cf32", "--channels", m, "--block", C20_BLOCK],
            device="cpu")
        ok_m, txt_m = head_equal(work / "mux.cf32", work / "muxc.cf32", "rel")
        print(f"[20] channelize -> {m} cf32 files in {t_c2:.3f} s, each == CPU "
              f"{all(r for r, _ in rels)} (worst {max(float(t.split()[-1]) for _, t in rels):.3g}"
              f" rel L2); mux back -> {C20_WIDE_SAMPLES} samples in {t_m:.3f} s "
              f"({C20_WIDE_SAMPLES / t_m / 1e6:.1f} Ms/s), == CPU {ok_m} ({txt_m})", flush=True)
        require(all(r for r, _ in rels) and ok_m, "channelize / mux: card != CPU")
        for p in list(work.glob("*.ch*")) + [wbf, wpre, work / "mux.cf32", work / "muxc.cf32"]:
            p.unlink()

        # --- 4. fecenc / fecdec --code ldpc over 16,384 codewords (K14) ---------------------
        rng = np.random.default_rng(202)
        kb, nb = 252, 504
        u = rng.integers(0, 2, C20_LDPC_WORDS * kb).astype(np.uint8)
        u.tofile(work / "u.u8")
        t_e, _ = run(["fecenc", work / "u.u8", work / "c.u8"])
        c = np.fromfile(work / "c.u8", np.uint8)
        require(c.size == C20_LDPC_WORDS * nb, f"fecenc: {c.size} coded bits")
        hard = c.reshape(C20_LDPC_WORDS, nb).copy()
        for w in range(C20_LDPC_WORDS):
            hard[w, rng.choice(nb, C20_LDPC_HARD_ERRORS, replace=False)] ^= 1
        hard.tofile(work / "h.u8")
        sigma = C20_LDPC_SIGMA
        llr = (2.0 / sigma ** 2 * ((1.0 - 2.0 * c) + sigma * rng.standard_normal(c.size))
               ).astype(np.float32)
        llr.tofile(work / "l.f32")
        n_pre = C20_LDPC_CPU_WORDS
        hard[:n_pre].tofile(work / "h_pre.u8")
        llr[:n_pre * nb].tofile(work / "l_pre.f32")
        rows_ = {}
        for tag, src, extra in (("hard", "h", ["--hard"]), ("LLR", "l", [])):
            suffix = ".u8" if tag == "hard" else ".f32"
            before = _build.LAUNCHES["ldpc_edges"]
            t_d, err = run(["fecdec", work / f"{src}{suffix}", work / f"d_{src}.u8"] + extra)
            k14 = _build.LAUNCHES["ldpc_edges"] - before
            k14_cli += k14
            run(["fecdec", work / f"{src}_pre{suffix}", work / f"dc_{src}.u8"] + extra,
                device="cpu")
            d = np.fromfile(work / f"d_{src}.u8", np.uint8)
            dc = np.fromfile(work / f"dc_{src}.u8", np.uint8)
            rows_[tag] = (np.array_equal(d, u), np.array_equal(d[:dc.size], dc), k14, t_d, err)
            print(f"[20] fecdec --code ldpc ({tag}: "
                  + (f"{C20_LDPC_HARD_ERRORS} bit errors a word" if tag == "hard"
                     else f"BPSK LLRs at sigma {sigma}, {10 * np.log10(1 / (sigma ** 2)):.1f} dB")
                  + f"), {C20_LDPC_WORDS} codewords of the (3,6) n {nb} code, 10 iterations: "
                  f"'{err}'; decoded == sent {rows_[tag][0]}; K14 launches {k14}; first {n_pre} "
                  f"codewords == the --device cpu run (plain K14) byte for byte {rows_[tag][1]}; "
                  f"{t_d:.3f} s, {C20_LDPC_WORDS * nb / t_d / 1e6:.1f} Mb/s coded file to file",
                  flush=True)
            require(rows_[tag][0] and rows_[tag][1] and k14 > 0,
                    f"fecdec ldpc {tag}: decoded {rows_[tag][0]}, == CPU {rows_[tag][1]}, "
                    f"K14 launches {k14}")
        from srcdsp_tpu_torch.kernels.ldpc_pallas import make_ldpc_decoder, plan_edges
        from srcdsp_tpu_torch.ldpc import make_ldpc_code, make_regular_ldpc

        t0 = time.perf_counter()
        h = make_regular_ldpc(nb, 3, 6, seed=0)
        dec = make_ldpc_decoder(make_ldpc_code(h, device=dev), plan_edges(h), device=dev)
        t_setup = time.perf_counter() - t0
        llr_d = torch.as_tensor(llr.reshape(C20_LDPC_WORDS, nb), device=dev)
        ms_dec = median_ms(torch, lambda: dec(llr_d))
        print(f"[20] fecenc --code ldpc: {u.size} info bits -> {c.size} coded bits in "
              f"{t_e:.3f} s; of fecdec's time, the code, its edge plan and the decoder take "
              f"{t_setup * 1e3:.1f} ms to build (host), one decode of the {C20_LDPC_WORDS} "
              f"LLR words on the card (K14, bits, info, syndromes) {ms_dec:.3f} ms (CUDA-event "
              f"median of {REPS}; {C20_LDPC_WORDS * nb / ms_dec / 1e3:.1f} Mb/s coded)",
              flush=True)
        del llr_d, dec

        # --- 5. every other chain once, the card against --device cpu ---------------------
        t5 = time.perf_counter()
        n5, pre5 = C20_STREAM_SAMPLES, C20_STREAM_PREFIX
        rng = np.random.default_rng(203)
        from srcdsp_tpu_torch.chains.analog import am_modulate, fm_modulate, fm_stereo_mpx
        from srcdsp_tpu_torch.chains.dqpsk import dqpsk_baseband

        b5 = random_bits(rng, (n5 // (DECIM * SPS),))
        streams = {"fsk": cap("s_fsk.cf32", fsk_baseband(b5, DECIM * SPS, DEV / DECIM)
                              * tone(n5, 0.11))}
        audio = np.sin(2 * np.pi * 0.003 * np.arange(n5)).astype(np.float32)
        streams["am"] = cap("s_am.cf32", am_modulate(audio, 0.5, 0.21, device=dev).cpu().numpy())
        k = np.arange(n5)
        mpx = fm_stereo_mpx(0.7 * np.cos(2 * np.pi * 0.001 * k), 0.7 * np.cos(
            2 * np.pi * 0.0016 * k), FM_PILOT / 4)
        streams["stereo"] = cap("s_st.cf32", fm_modulate(mpx.astype(np.float32), 0.02, 0.07,
                                                         device=dev).cpu().numpy())
        dq = dqpsk_baseband(rng.integers(0, 4, n5 // (DECIM * SPS)), DECIM * SPS)
        streams["dqpsk"] = cap("s_dq.cf32", dq[:n5] * tone(n5, 0.11))
        syms = {"psk": rng.integers(0, 4, n5 // 8), "qam": rng.integers(0, 16, n5 // 8),
                "fsk": rng.integers(0, 2, n5 // 8), "gmsk": rng.integers(0, 2, n5 // 8),
                "bpsk": rng.integers(0, 2, n5 // 8)}
        mod_rows = []
        for mod, s_ in syms.items():
            s_.astype(np.uint8).tofile(work / f"{mod}.u8")
            s_[:pre5 // 8].astype(np.uint8).tofile(work / f"{mod}_pre.u8")
            margs = ["--mod", "psk" if mod == "bpsk" else mod, "--order",
                     {"qam": 16, "bpsk": 2}.get(mod, 4), "--sps", 8, "--center", 0.12, "--dev",
                     0.0625, "--block", C20_BLOCK]
            t_mod, _ = run(["mod", work / f"{mod}.u8", work / f"mod_{mod}.cf32"] + margs)
            run(["mod", work / f"{mod}_pre.u8", work / f"modc_{mod}.cf32"] + margs, device="cpu")
            ok, txt = head_equal(work / f"mod_{mod}.cf32", work / f"modc_{mod}.cf32", "rel")
            mod_rows.append(f"{mod} {t_mod * 1e3:.1f} ms {ok} ({txt})")
            require(ok, f"mod {mod}: card != CPU ({txt})")
            streams[f"mod_{mod}"] = work / f"mod_{mod}.cf32"
        print(f"[20] mod ({n5 // 8} symbols each at sps 8 -> {n5} samples; == CPU on the first "
              f"{pre5 // 8} symbols): " + "; ".join(mod_rows), flush=True)
        blk = ["--block", C20_STREAM_BLOCK]
        stream_cases = [
            ("fir", "fsk", ["--taps", 64, "--cutoff", 0.1, "--decim", 2], "rel"),
            ("resample", "fsk", ["--up", 3, "--down", 4, "--taps", 96], "rel"),
            ("fm", "fsk", ["--center", 0.11, "--decim", 4, "--dev", 0.08, "--audio-decim", 2],
             "rel"),
            ("fm", "stereo", ["--stereo", "--center", 0.07, "--decim", 4, "--dev", 0.08,
                              "--audio-decim", 4, "--taps", 96], "rel"),
            ("am", "am", ["--center", 0.21, "--decim", 4], "rel"),
            ("psk", "mod_psk", ["--center", 0.12, "--decim", 2, "--sps", 4], "bytes"),
            ("qam", "mod_qam", ["--center", 0.12, "--decim", 2, "--sps", 4, "--order", 16],
             "bytes"),
            ("dqpsk", "dqpsk", ["--center", 0.11], "bytes"),
            ("fsk", "mod_gmsk", ["--center", 0.12, "--sps", 2, "--dev", 0.125,
                                 "--timing-forget", 0.95], "bytes"),
        ]
        rows5 = []
        for i, (chain, src, args_, kind) in enumerate(stream_cases):
            srcp = streams[src]
            srcpre = prefix(srcp, pre5, f"pre_{i}.cf32")
            t_s, _ = run([chain, srcp, work / f"o{i}"] + args_ + blk)
            run([chain, srcpre, work / f"oc{i}"] + args_ + blk, device="cpu")
            ok, txt = head_equal(work / f"o{i}", work / f"oc{i}", kind)
            tag = f"{chain}{' --stereo' if '--stereo' in args_ else ''} ({src})"
            rows5.append(f"{tag} {t_s * 1e3:.1f} ms, {n5 / t_s / 1e6:.1f} Ms/s, == CPU {ok} "
                         f"({txt})")
            require(ok, f"{tag}: card != CPU ({txt})")
        print(f"[20] streams of {n5} samples, block {C20_STREAM_BLOCK}, each card file's first part == "
              f"the --device cpu run on the first {pre5} samples:\n    " + "\n    ".join(rows5),
              flush=True)
        # the closed loops: per-symbol Python loops, on a short capture both ways
        loops = []
        for i, (src, args_, n_) in enumerate((
                ("fsk", ["--center", 0.11, "--cutoff", 0.03, "--tracking"], C20_TRACK_FSK),
                ("mod_psk", ["--center", 0.12, "--decim", 2, "--sps", 4, "--tracking"],
                 C20_TRACK_PSK))):
            short = prefix(streams[src], n_, f"track_{i}.cf32")
            chain = "psk" if src == "mod_psk" else "fsk"
            t_s, _ = run([chain, short, work / f"t{i}"] + args_ + ["--block", n_ // 2])
            t_c, _ = run([chain, short, work / f"tc{i}"] + args_ + ["--block", n_ // 2],
                         device="cpu")
            ok = Path(work / f"t{i}").read_bytes() == Path(work / f"tc{i}").read_bytes()
            loops.append(f"{chain} --tracking ({n_} samples) card {t_s:.2f} s, CPU {t_c:.2f} s, "
                         f"decisions equal {ok}")
            require(ok, f"{chain} --tracking: card decisions != CPU")
        print("[20] " + "; ".join(loops), flush=True)

        gens = []
        for argv in (["--gen", "tone", "--center", 0.11, "--snr", 20, "--fmt", "cu8"],
                     ["--gen", "chirp", "--fmt", "ci16"], ["--gen", "noise", "--seed", 4]):
            run(["gen", work / "g.iq"] + argv + ["--num-samples", n5])
            run(["gen", work / "gc.iq"] + argv + ["--num-samples", n5], device="cpu")
            gens.append((work / "g.iq").read_bytes() == (work / "gc.iq").read_bytes())
        mixed = np.fromfile(streams["mod_psk"], np.float32)
        mixed = (mixed[0::2] + 1j * mixed[1::2])[:C20_SCAN_SAMPLES]
        mixed = cap("scan.cf32", mixed + 0.4 * tone(mixed.size, -0.3)
                    + 0.01 * (rng.standard_normal(mixed.size)
                              + 1j * rng.standard_normal(mixed.size)))
        surveys = []
        bpsk = streams["mod_bpsk"]
        for name, argv in (("scan --analyze", ["scan", mixed, None, "--analyze"]),
                           ("scf (BPSK)", ["scf", bpsk, None, "--scf-thresh", 0.3]),
                           ("scf --conj (BPSK)", ["scf", bpsk, None, "--conj"])):
            t_s, _ = run([work / "r.jsonl" if a is None else a for a in argv])
            run([work / "rc.jsonl" if a is None else a for a in argv], device="cpu")
            ra = [json.loads(x) for x in (work / "r.jsonl").read_text().splitlines()]
            rb = [json.loads(x) for x in (work / "rc.jsonl").read_text().splitlines()]
            ok = len(ra) == len(rb) > 0 and all(
                a.keys() == b.keys() and all(
                    abs(a[f] - b[f]) <= 1e-5 * max(1.0, abs(a[f])) + 1.01e-4
                    if isinstance(a[f], float) else a[f] == b[f] for f in a)
                for a, b in zip(ra, rb))
            surveys.append(f"{name} {len(ra)} records {t_s * 1e3:.0f} ms == CPU {ok}")
            require(ok, f"{name}: card records != CPU: {ra} vs {rb}")
        print(f"[20] gen (tone cu8, chirp ci16, noise; {n5} samples) == CPU {gens}; "
              + "; ".join(surveys), flush=True)
        require(all(gens), "gen: card != CPU")

        fec_rows = []
        for code, extra, words in (("polar", ["--fec-n", 128, "--fec-k", 64], 256),
                                   ("turbo", ["--fec-k", 128, "--fec-iters", 4], 64),
                                   ("conv", [], 64), ("rs", [], 64), ("bch", [], 1024),
                                   ("golay", [], 4096)):
            kk = {"polar": 64, "turbo": 128, "conv": 128, "rs": 223, "bch": 21, "golay": 12}[code]
            msg = rng.integers(0, 256 if code == "rs" else 2, words * kk).astype(np.uint8)
            msg.tofile(work / "m.u8")
            run(["fecenc", work / "m.u8", work / "mc.u8", "--code", code] + extra)
            run(["fecenc", work / "m.u8", work / "mcc.u8", "--code", code] + extra, device="cpu")
            enc_ok = (work / "mc.u8").read_bytes() == (work / "mcc.u8").read_bytes()
            cw = np.fromfile(work / "mc.u8", np.uint8).copy()
            if code == "rs":
                cw.reshape(words, -1)[:, 3:9] ^= 0x5A
            else:
                cw[::97] ^= 1
            cw.tofile(work / "mn.u8")
            hard = [] if code == "rs" else ["--hard"]
            t_d, err = run(["fecdec", work / "mn.u8", work / "md.u8", "--code", code] + hard
                           + extra)
            run(["fecdec", work / "mn.u8", work / "mdc.u8", "--code", code] + hard + extra,
                device="cpu")
            d = np.fromfile(work / "md.u8", np.uint8)
            dec_ok = d.tobytes() == (work / "mdc.u8").read_bytes()
            back = np.array_equal(d[:msg.size], msg)
            fec_rows.append(f"{code} ({words} words) encode == CPU {enc_ok}, decode == CPU "
                            f"{dec_ok}, sent back {back}, {t_d * 1e3:.1f} ms")
            require(enc_ok and dec_ok and back, f"fec {code}: {fec_rows[-1]}")
        print("[20] fecenc / fecdec, the six other codes, errors injected: "
              + "; ".join(fec_rows), flush=True)
        protocols = protocol_files(work, np.random.default_rng(204))
        proto_rows = []
        for name, (argv, check) in protocols.items():
            t_s, _ = run([work / f"p_{name}" if a is None else a for a in argv])
            run([work / f"pc_{name}" if a is None else a for a in argv], device="cpu")
            out = (work / f"p_{name}").read_bytes()
            ok = out == (work / f"pc_{name}").read_bytes()
            if name in ("apt", "sstv"):       # images: float envelopes, within a grey level
                a, b = (np.frombuffer(x.split(b"\n", 3)[3], np.uint8).astype(int)
                        for x in (out, (work / f"pc_{name}").read_bytes()))
                ok = bool(np.abs(a - b).max() <= 1)
            sent = check(out)
            proto_rows.append(f"{name} {t_s * 1e3:.0f} ms == CPU {ok} sent back {sent}")
            require(ok and sent, f"{name}: == CPU {ok}, sent back {sent}")
        print("[20] the fourteen decoder subcommands on the card, each == its --device cpu run "
              "on the same file: " + "; ".join(proto_rows), flush=True)
        print(f"[20] step 5 took {time.perf_counter() - t5:.1f} s", flush=True)
        for p in list(work.iterdir()):
            p.unlink()

        # --- 6. fault injection on shards of one card (bench/fault_injection.py) -----------
        fault_injection(torch, dev, work)

        # --- 7. debug.checked on the card -------------------------------------------------
        from srcdsp_tpu_torch.debug import NonFiniteError, checked

        xc = torch.as_tensor(tone(C20_CHECK_BLOCK, 0.11), device=dev)
        plain = lambda: fsk_apply(params, fsk_init(params), xc)      # noqa: E731
        wrapped = checked(lambda s, v: fsk_apply(params, s, v))
        ms_plain = median_ms(torch, plain)
        ms_checked = median_ms(torch, lambda: wrapped(fsk_init(params), xc))
        bad = xc.clone()
        bad[C20_CHECK_BLOCK // 3] = float("nan")
        try:
            wrapped(fsk_init(params), bad)
            named = None
        except NonFiniteError as e:
            named = str(e)
        after = int(wrapped(fsk_init(params), xc)[1][0].sum())
        print(f"[20] debug.checked(fsk_apply) at a block of {C20_CHECK_BLOCK}: {ms_plain:.3f} ms "
              f"a call plain, {ms_checked:.3f} ms checked (CUDA-event medians of {REPS}; one "
              f"stacked finiteness read a call); a NaN in the input raises '{named}'; the card "
              f"runs on after it ({after} one bits) ({card})", flush=True)
        require(named is not None and named.endswith("[0].timing.acc"),
                f"checked: raised {named!r}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return k14_cli


def halo_steps(backend: str, nproc: int, reports, card: str) -> None:
    """Phase 21's K19 and K20 across ranks: each == its one-process form, no
    byte staged in the step without the gather, its time beside its bound
    and beside the message path's in turns."""
    from srcdsp_tpu_torch.dist import multihost_check as mhc

    decim = mhc.SIZES["full"]["k1"][2]
    for name in ("k19", "k20"):
        cs = [rep["cases"][name] for rep in reports]
        shapes = [c["shapes"] for c in cs] if name == "k19" else [[c] for c in cs]
        for j, r0 in enumerate(shapes[0]):
            per = [sh[j] for sh in shapes]
            staged = [c["staged"]["bytes"] for c in per]
            if name == "k19":
                # each rank reads and writes its shards' halos and one pushed block
                what = f"{r0['rows']} x {r0['samples']}, halo {r0['halo']}"
                nbytes = 2 * (C21_SHARDS + 1) * r0["rows"] * r0["halo"] * 4
                equal = r0["equal_slices"] and r0["equal_one_process"]
                yard = "halo_from_left"
            else:
                # a rank's K20 reads its 2 x S/nproc samples (and one 2 x 128 history)
                # and writes 2 x S/nproc/decim
                what = f"2^{int(np.log2(r0['samples']))} samples"
                rank_samples = r0["samples"] // nproc
                nbytes = 4 * (2 * rank_samples + 2 * 128 + 2 * rank_samples // decim)
                equal = r0["equal_one_call"] and r0["equal_one_process"]
                yard = "mix_fir_time_sharded"
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            print(f"[21] {backend} {nproc} ranks {name.upper()} ({what}): == one-process form "
                  f"(torch.equal) {equal}; step without the gather "
                  + ", ".join(f"rank {i} {c['ms_bare']:.4f} ms" for i, c in enumerate(per))
                  + f", with it {per[0]['ms']:.3f} ms; staged {staged} B; in "
                  f"{mhc.TURNS} turns "
                  + ", ".join(f"rank {i} {name.upper()} {c['turns'][name]['ms']:.4f} ms (of it "
                              f"{c['turns'][name]['signal_ms']:.4f} ms host waits for signals) / "
                              f"{yard} {c['turns'][yard]['ms']:.4f} ms (staged "
                              f"{c['turns'][yard]['staged']} B)" for i, c in enumerate(per))
                  + f"; bound {bound:.7f} ms (bytes, a rank); launches "
                  + ", ".join(str(c["launches"]) for c in per) + f" ({card})", flush=True)
            require(equal, f"{name} across ranks ({backend}) != its one-process form")
            require(all(b == 0 for b in staged),
                    f"{name} across ranks ({backend}): {staged} B staged through the host")


def capture_steps(backend: str, nproc: int, reports, card: str) -> None:
    """Phase 21's capture case: every rank streams its own shards of a ci16
    file through K20, == the one-process stream, each rank one host copy a
    shard a block, K19 (the pushes over IPC) and K20 launched."""
    caps = [rep["cases"]["capture"] for rep in reports]
    c0 = caps[0]
    streamed = {k: sum(c["launches"].get(k, 0) for c in caps) for k in ("halo_dma", "halo_fused")}
    print(f"[21] {backend} {nproc} ranks: capture ({c0['blocks']} blocks of {c0['block']} ci16 "
          f"samples, each rank decoding and copying its own {C21_SHARDS} shards) -> K20 == the "
          f"one-process stream (torch.equal) {c0['equal_one_process']}; file to result without "
          f"the gather "
          + ", ".join(f"rank {i} {c['ms_bare']:.1f} ms ({c['samples'] / c['ms_bare'] / 1e3:.1f} "
                      f"Ms/s of the whole file)" for i, c in enumerate(caps))
          + f", with it {c0['ms']:.1f} ms; host-to-device copies "
          + ", ".join(str(c["h2d"]) for c in caps) + f"; K19 / K20 launches {streamed} ({card})",
          flush=True)
    require(all(c["ok"] for c in caps) and c0["equal_one_process"] and all(streamed.values()),
            f"capture across ranks ({backend}): {caps}")


def phase21(torch, dev) -> dict:
    """The multi-process tier (``dist.multihost_check``, ``dist.
    fault_injection_multihost``): fresh worker processes, the kernels built
    once by this process before any start. On one card 2 ranks share it over
    gloo (card tensors staged through the host); with two cards, also NCCL
    with one rank a card. Config 5 across 2 ranks == the one-process mesh4
    form of phase 14 (torch.equal) and its indices == the single-device
    build, soft within 2e-5; K1, K11 and K20 across ranks == one unsharded
    call (torch.equal), K19 and K20 == their one-process forms, with no
    byte staged through the host in their steps (the boundary by CUDA IPC);
    the pipeline on 3 ranks; the 2 -> 1 fault injection. Returns the
    workers' kernel launches in their distributed steps."""
    import tempfile

    from srcdsp_tpu_torch.configs import build_config5
    from srcdsp_tpu_torch.dist import fault_injection_multihost as fim
    from srcdsp_tpu_torch.dist import mesh as dmesh
    from srcdsp_tpu_torch.dist import multihost_check as mhc

    card = card_line()
    cards = torch.cuda.device_count()
    legs = [("gloo", 2)] + ([("nccl", 2)] if cards >= 2 else [])
    print(f"[21] {cards} CUDA device(s): " + ", ".join(f"{b} x {n} ranks" for b, n in legs)
          + ("" if cards >= 2 else " (NCCL needs a card a rank: not run)"), flush=True)
    torch.cuda.empty_cache()
    mesh4 = dmesh.make_mesh(time=2 * C21_SHARDS, devices=[dev] * (2 * C21_SHARDS))
    bm = build_config5(C5_COMPLEX_FRAMES, C5_CHANNELS, mesh=mesh4)
    idxm, softm = (t.cpu() for t in bm.step(*bm.example))
    b1 = build_config5(C5_COMPLEX_FRAMES, C5_CHANNELS, device=dev)
    idx1, soft1 = (t.cpu() for t in b1.step(*b1.example))
    del bm, b1
    torch.cuda.synchronize()
    launches = {}

    def show(tag, res):
        for rep in res["reports"]:
            for name, c in rep["cases"].items():
                st = c["staged"]
                print(f"[21] {tag} rank {rep['rank']} ({rep['backend']}, {rep['device']}, "
                      f"{rep['shards']} shards of {rep['mesh']['time']}) {name}: step "
                      f"{c['ms']:.3f} ms (CUDA events), staged {st['bytes']} B in "
                      f"{st['copies']} copies, {st['seconds'] * 1e3:.3f} ms host clock"
                      + (f" ({st['bytes'] / st['seconds'] / 1e9:.2f} GB/s)"
                         if st["seconds"] else "")
                      + f", launches {c.get('launches', {})}, ok {c['ok']}", flush=True)
                for k, v in c.get("launches", {}).items():
                    launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        for backend, nproc in legs:
            t0 = time.perf_counter()
            work = Path(tmp) / f"{backend}{nproc}"
            res = mhc.run(nproc, "cuda", backend, shards=C21_SHARDS,
                          cases=("config5", "k1", "k11", "k19", "k20", "capture"), size="full",
                          work=work, timeout=C21_TIMEOUT)
            require(res["ok"], f"multihost_check ({backend}): {res['error']}")
            show(f"{backend} {nproc} ranks", res)
            r0 = res["reports"][0]["cases"]
            got = torch.load(work / "config5.pt")
            c5_mesh = bool(torch.equal(got["idx"], idxm) and torch.equal(got["soft"], softm))
            dsoft = float((got["soft"] - soft1).abs().max())
            c5_single = bool(torch.equal(got["idx"], idx1))
            print(f"[21] {backend}: config 5 ({C5_CHANNELS} ch x {C5_COMPLEX_FRAMES} frames, "
                  f"{nproc} ranks x {C21_SHARDS} shards) == phase 14's one-process mesh form "
                  f"(torch.equal) {c5_mesh}, indices == single device {c5_single}, soft max "
                  f"diff {dsoft:.3e} (floor 2e-5); K1 over {C1_SAMPLES} samples == one K1 call "
                  f"{r0['k1']['equal_one_call']}; K11 over {C3_CHANNELS} ch == one K11 call "
                  f"{r0['k11']['equal_one_call']}; {time.perf_counter() - t0:.1f} s ({card})",
                  flush=True)
            require(c5_mesh and c5_single and dsoft <= 2e-5,
                    f"config 5 across ranks ({backend}): mesh form {c5_mesh}, indices "
                    f"{c5_single}, soft {dsoft}")
            require(all(c["ok"] for rep in res["reports"] for c in rep["cases"].values()),
                    f"multihost_check ({backend}): a case failed")
            halo_steps(backend, nproc, res["reports"], card)
            capture_steps(backend, nproc, res["reports"], card)
        t0 = time.perf_counter()
        res = mhc.run(3, "cuda", "gloo", shards=C21_SHARDS, cases=("pipeline",), size="full",
                      work=Path(tmp) / "gloo3", timeout=C21_TIMEOUT)
        require(res["ok"], f"multihost_check (3 ranks): {res['error']}")
        show("gloo 3 ranks", res)
        c = res["reports"][0]["cases"]["pipeline"]
        print(f"[21] gloo 3 ranks: pipeline ({c['channels']} channels, {c['samples']} samples) "
              f"== one-process mesh form (torch.equal) {c['equal_one_process']}, indices == "
              f"single device {c['idx_equal_single']}, soft max diff "
              f"{c['soft_max_diff_single']:.3e}; {time.perf_counter() - t0:.1f} s", flush=True)
        require(all(r["cases"]["pipeline"]["ok"] for r in res["reports"]),
                "pipeline across 3 ranks != its one-process form")
        t0 = time.perf_counter()
        res = fim.resume(fim.start("cuda", Path(tmp) / "fault", C21_TIMEOUT), "cuda")
        require(res["ok"], f"fault injection: {res['error'] or 'stitched != uninterrupted'}")
        for rep in res["reports"]:
            print(f"[21] fault injection rank {rep['rank']}: {rep['buffers']} buffers at "
                  + ", ".join(f"{v:.1f}" for v in rep["ms"]) + " ms each (host clock, "
                  f"save_orbax included), staged {rep['staged']['bytes']} B", flush=True)
        print(f"[21] fault injection: {fim.NPROC} ranks x {fim.SHARDS} shards lost after buffer "
              f"{res['start']} of {fim.NBUF}, resumed in one process on {fim.NPROC * fim.SHARDS} "
              f"shards: stitched == uninterrupted single-device run (torch.equal) True; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def phase22(torch, dev, taps1_np, word1) -> dict:
    """A ci16 capture streamed straight onto a time-sharded mesh (``io.capture.
    device_blocks`` with ``time_sharding(mesh, 2)``) through K20, block after
    block, the tail and the phase carried (``dist.multihost_check.stream_k20``):
    on C22_SHARDS shards of one card and, where the machine has two cards, on
    one shard a card. The one-card yardstick is the unsharded stream of the
    same file, K1 on [tail | block]; every block's output and the carried
    tail equal it by torch.equal. Each shard is one host-to-device copy of
    its own bytes (``io.capture.H2D``) into a buffer of its own: no whole
    block lands on a device first. Returns the launches of the phase."""
    import tempfile

    from srcdsp_tpu_torch.dist import mesh as dmesh
    from srcdsp_tpu_torch.dist import multihost_check as mhc
    from srcdsp_tpu_torch.io import capture
    from srcdsp_tpu_torch.kernels import _build
    from srcdsp_tpu_torch.kernels import halo_fused as khf
    from srcdsp_tpu_torch.kernels import mixfir as kmf

    card = card_line()
    block, n = C1_SAMPLES, C22_BLOCKS * C1_SAMPLES
    cards = torch.cuda.device_count()
    k1 = kmf.make_mix_fir_kernel(taps1_np, 2, out_tile=OUT_TILE, b_rows=B_ROWS, device=dev)
    hist = k1.hist
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "capture.ci16"
        t0 = time.perf_counter()
        mhc.write_noise_capture(path, n, seed=22)
        print(f"[22] wrote a ci16 capture of {C22_BLOCKS} x {block} samples "
              f"({path.stat().st_size / 2**30:.2f} GiB, seeded noise) in "
              f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)
        _build.reset_launches()
        capture.reset_h2d()

        # the yardstick: the unsharded stream on one card, K1 on [tail | block]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tail, ref = torch.zeros((2, hist), device=dev), []
        for b, xb in enumerate(capture.device_blocks(str(path), block, planes=True, device=dev)):
            yr, yi = k1.fn((b * block * word1 - hist * word1) & 0xFFFFFFFF, word1,
                           torch.cat([tail, xb], dim=-1))
            ref.append(torch.stack([yr.reshape(-1), yi.reshape(-1)]))
            tail = xb[:, -hist:]
        torch.cuda.synchronize()
        s_k1 = time.perf_counter() - t0
        ref_tail = tail
        print(f"[22] unsharded stream (device_blocks -> K1 on [tail | block]), one card: "
              f"{s_k1 * 1e3:.1f} ms for {n} samples, {n / s_k1 / 1e6:.1f} Ms/s file to "
              f"result (host clock; {card})", flush=True)

        legs = [("one card", dmesh.make_mesh(time=C22_SHARDS, devices=[dev] * C22_SHARDS))]
        if cards >= 2:
            legs.append(("two cards", dmesh.make_mesh(time=2)))
        else:
            print("[22] two-card leg: 1 device, not run", flush=True)
        for label, mesh in legs:
            devs = mesh.axis_devices()
            p = len(devs)
            ks = dmesh.per_device(lambda d: khf.make_halo_fused_kernel(
                taps1_np, 2, out_tile=OUT_TILE, b_rows=B_ROWS, device=d), devs)
            spec = dmesh.time_sharding(mesh, 2)
            cards_used = sorted({d.index for d in devs})
            for c in cards_used:
                torch.cuda.synchronize(c)
            capture.reset_h2d()
            t0 = time.perf_counter()
            tail, ys = mhc.stream_k20(ks, word1, path, block, mesh)
            for c in cards_used:
                torch.cuda.synchronize(c)
            s_mesh = time.perf_counter() - t0
            equal = all(torch.equal(torch.cat([y.to(dev) for y in yb], dim=-1), r)
                        for yb, r in zip(ys, ref)) and torch.equal(tail.to(dev), ref_tail)
            print(f"[22] {label}: capture -> device_blocks(sharding) -> K20 over {p} shards, "
                  f"{C22_BLOCKS} blocks: every block and the carried tail == K1 on [tail | block] "
                  f"(torch.equal) {equal}; {s_mesh * 1e3:.1f} ms, {n / s_mesh / 1e6:.1f} Ms/s "
                  f"file to result (host clock; the unsharded K1 stream {n / s_k1 / 1e6:.1f} "
                  f"Ms/s; {card})", flush=True)
            require(equal, f"capture streamed onto {label} != K1 on [tail | block]")
            h2d = {d: dict(c) for d, c in capture.H2D.items()}
            per_dev = {str(d): devs.count(d) for d in set(devs)}
            shards = next(capture.device_blocks(str(path), block, planes=True, sharding=spec))
            own = all(s.untyped_storage().nbytes() == s.numel() * 4 for s in shards)
            placed = h2d == {d: {"copies": C22_BLOCKS * k, "bytes": C22_BLOCKS * k * block * 8 // p}
                             for d, k in per_dev.items()}
            print(f"[22] {label}: host-to-device copies of the stream {h2d}, one a shard a block "
                  f"of {block * 8 // p} B: {placed}; every shard a buffer of its own: {own}",
                  flush=True)
            require(placed and own, f"capture onto {label}: shards not placed one copy each "
                    f"({h2d}, own buffers {own})")
            # the steps on resident blocks: K20 on the shards against K1 on [tail | block]
            xb = torch.cat([s.to(dev) for s in shards], dim=-1)
            cat = torch.cat([ref_tail, xb], dim=-1)
            t = in_turns(torch, {
                "K20": lambda: khf.mix_fir_halo_sharded(ks, 0, word1, ref_tail.to(devs[0]),
                                                        shards, mesh),
                "K1": lambda: k1.fn(0, word1, cat)}, 2 * REPS, cards_used)
            print(f"[22] {label}: step on a resident block of {block} samples, median of "
                  f"{2 * REPS} in turns: K20 over {p} shards {np.median(t['K20']):.4f} ms, K1 on "
                  f"[tail | block] {np.median(t['K1']):.4f} ms ({card})", flush=True)
            del ks, ys, shards, xb, cat
        # one shard's leg of a block: decode on the host, then its host-to-device copy
        per = block // C22_SHARDS
        t0 = time.perf_counter()
        xs = next(capture.read_capture_blocks(str(path), per))
        arr = np.stack([xs.real, xs.imag]).astype(np.float32)
        s_dec = time.perf_counter() - t0
        h2d_ms = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.from_numpy(arr).to(dev)
            torch.cuda.synchronize()
            h2d_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[22] a shard of {per} samples: decode {s_dec * 1e3:.1f} ms (host), host-to-"
              f"device copy of {arr.nbytes} B median {np.median(h2d_ms):.2f} ms, "
              f"{arr.nbytes / np.median(h2d_ms) / 1e6:.2f} GB/s (pageable; {card})", flush=True)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    require(launches.get("halo_fused", 0) > 0 and launches.get("mixfir", 0) > 0,
            f"phase 22 launched no K20 or K1 ({launches})")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from srcdsp_tpu_torch import oracle
    from srcdsp_tpu_torch.chains.channelizer import design_prototype
    from srcdsp_tpu_torch.chains.psk import make_psk_params, psk_apply, psk_init
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.chains.fsk_planes import FskPlanesStream, make_timing_tone
    from srcdsp_tpu_torch.configs import (
        C3_CUTOFF, CONFIG1_SERVING, CONFIG2_ONCHIP, CONFIG3_ONCHIP, CONFIG5_ONCHIP, FFT_VARIANTS,
        build_coded_link, build_coded_modem, build_config1, build_config1_serving, build_config2,
        build_config2_onchip, build_config3_onchip, build_config5, build_config5_onchip, build_fft,
        build_ldpc, build_turbo, config2_step)
    from srcdsp_tpu_torch.dist import fused as dfused
    from srcdsp_tpu_torch.dist import halo as dhalo
    from srcdsp_tpu_torch.dist import mesh as dmesh
    from srcdsp_tpu_torch.io import framer
    from srcdsp_tpu_torch.io.capture import read_capture
    from srcdsp_tpu_torch.kernels import _build
    from srcdsp_tpu_torch.kernels import bank_pallas as kbank
    from srcdsp_tpu_torch.kernels import bcjr_pallas as kbcjr
    from srcdsp_tpu_torch.kernels import ctaps_aligned as kca
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft
    from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc
    from srcdsp_tpu_torch.kernels import fsk_ctaps as kct
    from srcdsp_tpu_torch.kernels import fsk_fused as kff
    from srcdsp_tpu_torch.kernels import fsk_preframed as kfp
    from srcdsp_tpu_torch.kernels import halo_dma as k19
    from srcdsp_tpu_torch.kernels import halo_fused as khf
    from srcdsp_tpu_torch.kernels import ldpc_pallas as kldpc
    from srcdsp_tpu_torch.kernels import mixfir as kmf
    from srcdsp_tpu_torch.kernels import mixfir_ctaps as kcm
    from srcdsp_tpu_torch.kernels import mixfir_preframed as kpf
    from srcdsp_tpu_torch.kernels import mixfir_rows as krw
    from srcdsp_tpu_torch.kernels import resample_pallas as krs
    from srcdsp_tpu_torch.kernels import resample_preframed as krp
    from srcdsp_tpu_torch.ops.channelize_planes import combined_matrix, make_channelizer_mats
    from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.planes import planes_from_int16
    from srcdsp_tpu_torch.ops.window import lowpass
    from srcdsp_tpu_torch.qcldpc import ldpc_decode_layered
    from srcdsp_tpu_torch.testing.signals import psk_wideband
    from srcdsp_tpu_torch.turbo import bcjr_decode_batch

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
    for decim in (1, 2, 4, 3):
        regs, spill, blocks = kmf.kernel_info(decim, 64, hist=128)
        print(f"[2] K1 decim {decim}{' (generic)' if decim == 3 else ''}, 64 taps: {regs} "
              f"registers, {spill} bytes of spills, {blocks} blocks per SM")
    regs, spill, blocks = kmf.kernel_info(2, 64, hist=128, halo=True)
    print(f"[2] K20 decim 2, 64 taps: {regs} registers, {spill} bytes of spills, {blocks} "
          f"blocks per SM")
    # the complex-taps (K4, K5, K17) and FSK (K2, K3, K7) rings; FSK's local
    # bytes are the 32-byte stack frame of cosf/sinf/atan2f's slow path
    for decim in (2, 4):
        for source, b16 in (("planes", False), ("planes", True), ("frames", False),
                            ("frames", True), ("split", False)):
            regs, local, blocks = kcm.kernel_info(source, decim, 64, 128, b16)
            print(f"[2] ctaps {source}{' bf16' if b16 else ''} decim {decim}, 64 taps: {regs} "
                  f"registers, {local} bytes of local memory, {blocks} blocks per SM")
            require(blocks >= 4, f"ctaps {source} decim {decim}: {blocks} blocks per SM")
        for kernel, b16 in (("fused", False), ("ctaps", False), ("ctaps", True),
                            ("preframed", False), ("preframed", True)):
            regs, local, blocks = kff.kernel_info(kernel, decim, 64, 128, OUT_TILE, SPS, b16)
            print(f"[2] fsk {kernel}{' bf16' if b16 else ''} decim {decim}, 64 taps: {regs} "
                  f"registers, {local} bytes of local memory, {blocks} blocks per SM")
            require(blocks >= 4, f"fsk {kernel} decim {decim}: {blocks} blocks per SM")
    rings = {k: v for k, v in _build.ptxas_report().items()
             if "ctaps_kernel" in k or "fsk_kernel" in k}
    spilled = [k for k, (_, st, ld) in rings.items() if st or ld]
    print(f"[2] ptxas: {len(rings) - len(spilled)} of {len(rings)} complex-taps and FSK "
          f"instantiations without spills")
    require(not spilled, f"ptxas spills in {spilled}")
    for log2n in range(8, 14):
        regs, spill, blocks = kfc.kernel_info(1 << log2n)
        print(f"[2] K11 N {1 << log2n}: {regs} registers, {spill} bytes of spills, {blocks} "
              f"blocks per SM")
    # the resampler (K8, K9) and the bank (K12, K13): no spill in any
    # instantiation; config 2's and config 5's geometry
    for frames, b16 in ((False, False), (True, False), (True, True)):
        regs, local, blocks = krs.kernel_info(3, 4, 429, 256, frames, b16)
        print(f"[2] resample {'frames' if frames else 'planes'}{' bf16' if b16 else ''} 3/4, "
              f"429 taps: {regs} registers, {local} bytes of local memory, {blocks} blocks per SM")
        require(blocks >= 2, f"resample 3/4: {blocks} blocks per SM")
    for m in (C5_CHANNELS, 128, 256, 96):
        for stats in (False, True):
            tile, regs, local, blocks = kbank.kernel_info(m, 8, C5_BK, C5_SPS, stats)
            print(f"[2] bank{'_psk' if stats else ''} M {m}: {tile} frames a tile, {regs} "
                  f"registers, {local} bytes of local memory, {blocks} blocks per SM")
    bodies = {k: v for k, v in _build.ptxas_report().items()
              if "resample_kernel" in k or "bank_kernel" in k}
    spilled = [k for k, (_, st, ld) in bodies.items() if st or ld]
    print(f"[2] ptxas: {len(bodies) - len(spilled)} of {len(bodies)} resample and bank "
          f"instantiations without spills")
    require(len(bodies) == 18 and not spilled, f"ptxas spills in {spilled}")
    # K16 (one codeword a thread, two warps meeting in the middle; ls and lp
    # staged or not) and K18 (K1's ring over the row view): no spill in any
    # instantiation
    for decim in (1, 2, 4, 3):
        regs, local, blocks = krw.kernel_info(decim, 64, 128)
        print(f"[2] K18 decim {decim}{' (generic)' if decim == 3 else ''}, 64 taps: {regs} "
              f"registers, {local} bytes of local memory, {blocks} blocks per SM")
    bodies = {k: v for k, v in _build.ptxas_report().items()
              if "bcjr_kernel" in k or "rows_kernel" in k}
    spilled = [k for k, (_, st, ld) in bodies.items() if st or ld]
    print(f"[2] ptxas: {len(bodies) - len(spilled)} of {len(bodies)} K16 and K18 "
          f"instantiations without spills")
    require(len(bodies) == 6 and not spilled, f"ptxas spills in {spilled}")
    t0 = time.perf_counter()
    framer_path = framer.build()
    print(f"[2] built {framer_path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # --- 3. kernels vs plain at the main path's shapes --------------------------
    rows = []
    record = functools.partial(record_row, torch, rows)
    cplx_err = functools.partial(complex_err, torch)
    t0 = time.perf_counter()
    bits_tx, x4, words = config4_signal(torch, dev)
    print(f"[3] config-4 signal {tuple(x4.shape)} made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    taps4 = lowpass(64, 0.03)
    taps4_d = torch.as_tensor(taps4, device=dev)
    hist = 128
    chunk0 = torch.cat([torch.zeros((C4_CHANNELS, 2, hist), device=dev),
                        x4[:, :, :C4_CHUNK]], dim=-1)

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
        return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))

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

    # K17 (history as its own operand: x1's first hist samples and the rest,
    # slices of one array; word0 0 is body sample 0's word) and K18 (mix once
    # by the factored row x lane phasor) at config-1 shape
    k17 = kca.make_ctaps_aligned_kernel(taps1_np, word1, 2, out_tile=OUT_TILE, b_rows=B_ROWS,
                                       device=dev)
    xh1, xb1 = x1[:, :hist], x1[:, hist:].view(2, -1, OUT_TILE * 2)
    y17 = k17.fn(0, xh1, xb1)
    err, rel = cplx_err(y17, kca.ctaps_aligned_plain(0, word1, xh1, xb1, g1r, g1i, 2, OUT_TILE,
                                                     hist))
    record("ctaps_aligned", "srcdsp_tpu_torch/csrc/ctaps.cu",
           "srcdsp_tpu/kernels/ctaps_aligned.py:191", err, rel, rel < 1e-5, True,
           lambda: k17.fn(0, xh1, xb1),
           lambda: kca.ctaps_aligned_plain(0, word1, xh1, xb1, g1r, g1i, 2, OUT_TILE, hist),
           y17[0].numel() * 64 * 4, tensor_bytes(x1, y17))
    k18 = krw.make_mix_fir_rows_kernel(taps1_np, 2, out_tile=OUT_TILE, b_rows=B_ROWS, device=dev)
    x3r, n3r = krw.rows_view(k18, x1)
    y18 = k18.fn(w01, word1, x3r, n=n3r)
    err, rel = cplx_err(y18, krw.mix_fir_rows_plain(w01, word1, x3r, taps1, 2, OUT_TILE, hist,
                                                    n3r))
    record("mixfir_rows", "srcdsp_tpu_torch/csrc/rows.cu",
           "srcdsp_tpu/kernels/mixfir_rows.py:190", err, rel, rel < 2e-6, True,
           lambda: k18.fn(w01, word1, x3r, n=n3r),
           lambda: krw.mix_fir_rows_plain(w01, word1, x3r, taps1, 2, OUT_TILE, hist, n3r),
           y18[0].numel() * 64 * 4, tensor_bytes(x1, y18))
    del y17, y18

    # K19 and K20 on C14_SHARDS time shards of config 1's body (x1 without its
    # history, column slices of one array) on one card: K19 moves each shard's
    # last 128 columns (K1's hist) to its right neighbour, against the torch
    # copies of dist.halo and the copy_ yardstick; K20 against its plain
    # version (the concatenation + mix_fir_plain per shard)
    mesh_row = dmesh.make_mesh(time=C14_SHARDS, devices=[dev] * C14_SHARDS)
    body1 = x1[:, hist:]
    sl1 = tuple(body1.chunk(C14_SHARDS, dim=-1))
    s14 = C1_SAMPLES // C14_SHARDS
    y19 = k19.halo_from_left_pallas(sl1, hist)
    p19 = dhalo.halo_from_left(sl1, hist)
    eq19 = all(torch.equal(a, b) for a, b in zip(y19, p19))
    out19 = [torch.empty_like(a) for a in y19]

    def copy19():
        out19[0].zero_()
        for p in range(1, C14_SHARDS):
            out19[p].copy_(sl1[p - 1][:, s14 - hist:])

    record("halo_dma", "srcdsp_tpu_torch/csrc/halo.cu", "srcdsp_tpu/kernels/halo_dma.py:77",
           0.0 if eq19 else float("inf"), 0.0, eq19, True,
           lambda: k19.halo_from_left_pallas(sl1, hist),
           lambda: dhalo.halo_from_left(sl1, hist), 0,
           (2 * C14_SHARDS - 1) * 2 * hist * 4, copy19, per_call=1)  # one launch per card
    k20 = khf.make_halo_fused_kernel(taps1_np, 2, out_tile=OUT_TILE, b_rows=B_ROWS, device=dev)
    tail14 = torch.zeros((2, hist), device=dev)
    _, y20 = khf.mix_fir_halo_sharded(k20, 0, word1, tail14, sl1, mesh_row)

    def plain20():
        return tuple(khf.halo_fused_plain(
            dfused.shard_word(0, word1, p, s14, hist), word1,
            tail14 if p == 0 else sl1[p - 1][:, s14 - hist:], x, taps1, 2, OUT_TILE, hist)
            for p, x in enumerate(sl1))

    err, rel = cplx_err(torch.cat(y20, dim=-1), torch.cat(plain20(), dim=-1))
    record("halo_fused", "srcdsp_tpu_torch/csrc/mixfir.cu",
           "srcdsp_tpu/kernels/halo_fused.py:169", err, rel, rel < 1e-5, True,
           lambda: khf.mix_fir_halo_sharded(k20, 0, word1, tail14, sl1, mesh_row), plain20,
           C1_SAMPLES // 2 * 64 * 4, tensor_bytes(body1, y20), per_call=C14_SHARDS)
    del y19, p19, out19, y20

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

    # K10 at the FFT cell's shape, in its three output orders; the library call
    # is cuFFT on a prebuilt complex64 copy of the same frames (natural order)
    t0 = time.perf_counter()
    bfft = build_fft(FFT_BATCH, FFT_N, "kernel", device=dev)
    fxr, fxi = bfft.example
    print(f"[3] FFT input 2 x {tuple(fxr.shape)} made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    fxc = torch.complex(fxr, fxi)
    fft_flops = bfft.meta["flops_5nlogn"]
    fft_bytes = 2 * tensor_bytes(fxr, fxi)
    fft_out = {}
    for name, order, site in (("fft", True, "fft_pallas.py:201"),
                              ("fft_digit", False, "fft_pallas.py:201"),
                              ("fft_nat", "kernel", "fft_pallas.py:241")):
        kf = kfft.make_fft_kernel(FFT_N, b_frames=16, natural_order=order, device=dev)

        def fft_plain(kf=kf, order=order):
            pr, pi = kfft.fft_rows_plain(fxr.reshape(-1, kf.n2), fxi.reshape(-1, kf.n2),
                                         kf.consts, kf.n1, kf.n2)
            if order is False:
                return pr, pi
            return kfft.unscramble(pr, kf.n1, kf.n2), kfft.unscramble(pi, kf.n1, kf.n2)

        yf = kf.fn(fxr, fxi)
        err, rel = cplx_err(yf, fft_plain())
        record(name, "srcdsp_tpu_torch/csrc/fft.cu", "srcdsp_tpu/kernels/" + site, err, rel,
               rel < 1e-5, True, lambda kf=kf: kf.fn(fxr, fxi), fft_plain, fft_flops, fft_bytes,
               lambda: torch.fft.fft(fxc, dim=-1))
        r10 = rows[-1]
        print(f"    {name}: {r10['ms'] / r10['library_ms']:.3f} x cuFFT's time, "
              f"{r10['bound_ms'] / r10['ms']:.3f} of the {r10['bound_ms']:.4f} ms bound",
              flush=True)
        fft_out[name] = (yf, kf)
    nat = fft_out["fft"][0]
    kd = fft_out["fft_digit"][1]
    # natural_order=True stores natural order itself: the digit-order
    # unscramble (a torch transpose) must not run
    unscramble = kfft.unscramble

    def no_transpose(*args):
        raise SmokeFailure("fft: natural_order=True ran the unscramble transpose")

    kfft.unscramble = no_transpose
    try:
        nat_again = fft_out["fft"][1].fn(fxr, fxi)
    finally:
        kfft.unscramble = unscramble
    require(same(nat_again, nat), "fft: natural_order=True differs between two calls")
    occ = kfft.fft_occupancy(FFT_N)
    print(f"    fft: natural_order=True ran no transpose; {occ} resident blocks per SM at "
          f"N = {FFT_N} (floor 4)", flush=True)
    require(occ >= 4, f"fft: {occ} blocks per SM at N = {FFT_N}")
    del nat_again
    require(same(nat, fft_out["fft_nat"][0]), "fft_nat: kernel-natural store != natural")
    require(same(nat, tuple(kfft.unscramble(y, kd.n1, kd.n2) for y in fft_out["fft_digit"][0])),
            "fft: digit store + unscramble != natural store (torch.equal)")
    ref = torch.fft.fft(torch.complex(fxr[:FFT_SNR_FRAMES].double(),
                                      fxi[:FFT_SNR_FRAMES].double()), dim=-1)
    snr = snr_db(torch, ref, torch.complex(nat[0][:FFT_SNR_FRAMES],
                                           nat[1][:FFT_SNR_FRAMES]).to(torch.complex128))
    print(f"    fft == fft_nat == unscrambled fft_digit: torch.equal True; K10 SNR {snr:.2f} dB "
          f"against torch.fft in complex128 on {FFT_SNR_FRAMES} frames (floor 110)", flush=True)
    require(snr > 110.0, f"fft: SNR {snr} dB against complex128")
    del bfft, fxr, fxi, fxc, fft_out, nat, kd, ref, yf, kf

    # K11 on one config-3 chunk (16 x 1,671,168), shared and per-channel taps; the
    # library call is one cuDNN conv1d over the 32 real planes with the flipped
    # taps (TF32 off: pin_f32 at the top of main), the same causal FIR
    t0 = time.perf_counter()
    c3 = build_config3_onchip(C3_SAMPLES, "fused", channels=C3_CHANNELS, device=dev)
    x3 = c3.example[0]
    k11 = c3.meta["kernel"]
    ov3, hop3 = k11.overlap, k11.hop
    require((ov3, hop3, k11.block_in()) == (1024, 3072, 49152)
            and x3.shape[-1] == ov3 + C3_SAMPLES, f"config-3 planes {tuple(x3.shape)}")
    print(f"[3] config-3 planes {tuple(x3.shape)} made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    taps3 = lowpass(1024, C3_CUTOFF)
    taps3_pc = np.stack([lowpass(1024, 0.05 + 0.005 * c) for c in range(C3_CHANNELS)])
    fft3 = make_fft_planes(4096, device=dev)
    chunk3 = x3[..., :ov3 + C3_CHUNK].contiguous()
    frames3 = C3_CHANNELS * C3_CHUNK // hop3
    fc_flops = frames3 * (2 * 5 * 4096 * 12 + 6 * 4096)
    for name, taps_k in (("fftconv", taps3), ("fftconv_per_channel", taps3_pc)):
        kc = kfc.make_fftconv_kernel(taps_k, 4096, num_channels=C3_CHANNELS, b_frames=16,
                                     karatsuba=True, device=dev)
        hresp = torch.as_tensor(kfc.freq_response_planes(taps_k, 4096), device=dev)
        wflip = torch.as_tensor(np.ascontiguousarray(np.atleast_2d(taps_k)[:, ::-1]),
                                dtype=torch.float32, device=dev)
        w = wflip.repeat_interleave(2, dim=0)[:, None] if taps_k.ndim == 2 else wflip[None]
        groups = 2 * C3_CHANNELS if taps_k.ndim == 2 else 1
        xin = chunk3.reshape(1, 2 * C3_CHANNELS, -1) if groups > 1 else chunk3.reshape(
            2 * C3_CHANNELS, 1, -1)
        yc = kfc.fftconv_pallas(kc, chunk3)
        err, rel = cplx_err(yc, kfc.fftconv_plain(chunk3, hresp, fft3, 4096, hop3))
        record(name, "srcdsp_tpu_torch/csrc/fftconv.cu",
               "srcdsp_tpu/kernels/fftconv_pallas.py:361", err, rel, rel < 1e-5, True,
               lambda kc=kc: kfc.fftconv_pallas(kc, chunk3),
               lambda hresp=hresp: kfc.fftconv_plain(chunk3, hresp, fft3, 4096, hop3), fc_flops,
               tensor_bytes(chunk3, yc),
               lambda w=w, xin=xin, groups=groups: torch.nn.functional.conv1d(
                   xin, w, groups=groups))
        # the conv1d yardstick computes the same outputs (its sample j is y[j - 1])
        lib = torch.nn.functional.conv1d(xin, w, groups=groups).reshape(C3_CHANNELS, 2, -1)
        lib_snr = snr_db(torch, torch.complex(lib[:, 0, 1:], lib[:, 1, 1:]), torch.complex(*yc))
        print(f"    {name}: SNR {lib_snr:.2f} dB against the cuDNN conv1d yardstick", flush=True)
        require(lib_snr > 100.0, f"{name}: SNR {lib_snr} dB against conv1d")
        del yc, lib, hresp, w, xin
    del chunk3

    # K12 and K13 at the config-5 shape: the bench's seed-0 phase-major planes
    # [2, 64, 128 + 2^19], b_k 512. The library yardstick is one cuBLAS matmul
    # of E_comb^T [128, 1152] by SS^T [1152, 2^19] staged beforehand (TF32
    # off), the TPU kernel's dense form, without the staging; for K13 it is
    # that matmul followed by the plain stats epilogue and lane permutation
    t0 = time.perf_counter()
    c5 = build_config5_onchip(C5_FRAMES, "fused", C5_CHANNELS, C5_BK, device=dev)
    xp5, hc5 = c5.example[0], c5.meta["hist_cols"]
    require(hc5 == 128 and tuple(xp5.shape) == (2, C5_CHANNELS, hc5 + C5_FRAMES),
            f"config-5 planes {tuple(xp5.shape)}")
    print(f"[3] config-5 planes {tuple(xp5.shape)} made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    proto5 = design_prototype(C5_CHANNELS, 8)
    p5 = len(proto5) // C5_CHANNELS
    e5_t = torch.as_tensor(combined_matrix(*make_channelizer_mats(proto5, C5_CHANNELS)).T.copy(),
                           device=dev)
    k12, _ = kbank.make_bank_kernel(proto5, C5_CHANNELS, b_k=C5_BK, device=dev)
    k13, _ = kbank.make_bank_psk_kernel(proto5, C5_CHANNELS, sps=C5_SPS, order=C5_ORDER,
                                        b_k=C5_BK, device=dev)
    k13c = c5.meta["kernel"]
    perm5 = kbank.class_major_index(C5_BK, C5_SPS, dev)
    ss5 = torch.cat([xp5[pl, :, hc5 - r:hc5 - r + C5_FRAMES] for pl in range(2)
                     for r in range(p5 + 1)], dim=0)
    # least work: the fold (4PM) and an M-point FFT (5 M log2 M) per frame; K13
    # adds about 19 flop per output sample for its sums
    bank_flops = C5_FRAMES * (4 * p5 * C5_CHANNELS + 5 * C5_CHANNELS * np.log2(C5_CHANNELS))

    def stats13(y):
        st = kbank.bank_stats_plain(y, C5_CHANNELS, C5_BK, C5_SPS, C5_ORDER)
        return y.reshape(2 * C5_CHANNELS, -1, C5_BK)[..., perm5].reshape(y.shape), st

    def plain13():
        return stats13(kbank.bank_plain(xp5, e5_t, C5_CHANNELS, p5 + 1, hc5))

    y12 = k12(xp5)
    y13, st13 = k13(xp5)
    y13c, st13c = k13c(xp5)
    require(torch.equal(y13, y12), "bank_psk: K13's Y != K12's (torch.equal)")
    require(torch.equal(st13c, st13), "bank_psk: class-major stats != standard stats")
    require(torch.equal(y13c, y12.reshape(2 * C5_CHANNELS, -1, C5_BK)[..., perm5]
                        .reshape(y12.shape)), "bank_psk: class-major != standard permuted")
    print("    bank_psk Y == bank Y, class-major == standard permuted, stats equal: "
          "torch.equal True", flush=True)
    for name, site, k_fn, p_fn, lib_fn, out in (
            ("bank", "bank_pallas.py:234", lambda: k12(xp5),
             lambda: kbank.bank_plain(xp5, e5_t, C5_CHANNELS, p5 + 1, hc5),
             lambda: e5_t @ ss5, (y12,)),
            ("bank_psk", "bank_pallas.py:360", lambda: k13c(xp5), plain13,
             lambda: stats13(e5_t @ ss5), (y13c, st13c))):
        ref = p_fn()
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = float(torch.max(torch.abs(out[0] - ref[0])))
        rel = float(torch.linalg.norm(out[0] - ref[0]) / torch.linalg.norm(ref[0]))
        ok = rel < 1e-5
        if len(out) > 1:
            st_rel = float(torch.linalg.norm(out[1] - ref[1]) / torch.linalg.norm(ref[1]))
            print(f"    {name}: stats rel L2 {st_rel:.3e} against the plain epilogue (floor 1e-5)")
            ok = ok and st_rel < 1e-5
        flops = bank_flops + (19 * C5_CHANNELS * C5_FRAMES if len(out) > 1 else 0)
        record(name, "srcdsp_tpu_torch/csrc/bank.cu", "srcdsp_tpu/kernels/" + site, err, rel, ok,
               True, k_fn, p_fn, flops, tensor_bytes(xp5, out), lib_fn)
        del ref
    del ss5, y12, y13, st13, y13c, st13c

    # K12 and K13 above 64 channels: M = 128 (FFT radix 8, 8, 2) and M = 96
    # (not a power of two: the direct DFT), 2^15 frames, against their plain
    # versions (rel L2 1e-5 on Y and the stats), K13's Y == K12's
    for m in (128, 96):
        proto_m = design_prototype(m, 8)
        k12m, hcm = kbank.make_bank_kernel(proto_m, m, b_k=C5_BK, device=dev)
        k13m, _ = kbank.make_bank_psk_kernel(proto_m, m, sps=C5_SPS, order=C5_ORDER, b_k=C5_BK,
                                            device=dev)
        xm = torch.randn((2, m, hcm + (1 << 15)), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(m))
        ym, (y13m, stm) = k12m(xm), k13m(xm)
        em = torch.as_tensor(combined_matrix(*make_channelizer_mats(proto_m, m)).T.copy(),
                             device=dev)
        pm = kbank.bank_plain(xm, em, m, len(proto_m) // m + 1, hcm)
        pst = kbank.bank_stats_plain(pm, m, C5_BK, C5_SPS, C5_ORDER)
        rel_y = float(torch.linalg.norm(ym - pm) / torch.linalg.norm(pm))
        rel_s = float(torch.linalg.norm(stm - pst) / torch.linalg.norm(pst))
        print(f"    bank M {m}: Y rel L2 {rel_y:.3e}, bank_psk stats rel L2 {rel_s:.3e} against "
              f"the plain versions (floor 1e-5); K13's Y == K12's: {torch.equal(y13m, ym)}",
              flush=True)
        require(rel_y < 1e-5 and rel_s < 1e-5, f"bank M {m}: rel L2 {rel_y} / {rel_s}")
        require(torch.equal(y13m, ym), f"bank_psk M {m}: K13's Y != K12's (torch.equal)")
        del xm, ym, y13m, stm, em, pm, pst

    # K14, K15 and K16 at the coded tier's shapes: K14 on build_ldpc("edges")'s
    # LLRs [504, 1024] (10 iterations), K15 on build_ldpc("qc")'s [1536, 4096]
    # (41 circulants, 6 iterations), K16 on the turbo's first half [515, 256]
    # (terminated); each torch.equal to its plain version. Least work:
    # MINSUM_OPS per edge and iteration, BCJR_OPS per state and step
    t0 = time.perf_counter()
    led = build_ldpc("edges", C12_EDGES_BATCH, device=dev)
    lqc = build_ldpc("qc", C12_QC_BATCH, device=dev)
    trb = build_turbo(C12_TURBO_T, batch=C12_TURBO_BATCH, layout="kernel", device=dev)
    print(f"[3] coded-tier codes and LLRs made in {time.perf_counter() - t0:.1f} s", flush=True)
    ep, qp, rsc = led.meta["plan"], lqc.meta["plan"], trb.meta["tc"].rsc
    llr14, llr15 = led.example[0].T.contiguous(), lqc.example[0].T.contiguous()
    ls16, lp16 = trb.example[0].T.contiguous(), trb.example[1].T.contiguous()
    k14 = kldpc.make_ldpc_kernel(ep, iters=10, device=dev)
    k15 = kldpc.make_qc_kernel(qp, iters=6, device=dev)
    k16 = kbcjr.make_bcjr_kernel(rsc, ls16.shape[0], True, b_tile=min(128, ls16.shape[1]),
                                 device=dev)
    for name, src, site, k_fn, p_fn, flops, ins in (
            ("ldpc_edges", "ldpc.cu", "ldpc_pallas.py:297", lambda: k14(llr14),
             lambda: kldpc.ldpc_decode_edges_ref(ep, llr14, 10),
             MINSUM_OPS * int(ep.row_valid.sum()) * 10 * llr14.shape[1], (llr14,)),
            ("ldpc_qc", "ldpc.cu", "ldpc_pallas.py:527", lambda: k15(llr15),
             lambda: kldpc.qc_decode_layered_ref(qp, llr15, 6),
             MINSUM_OPS * qp.n_blocks * qp.z * 6 * llr15.shape[1], (llr15,)),
            ("bcjr", "bcjr.cu", "bcjr_pallas.py:175", lambda: k16(ls16, lp16),
             lambda: bcjr_decode_batch(rsc, ls16, lp16, terminated=True)[0],
             BCJR_OPS * 8 * ls16.numel(), (ls16, lp16))):
        out, ref = k_fn(), p_fn()
        eq = bool(torch.equal(out, ref))
        err = float(torch.max(torch.abs(out - ref)))
        rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        print(f"    {name}: kernel == plain (torch.equal): {eq}", flush=True)
        record(name, "srcdsp_tpu_torch/csrc/" + src, "srcdsp_tpu/kernels/" + site, err, rel, eq,
               bool(torch.equal(out < 0, ref < 0)), k_fn, p_fn, flops, tensor_bytes(ins, out))
        del out, ref
    del llr14, llr15, ls16, lp16

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

    # --- 9. the FFT (main path) ------------------------------------------------
    fft_bound_ms, _ = roofline_ms(5 * FFT_N * np.log2(FFT_N) * FFT_BATCH,
                                  4 * FFT_BATCH * FFT_N * 4)
    for variant in FFT_VARIANTS:
        b = build_fft(FFT_BATCH, FFT_N, variant, device=dev)
        ms = median_ms(torch, lambda: b.step(*b.example))
        yr, yi = b.step(*b.example)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()),
                f"fft {variant} not finite")
        print(f"[9] fft {variant}: {b.meta['batch']} x {FFT_N} in {ms:.3f} ms median, "
              f"{b.meta['flops_5nlogn'] / ms / 1e6:.1f} GFLOP/s (5 N log2 N), "
              f"{fft_bound_ms / ms:.3f} of the {fft_bound_ms:.4f} ms bound", flush=True)
        if variant == "kernel":
            kf = b.meta["kernel"]
            rr, ri = kfft.ifft_pallas(kf, yr, yi)
            snr_r = snr_db(torch, b.example[0], rr)
            snr_i = snr_db(torch, b.example[1], ri)
            print(f"    inverse round trip (conj -> K10 -> conj, 1/N): SNR {snr_r:.2f} / "
                  f"{snr_i:.2f} dB (floor 110)", flush=True)
            require(min(snr_r, snr_i) > 110.0, f"fft round trip: SNR {snr_r}, {snr_i} dB")
            del rr, ri
        del b, yr, yi
    # the three K10 variants and cuFFT on the same frames, in turns
    steps = {v: build_fft(FFT_BATCH, FFT_N, v, device=dev) for v in FFT_VARIANTS[:3]}
    fx = steps["kernel"].example
    fxc = torch.complex(*fx)
    fns = {v: (lambda b=b: b.step(*fx)) for v, b in steps.items()}
    fns["cuFFT"] = lambda: torch.fft.fft(fxc, dim=-1)
    for calls in (1, REPS):
        t = {k: float(np.median(v))
             for k, v in in_turns(torch, fns, 2 * REPS, calls=calls).items()}
        print(f"[9] in turns ({2 * REPS} turns of {calls} call(s) back to back, CUDA events, "
              f"per call): " + ", ".join(
                  f"{k} {v:.4f} ms ({v / t['cuFFT']:.3f} x cuFFT, {fft_bound_ms / v:.3f} of the "
                  f"bound)" for k, v in t.items()), flush=True)
    del steps, fx, fxc, fns

    # --- 10. config 3 (main path) ---------------------------------------------
    torch.cuda.synchronize()
    t = time.perf_counter()
    one = c3.step(x3)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    st3 = kfc.FftConvStream(k11)
    chunks3 = [x3[..., ov3 + i * C3_CHUNK:ov3 + (i + 1) * C3_CHUNK] for i in range(C3_CHUNKS)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    parts = [st3.process(ch) for ch in chunks3]
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t
    chunked = tuple(torch.cat([p[j] for p in parts], dim=-1) for j in range(2))
    require(same(chunked, one), "config 3: 5 streamed chunks != one launch (torch.equal)")
    del parts, chunked
    cat_ms = median_ms(torch, lambda: torch.cat([st3.hist, chunks3[0]], dim=-1))
    total3 = C3_CHANNELS * C3_SAMPLES
    print(f"[10] config 3 K11: {C3_CHANNELS} ch x {C3_SAMPLES} samples, one launch "
          f"{one_s * 1e3:.3f} ms (first call), {C3_CHUNKS} chunks of {C3_CHUNK} through "
          f"FftConvStream {chunk_s * 1e3:.3f} ms ({total3 / chunk_s / 1e6:.1f} Ms/s), of which "
          f"the history concat {cat_ms:.3f} ms per chunk (median); chunked == one launch: "
          f"torch.equal True", flush=True)
    h2s = torch.as_tensor(kfc.freq_response_planes(taps3, 4096), device=dev)
    t = time.perf_counter()
    pr, pi = kfc.fftconv_plain(x3, h2s, fft3, 4096, hop3)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    y3 = torch.complex(*one)
    snr_plain = snr_db(torch, torch.complex(pr, pi), y3)
    del pr, pi
    snr_or = []
    for c in (0, C3_CHANNELS - 1):
        xc = torch.complex(x3[c, 0, ov3:ov3 + C3_ORACLE_SAMPLES],
                           x3[c, 1, ov3:ov3 + C3_ORACLE_SAMPLES]).cpu().numpy()
        snr_or.append(snr_db(torch, torch.from_numpy(oracle.fir(xc, taps3)),
                             y3[c, :C3_ORACLE_SAMPLES].cpu()))
    print(f"    config 3 against the plain K11 on the card ({plain_s * 1e3:.1f} ms): SNR "
          f"{snr_plain:.2f} dB (floor 100); first {C3_ORACLE_SAMPLES} samples of channels 0 "
          f"and {C3_CHANNELS - 1} against the C++ oracle's direct FIR: SNR "
          f"{snr_or[0]:.2f} / {snr_or[1]:.2f} dB (floor 90)", flush=True)
    require(snr_plain > 100.0, f"config 3: SNR {snr_plain} dB against the plain K11")
    require(min(snr_or) > 90.0, f"config 3: SNR {snr_or} dB against the oracle")
    del one, chunks3, st3
    outs = {}
    for variant in CONFIG3_ONCHIP:
        b = c3 if variant == "fused" else build_config3_onchip(C3_SAMPLES, variant,
                                                                channels=C3_CHANNELS, device=dev)
        ms = median_ms(torch, lambda: b.step(*b.example))
        yr, yi = b.step(*b.example)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(yr).all() and torch.isfinite(yi).all()),
                f"config 3 {variant} not finite")
        n3 = b.samples_per_call // C3_CHANNELS
        agg = b.samples_per_call / ms / 1e3
        gflops = (agg * 1e6 / b.meta["hop"]) * 2 * 5 * 4096 * 12 / 1e9
        outs[variant] = torch.complex(yr, yi)
        print(f"[10] config 3 {variant}: {C3_CHANNELS} ch x {n3} samples (hop "
              f"{b.meta['hop']}) in {ms:.3f} ms median, {agg:.1f} Ms/s aggregate, "
              f"{gflops:.1f} GFLOP/s (5 N log2 N, forward + inverse per hop)", flush=True)
        del b, yr, yi
    require(torch.equal(outs["fused_per_channel"], outs["fused"]),
            "config 3: fused_per_channel != fused (torch.equal)")
    snr_planes = snr_db(torch, outs["fused"], outs["planes"][:, :C3_SAMPLES])
    print(f"    fused_per_channel == fused (torch.equal); planes (hop 2048) SNR "
          f"{snr_planes:.2f} dB against fused on the common {C3_SAMPLES} samples (floor 100)",
          flush=True)
    require(snr_planes > 100.0, f"config 3 planes: SNR {snr_planes} dB")
    del outs, c3, x3, y3

    # --- 11. config 5 (main path) ---------------------------------------------
    n5 = C5_FRAMES * C5_CHANNELS
    steps5 = {}
    for variant in CONFIG5_ONCHIP:
        # fused_std and bank run on the fused variant's input (the bench's seed-0
        # planes); planes makes its own flat seed-0 planes, as the bench does
        b = c5 if variant == "fused" else build_config5_onchip(
            C5_FRAMES if variant == "planes" else C5_BK, variant, C5_CHANNELS, C5_BK, device=dev)
        args = b.example if variant == "planes" else (xp5,)
        ms = median_ms(torch, lambda: b.step(*args))
        _, (idx, (sr, si)) = b.step(*args)
        torch.cuda.synchronize()
        require(tuple(idx.shape) == (C5_CHANNELS, C5_FRAMES // C5_SPS),
                f"config 5 {variant}: indices {tuple(idx.shape)}")
        require(bool(torch.isfinite(sr).all() and torch.isfinite(si).all()),
                f"config 5 {variant} not finite")
        print(f"[11] config 5 {variant}: {C5_CHANNELS} ch x {C5_FRAMES} frames ({n5} wideband "
              f"samples) in {ms:.3f} ms median, {n5 / ms / 1e3:.1f} Ms/s wideband", flush=True)
        steps5[variant] = b.step
        del b, idx, sr, si
    kfn5 = c5.meta["kernel"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    one = kfn5(xp5)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    q5 = C5_FRAMES // C5_CHUNKS
    chunks5 = [xp5[..., i * q5:i * q5 + hc5 + q5].contiguous() for i in range(C5_CHUNKS)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    parts = [kfn5(ch) for ch in chunks5]
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t
    require(torch.equal(torch.cat([p[0] for p in parts], dim=-1), one[0])
            and torch.equal(torch.cat([p[1] for p in parts], dim=0), one[1]),
            "config 5: K13 in 4 chunks != one launch (torch.equal)")
    print(f"[11] config 5 K13 class-major: one launch {one_s * 1e3:.3f} ms, {C5_CHUNKS} chunks "
          f"of {q5} frames with {hc5} history columns {chunk_s * 1e3:.3f} ms (host clock); "
          f"chunked Y and stats == one launch: torch.equal True", flush=True)
    del one, parts, chunks5, xp5, c5

    t0 = time.perf_counter()
    data5, protom, wb = psk_wideband(np.random.default_rng(5), C5_CHANNELS, C5_NSYM, C5_ORDER,
                                     C5_SPS, device=dev)
    torch.cuda.synchronize()
    flat = torch.cat([torch.zeros((2, hc5 * C5_CHANNELS), device=dev),
                      torch.stack([wb.real, wb.imag])], dim=-1)
    xpm = kbank.phase_major(flat, C5_CHANNELS, hc5)
    print(f"[11] modulated QPSK wideband {tuple(wb.shape)} ({C5_CHANNELS} ch x {C5_NSYM} symbols, "
          f"sps {C5_SPS}) synthesized on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    decided = {}
    for variant in ("fused", "fused_std", "bank"):
        _, (idx, _) = steps5[variant](xpm)
        decided[variant] = idx
        ser = ser_per_channel(data5, idx.cpu().numpy(), C5_ORDER)
        print(f"    {variant}: max SER {ser.max()} over {C5_CHANNELS} channels after diff_decode",
              flush=True)
        require(bool(np.all(ser == 0.0)), f"config 5 {variant}: SER {ser}")
    require(torch.equal(decided["fused"], decided["fused_std"]),
            "config 5: fused indices != fused_std indices")
    y = k12(xpm)
    ref = torch.from_numpy(oracle.channelize(wb[:C5_ORACLE_SAMPLES].cpu().numpy(), protom,
                                             C5_CHANNELS))
    nf = C5_ORACLE_SAMPLES // C5_CHANNELS
    snr_o = snr_db(torch, ref, torch.complex(y[:C5_CHANNELS, :nf], y[C5_CHANNELS:, :nf]).cpu())
    print(f"    fused == fused_std indices (torch.equal); K12 against the C++ oracle's channelize "
          f"on the first {C5_ORACLE_SAMPLES} samples: SNR {snr_o:.2f} dB (floor 100)", flush=True)
    require(snr_o > 100.0, f"config 5: K12 SNR {snr_o} dB against the oracle")
    del decided, y, ref, flat, xpm, wb

    fix = REPO / "tests" / "fixtures"
    xf, _ = read_capture(str(fix / "chan_8x128.ci16"))
    hf = np.load(fix / "chan_8x128_proto.npy")
    gold = np.load(fix / "chan_8x128_gold.npy")
    kf8, hcf = kbank.make_bank_kernel(hf, 8, b_k=128, device=dev)
    flat = np.zeros((2, (hcf + gold.shape[1]) * 8), np.float32)
    flat[0, hcf * 8:], flat[1, hcf * 8:] = xf.real, xf.imag
    yf = kf8(kbank.phase_major(torch.as_tensor(flat, device=dev), 8, hcf)).cpu()
    snr_f = snr_db(torch, torch.from_numpy(gold), torch.complex(yf[:8], yf[8:]))
    meta = json.loads((fix / "qpsk_256sym.fixture.json").read_text())
    xq, _ = read_capture(str(fix / "qpsk_256sym.ci16"))
    pq = make_psk_params(meta["center"], decim=meta["decim"], sps=meta["sps"],
                         order=meta["order"], device=dev)
    _, (iq5, _) = psk_apply(pq, psk_init(pq), torch.as_tensor(np.ascontiguousarray(xq), device=dev))
    gq = np.load(fix / "qpsk_256sym_gold_idx.npy")
    print(f"    chan_8x128 through K12: SNR {snr_f:.2f} dB against its gold (floor 100); "
          f"qpsk_256sym through psk_apply on the card: {gq.size} indices equal to the gold: "
          f"{np.array_equal(iq5.cpu().numpy(), gq)}", flush=True)
    require(snr_f > 100.0, f"chan_8x128: SNR {snr_f} dB against the gold")
    require(np.array_equal(iq5.cpu().numpy(), gq), "qpsk_256sym: indices differ from the gold")

    b = build_config5(C5_COMPLEX_FRAMES, C5_CHANNELS, device=dev)
    ms = median_ms(torch, lambda: b.step(*b.example))
    idx, soft = b.step(*b.example)
    torch.cuda.synchronize()
    require(tuple(idx.shape) == (C5_CHANNELS, C5_COMPLEX_FRAMES // C5_SPS)
            and bool(torch.isfinite(torch.view_as_real(soft)).all()),
            f"config 5 complex tier: {tuple(idx.shape)} or not finite")
    print(f"[11] config 5 complex tier (channelize_full + psk_apply): {b.samples_per_call} "
          f"samples in {ms:.3f} ms median, {b.samples_per_call / ms / 1e3:.1f} Ms/s wideband",
          flush=True)
    del b, idx, soft

    # --- 12. the coded tier (main paths) ------------------------------------------
    t0 = time.perf_counter()
    cm = build_coded_modem(C12_MODEM_CHANNELS, C12_MODEM_WORDS, device=dev)
    planes = cm.example[0]
    torch.cuda.synchronize()
    b12, n12, k12b = cm.meta["channels"] * cm.meta["words"], cm.meta["n"], cm.meta["k"]
    print(f"[12] coded modem: planes {tuple(planes.shape)} (QAM{cm.meta['order']}, {b12} "
          f"codewords of n {n12}) made on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the front end's K1 mc (33 RRC taps, decim 2, 8 channels) against its
    # plain version on the modem's own planes; this comparison launch is not
    # counted as a main-path launch
    mm = cm.meta
    kfront = kmf.make_mix_fir_kernel_mc(mm["taps"], mm["sps"], mm["channels"],
                                        out_tile=mm["out_tile"], b_rows=mm["b_rows"], device=dev)
    w0m = [(-kfront.hist * int(w)) % (1 << 32) for w in mm["dwords"]]
    held = _build.LAUNCHES["mixfir_mc"]
    err, rel = cplx_err(kfront.fn(w0m, mm["dwords"], planes),
                        kmf.mix_fir_plain(w0m, mm["dwords"], planes,
                                          torch.as_tensor(mm["taps"], device=dev), mm["sps"],
                                          mm["out_tile"], kfront.hist))
    _build.LAUNCHES["mixfir_mc"] = held
    print(f"    modem front end: K1 mc ({kfront.num_taps} taps, decim {mm['sps']}) against "
          f"mix_fir_plain on the modem's planes: max_abs_err {err:.3e} rel_l2 {rel:.3e} "
          f"(floor 1e-5)", flush=True)
    require(rel < 1e-5, f"coded modem front end: K1 mc rel L2 {rel} against its plain version")
    del kfront
    bits_t, ok = cm.step(planes)
    torch.cuda.synchronize()
    same_cw = bool(torch.equal(bits_t.T, cm.meta["cw"]))
    ms = median_ms(torch, lambda: cm.step(planes))
    print(f"[12] coded modem (K1 mc -> plane demap -> K15, {cm.meta['iters']} iterations): ok "
          f"fraction {float(ok.to(torch.float32).mean())}, decoded == transmitted: {same_cw}; "
          f"{ms:.3f} ms per call, {cm.samples_per_call / ms / 1e3:.1f} Ms/s aggregate, "
          f"{b12 * n12 / ms / 1e3:.1f} Mb/s coded, {b12 * k12b / ms / 1e3:.1f} Mb/s info",
          flush=True)
    require(bool(ok.all()), "coded modem: a syndrome failed")
    require(same_cw, "coded modem: decoded codewords differ from the transmitted ones")
    del cm, planes, bits_t, ok

    t0 = time.perf_counter()
    cl = build_coded_link(C12_LINK_CHANNELS, C12_LINK_WORDS, device=dev)
    torch.cuda.synchronize()
    print(f"[12] coded link: planes {tuple(cl.example[0].shape)} made in "
          f"{time.perf_counter() - t0:.1f} s; lag {cl.meta['lag']}, raw BER "
          f"{cl.meta['raw_ber']}", flush=True)
    bits, info, ok = cl.step(*cl.example)
    torch.cuda.synchronize()
    info_ber = float((info.reshape(cl.meta["u"].shape) != cl.meta["u"]).to(torch.float32).mean())
    ok_frac = float(ok.to(torch.float32).mean())
    ms = median_ms(torch, lambda: cl.step(*cl.example))
    nb12 = cl.meta["channels"] * cl.meta["words"]
    print(f"[12] coded link (K2 -> K14, {cl.meta['iters']} iterations): info BER {info_ber}, ok "
          f"fraction {ok_frac}; {ms:.3f} ms per call, {cl.samples_per_call / ms / 1e3:.1f} Ms/s "
          f"aggregate, {nb12 * cl.meta['n'] / ms / 1e3:.1f} Mb/s coded", flush=True)
    require(info_ber == 0.0 and ok_frac == 1.0, f"coded link: info BER {info_ber}, ok {ok_frac}")
    del cl, bits, info, ok

    llr_q = lqc.example[0]
    bits, _, ok = lqc.step(llr_q)
    ms = median_ms(torch, lambda: lqc.step(llr_q))
    dense = [ldpc_decode_layered(lqc.meta["code"], llr_q[i:i + C12_DENSE_CHUNK], z=qp.z, iters=6)
             for i in range(0, C12_QC_BATCH, C12_DENSE_CHUNK)]
    d_bits = torch.cat([d[0] for d in dense])
    both = ok & torch.cat([d[2] for d in dense])
    print(f"[12] QC decoder alone (K15, {C12_QC_BATCH} x n {qp.nb * qp.z}, 6 iterations): "
          f"{ms:.3f} ms per call, {C12_QC_BATCH * qp.nb * qp.z / ms / 1e6:.3f} Gb/s coded; ok "
          f"fraction {float(ok.to(torch.float32).mean())}; decisions equal to the dense layered "
          f"tier on the {int(both.sum())} words both converge: "
          f"{bool(torch.equal(bits[both], d_bits[both]))} (all words equal: "
          f"{bool(torch.equal(bits, d_bits))})", flush=True)
    require(float(both.to(torch.float32).mean()) > 0.9, "QC decoder: fewer than 90 % converged")
    require(bool(torch.equal(bits[both], d_bits[both])), "QC decoder: decisions differ from dense")
    require(bool(torch.equal(bits[ok], lqc.meta["cw"][ok])), "QC decoder: ok words != sent")
    del lqc, llr_q, bits, ok, dense, d_bits, both

    plain = build_turbo(C12_TURBO_T, batch=C12_TURBO_BATCH, layout="batch", device=dev)
    bits, post = trb.step(*trb.example)
    pbits, ppost = plain.step(*trb.example)
    same = bool(torch.equal(bits, pbits) and torch.equal(post, ppost))
    ber = float((bits != trb.meta["u"]).to(torch.float32).mean())
    ms = median_ms(torch, lambda: trb.step(*trb.example))
    nt = trb.meta["u"].shape[0]
    print(f"[12] turbo (K16, t {trb.meta['u'].shape[1]}, {trb.meta['iters']} iterations, B {nt}): "
          f"bits and posteriors == turbo_decode_batch (torch.equal): {same}; BER {ber}; "
          f"{ms:.3f} ms per call, {nt * trb.meta['n_coded'] / ms / 1e3:.1f} Mb/s coded", flush=True)
    require(same, "turbo: K16 path differs from the plain turbo_decode_batch")
    del trb, plain, bits, post, pbits, ppost

    # --- 13. config 1's alternate front ends, the down-converter, IIR, spectrum ---
    phase13(torch, dev, x1, x3r, n3r, c1, k17, k18, taps1_np, word1, w01)

    # --- 14. the distribution tier ------------------------------------------------
    del x3r
    phase14(torch, dev, x1, taps1_np, word1)

    launches = dict(_build.LAUNCHES)
    print(f"    main-path launches: {launches}")
    for row in rows:
        row["launches"] = launches[row["name"]]
        require(row["launches"] > 0, f"{row['name']} never launched on the main path")

    # --- 15. the classical FEC tier (plain torch: no kernel, no launch counted) ---
    t15 = time.perf_counter()
    phase15(torch, dev)
    print(f"[15] phase 15 took {time.perf_counter() - t15:.1f} s", flush=True)

    # --- 16. the sync and block-equalizer tier (plain torch; K15 for the modem) ---
    t16 = time.perf_counter()
    phase16(torch, dev, _build.LAUNCHES)
    print(f"[16] phase 16 took {time.perf_counter() - t16:.1f} s", flush=True)

    # --- 17. the CSS modem and the rest of the plane tier (plain torch) -------------
    t17 = time.perf_counter()
    phase17(torch, dev)
    print(f"[17] phase 17 took {time.perf_counter() - t17:.1f} s", flush=True)

    # --- 18. the ops tier: radar, CFAR, impairments, FAM, accel, DPD, FRESH, array, MIMO --
    t18 = time.perf_counter()
    phase18(torch, dev)
    print(f"[18] phase 18 took {time.perf_counter() - t18:.1f} s", flush=True)

    # --- 19. the fifteen protocol receivers at their users' capture lengths ----------------
    t19 = time.perf_counter()
    phase19(torch, dev)
    print(f"[19] phase 19 took {time.perf_counter() - t19:.1f} s", flush=True)

    # --- 20. the CLI on the card, file to file; a killed run resumed ------------------------
    t20 = time.perf_counter()
    k14_cli = phase20(torch, dev)
    for row in rows:
        if row["name"] == "ldpc_edges":
            row["launches"] += k14_cli
    print(f"[20] K14 launches by the CLI: {k14_cli} (added to its row); phase 20 took "
          f"{time.perf_counter() - t20:.1f} s", flush=True)

    # --- 21. the multi-process tier: worker processes, gloo (and NCCL on two cards) ---------
    t21 = time.perf_counter()
    workers = phase21(torch, dev)
    for row in rows:
        row["launches"] += workers.get(row["name"], 0)
    require(all(workers.get(k, 0) > 0 for k in ("mixfir", "fftconv", "halo_dma", "halo_fused")),
            f"phase 21: the workers launched no K1, K11, K19 or K20 ({workers})")
    print(f"[21] the workers' launches {workers} (added to their rows); phase 21 took "
          f"{time.perf_counter() - t21:.1f} s", flush=True)

    # --- 22. a capture streamed straight onto a time-sharded mesh through K20 ----------------
    t22 = time.perf_counter()
    streamed = phase22(torch, dev, taps1_np, word1)
    for row in rows:
        row["launches"] += streamed.get(row["name"], 0)
    print(f"[22] the phase's launches {streamed} (added to their rows); phase 22 took "
          f"{time.perf_counter() - t22:.1f} s", flush=True)

    # --- 23. K10 and K11 past the powers of two: every size the JAX kernels take -------------
    t23 = time.perf_counter()
    rows23, launches23 = phase23(torch, dev)
    rows += rows23
    sizes = ", ".join(f"{row['name']} {row['launches']}" for row in rows23)
    print(f"[23] the phase's launches {launches23}, in the new bodies' rows one a body and "
          f"size: {sizes}; phase 23 took {time.perf_counter() - t23:.1f} s", flush=True)

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
