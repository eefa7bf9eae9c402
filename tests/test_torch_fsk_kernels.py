"""Port vs JAX package: kernels K2 (fsk_fused) and K3 (fsk_ctaps).

The plain PyTorch versions (what the wrappers run on a CPU tensor) are held
against the Pallas kernels in interpret mode (out_tile=128, b_rows=2) on the
same planes, for both lane orders. Tolerances: soft symbols atol 1e-4
cycles/sample (atan2f vs the TPU kernel's polynomial, |err| < 3e-7 rad, plus
float32 sums in another order), bits equal, O&M sums rtol 1e-4 / atol 1e-3.

The CUDA body's ownership and index map (``csrc/fsk.cu`` on the ring of
``csrc/fir_ring.cuh``, mirrored by ``kernels/fsk_fused.fsk_*``) run here
thread by thread: every output reads x[J*decim + hist - a] and finds y[J-1]
(the previous register, the previous thread's last output, or the chain of
the tile's first), no warp's ring load touches a bank twice, blocks of whole
rows tile [NT, OT] and sum each row's O&M terms once, the store index is the
plain layout, and K7's windows read each sample from its own frame row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import fsk_ctaps as jct
from srcdsp_tpu.kernels import fsk_fused as jff
from srcdsp_tpu.kernels.mixfir_ctaps import _banded_pack
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu.testing.signals import fsk_baseband, random_bits, tone
from srcdsp_tpu_torch.kernels import fsk_ctaps as tct
from srcdsp_tpu_torch.kernels import fsk_fused as tff
from srcdsp_tpu_torch.kernels import mixfir as tmf
from tests.torch_threads import one_torch_thread  # noqa: F401

NCH, DECIM, SPS, OT = 2, 4, 8, 128


def _fixture(nsym=512):
    centers = [0.11 + 0.01 * c for c in range(NCH)]
    bits = random_bits(jax.random.PRNGKey(0), (NCH, nsym))
    bb = fsk_baseband(bits, DECIM * SPS, 0.05 / DECIM)
    x = np.asarray(bb) * np.stack([np.asarray(tone(bb.shape[-1], c)) for c in centers])
    words = np.asarray([freq_to_word(-c) for c in centers], np.uint32)
    hist = 128
    blk = 2 * OT * DECIM
    x = x[:, :(x.shape[-1] // blk) * blk]
    xpad = np.concatenate([np.zeros((NCH, hist), np.complex64), x], axis=1)
    planes = np.stack([xpad.real, xpad.imag], axis=1).astype(np.float32)
    return words, planes, hist


def _compare(jout, tout, jd, td, jst, tst):
    (_, (jbits, jsoft)), (_, (tbits, tsoft)) = jout, tout
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(tsoft.numpy(), np.asarray(jsoft), atol=1e-4)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("class_major", [False, True])
def test_fsk_fused_plain_matches_pallas_interpret(class_major):
    words, planes, hist = _fixture()
    taps = lowpass(64, 0.03)
    jfn, jhist = jff.make_fsk_mc_kernel(taps, DECIM, NCH, SPS, out_tile=OT, b_rows=2,
                                        class_major=class_major, interpret=True)
    tfn, thist = tff.make_fsk_mc_kernel(taps, DECIM, NCH, SPS, out_tile=OT, b_rows=2,
                                        class_major=class_major, device="cpu")
    assert jhist == thist == hist
    words0 = np.asarray([(-hist * int(w)) % (1 << 32) for w in words], np.uint32)
    jout = jff.fsk_demod_fused(jfn, hist, OT, words0, words, jnp.asarray(planes), SPS,
                               class_major=class_major)
    tout = tff.fsk_demod_fused(tfn, hist, OT, words0, words, torch.as_tensor(planes), SPS,
                               class_major=class_major)
    w0 = jnp.asarray(words0.view(np.int32).reshape(-1, 1))
    dw = jnp.asarray(words.view(np.int32).reshape(-1, 1))
    jd, jst = jfn(w0, dw, jnp.asarray(planes))
    # the port's fn also takes the JAX fn's int32 [C, 1] word arrays
    td, tst = tfn(np.asarray(w0), np.asarray(dw), torch.as_tensor(planes))
    _compare(jout, tout, jd, td, jst, tst)


@pytest.mark.parametrize("class_major", [False, True])
def test_fsk_ctaps_plain_matches_pallas_interpret(class_major):
    words, planes, hist = _fixture()
    taps = lowpass(64, 0.03)
    jfn, jhist = jct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=2,
                                           class_major=class_major, interpret=True)
    tfn, thist = tct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=2,
                                           class_major=class_major, device="cpu")
    assert jhist == thist == hist
    jout = jct.fsk_demod_ctaps(jfn, hist, OT, jnp.asarray(planes), SPS,
                               class_major=class_major)
    tout = tct.fsk_demod_ctaps(tfn, hist, OT, torch.as_tensor(planes), SPS,
                               class_major=class_major)
    jd, jst = jfn(jnp.asarray(planes))
    td, tst = tfn(torch.as_tensor(planes))
    _compare(jout, tout, jd, td, jst, tst)


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def test_ctaps_host_taps_and_deltas_bit_equal():
    """The port's host-built complex taps and deltas are the JAX kernel's:
    its banded 3-matmul pack of the port's taps, and its deltas, bit for bit."""
    taps = lowpass(64, 0.03)
    words = np.asarray([freq_to_word(-0.11 - 0.07 * c) for c in range(5)], np.uint32)
    jfn, hist = jct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=2,
                                          interpret=True)
    gr, gi, deltas = tct.ctaps_host(taps, words, DECIM)
    np.testing.assert_array_equal(deltas, np.asarray(_closure(jfn, "deltas"))[:, 0])
    hsubs = np.asarray(_closure(jfn, "hsubs"))
    for c in range(len(words)):
        pack = _banded_pack(gr[c] + 1j * gi[c].astype(np.float64), DECIM, OT, hist, 128)
        np.testing.assert_array_equal(pack, hsubs[c])
        bands_r = tmf.banded_taps(gr[c], DECIM, OT, hist, 128)
        np.testing.assert_array_equal(bands_r, hsubs[c][..., :128])


def test_seam_and_chunk_join_match_jax():
    """Output 0 of each call has d = 0; the second chunk's rows past the seam
    sample equal the one-shot call's, as in the JAX kernel."""
    words, planes, hist = _fixture(nsym=1024)
    taps = lowpass(64, 0.03)
    tfn, _ = tct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=2, device="cpu")
    n = planes.shape[-1] - hist
    half = n // 2
    d1, _ = tfn(torch.as_tensor(planes))
    da, _ = tfn(torch.as_tensor(planes[:, :, :hist + half]).contiguous())
    db, _ = tfn(torch.as_tensor(planes[:, :, half:]).contiguous())
    assert torch.all(da[:, 0, 0] == 0) and torch.all(db[:, 0, 0] == 0)
    nt = d1.shape[1] // 2
    assert torch.equal(d1[:, :nt], da)
    assert torch.equal(d1[:, nt + 1:], db[:, 1:])
    assert torch.equal(d1[:, nt, 1:], db[:, 0, 1:])


@pytest.mark.parametrize("threads", [1, 4])
def test_seam_and_chunk_join_hold_under_thread_counts(threads):
    """The plain K3 sums each output tap by tap in a fixed order
    (`ctaps_fir_rows`), so the seam check holds bit for bit whatever torch's
    intra-op thread count: the same test under 1 and 4 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        test_seam_and_chunk_join_match_jax()
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("per_channel", [False, True])
def test_plain_k1_chunk_join_under_thread_counts(threads, per_channel):
    """The plain K1 FIR (`mixfir.fir_decim_rows`, a conv1d of one input
    channel per group) joins chunks bit for bit under 1 and 4 threads, at
    decim 1..4 and 33 / 64 taps: it needs no fixed-order rewrite."""
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    rng = np.random.default_rng(5)
    try:
        for t in (33, 64):
            for decim in (1, 2, 3, 4):
                u = torch.as_tensor(rng.standard_normal((3, 2, 128 + decim * 128 * 12))
                                    .astype(np.float32))
                taps = torch.as_tensor(rng.standard_normal((3, t) if per_channel else t)
                                       .astype(np.float32))
                y = tmf.fir_decim_rows(u, taps, decim, 128)
                for cut in (decim * 128, decim * 128 * 5):
                    ya = tmf.fir_decim_rows(u[..., :128 + cut].contiguous(), taps, decim, 128)
                    yb = tmf.fir_decim_rows(u[..., cut:].contiguous(), taps, decim, 128)
                    assert torch.equal(torch.cat([ya, yb], dim=-1), y)
                    assert torch.equal(tmf.fir_decim_rows(u[1:2].contiguous(),
                                                          taps[1:2] if per_channel else taps,
                                                          decim, 128), y[1:2])
    finally:
        torch.set_num_threads(n)


# --- the CUDA body's index map (csrc/fsk.cu on csrc/fir_ring.cuh), in numpy ---

def _round_up(x, m=128):
    return -(-x // m) * m


@pytest.mark.parametrize("ctaps", [False, True])
@pytest.mark.parametrize("t", [64, 33])
@pytest.mark.parametrize("decim", [1, 2, 4, 3])
def test_cuda_body_reads_outputs_and_predecessors(decim, t, ctaps):
    """Every output J of every thread reads x[J*decim + hist - a] at tap a
    inside the staged window, and its y[J-1] is the right one: output J-1
    of the same thread, the previous thread's last output, or for the tile's
    first output the chain at window index e, which reads x[(J-1)*decim +
    hist - a] inside the window; no warp's ring load touches a bank twice at
    decim 1, 2 and 4."""
    hist = _round_up(t - 1)
    sh = tff.fsk_shape(decim, ctaps)
    tp, lead, span, plane = tff.fsk_geometry(decim, t, hist, ctaps)
    assert lead >= 0 and tp - 1 <= hist + lead and t - 1 + decim <= hist + lead
    reads, loads = tmf.ring_schedule(decim, t, hist, sh, pre=decim)
    taps = tp if decim in (1, 2, 4) else t
    assert reads[:, :, :taps].min() >= 0 and reads.max() < span
    tid = np.arange(sh.threads)
    nt, ot = 5, 128
    for block in range(tff.fsk_blocks(nt, decim, ot, ctaps)):
        for t0 in tff.fsk_tiles(block, nt, decim, ot, ctaps):
            start = tff.fsk_window_start(block, t0, decim, t, hist, ot, ctaps)
            j = np.stack([tff.fsk_output(block, t0, tid, k, nt, decim, ot, ctaps)[0]
                          for k in range(sh.r)], 1)
            want = j[:, :, None] * decim + hist - np.arange(taps)
            np.testing.assert_array_equal(reads[:, :, :taps] + start, want)
            src, from_slot = tff.fsk_predecessor(tid, lead, hist, decim, ctaps)
            np.testing.assert_array_equal(j[src[from_slot], sh.r - 1], j[from_slot, 0] - 1)
            e = int(src[~from_slot][0])
            assert e - (t - 1) >= 0
            np.testing.assert_array_equal(start + e - np.arange(t),
                                          (j[0, 0] - 1) * decim + hist - np.arange(t))
    worst = max(tmf.worst_bank(tmf.fir_pad(idx[w:w + 32], sh.log2s))
                for idx in loads for w in range(0, sh.threads, 32))
    assert worst == 1 if decim in (1, 2, 4) else worst <= 2


@pytest.mark.parametrize("ctaps", [False, True])
@pytest.mark.parametrize("decim,nt,ot", [(4, 8, 512), (4, 5, 384), (2, 7, 128), (1, 3, 2048),
                                         (4, 3, 2048), (3, 4, 96)])
def test_cuda_body_blocks_tile_the_output_in_rows(decim, nt, ot, ctaps):
    """Blocks of whole rows cover every output of [NT, OT] exactly once (a
    last block with fewer rows, rows longer than a tile in turns); each
    row's O&M terms are summed once, by one warp, across the tiles in order."""
    sh = tff.fsk_shape(decim, ctaps)
    tid = np.arange(sh.threads)
    seen, summed = [], []
    rows_b = tff.fsk_rows(decim, ot, ctaps)
    for block in range(tff.fsk_blocks(nt, decim, ot, ctaps)):
        tiles = tff.fsk_tiles(block, nt, decim, ot, ctaps)
        bo = tiles and min(rows_b, nt - block * rows_b) * ot
        for t0 in tiles:
            for k in range(sh.r):
                j, stored = tff.fsk_output(block, t0, tid, k, nt, decim, ot, ctaps)
                seen.append(j[stored])
            tn = min(bo - t0, sh.outputs)
            for rr, warp, lo, end in tff.fsk_row_terms(t0, tn, ot, sh.threads // 32):
                assert 0 <= warp < sh.threads // 32 and 0 <= lo < end <= tn
                summed.append(block * rows_b * ot + t0 + np.arange(lo, end))
                assert (summed[-1] // ot == block * rows_b + rr).all()
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(nt * ot))
    np.testing.assert_array_equal(np.sort(np.concatenate(summed)), np.arange(nt * ot))


@pytest.mark.parametrize("class_major", [False, True])
def test_cuda_body_store_index_is_the_plain_layout(class_major):
    """The kernel's d store index (row, lane) puts output col of a row where
    to_class_major (or the row-major layout) puts it."""
    ot, sps, rows = 128, 8, 3
    local = np.arange(rows * ot)
    row, lane = tff.fsk_store_index(local, ot, sps, class_major)
    got = np.zeros((1, rows, ot))
    got[0, row, lane] = local
    want = local.reshape(1, rows, ot).astype(np.float64)
    if class_major:
        want = tff.to_class_major(torch.as_tensor(want), sps).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("decim", [1, 2, 4, 3])
def test_frames_pick_serves_the_fsk_windows(decim):
    """K7's windows (tiles of whole rows, starting decim samples early for
    the predecessor) read every sample from the row deframe takes it from,
    over frames whose overlaps disagree, by the staging loops' places."""
    from srcdsp_tpu_torch.kernels import mixfir_preframed as tpf
    t, ot, nt = 64, 128, 9
    hist = _round_up(t - 1)
    stride, span = ot * decim, ot * decim + hist
    frames = np.random.default_rng(decim).standard_normal((nt, span)).astype(np.float32)
    stream = tpf.deframe(torch.from_numpy(frames), stride).numpy()
    sh = tff.fsk_shape(decim, True)
    _, _, wspan, _ = tff.fsk_geometry(decim, t, hist, True)
    for block in range(tff.fsk_blocks(nt, decim, ot, True)):
        for t0 in tff.fsk_tiles(block, nt, decim, ot, True):
            base = tff.fsk_window_start(block, t0, decim, t, hist, ot, True)
            g = base + np.arange(wspan)
            row, col = tpf.frames_pick(g, nt, stride, span)
            ok = row >= 0
            np.testing.assert_array_equal(ok, (g >= 0) & (g < stream.shape[0]))
            np.testing.assert_array_equal(frames[row[ok], col[ok]], stream[g[ok]])
            for batch, pairs in ((8, False), (4, True)):
                srow, scol = tpf.frames_staged(base, wspan, sh.threads, batch, nt, stride,
                                               span, pairs)
                np.testing.assert_array_equal(srow, row)
                np.testing.assert_array_equal(scol, col)
