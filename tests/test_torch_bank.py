"""Port vs JAX package: the bank kernels' plain versions, K12
(``make_bank_kernel``) and K13 (``make_bank_psk_kernel``), in
``kernels/bank_pallas``.

Contracts:

- geometry (hist_cols = P - 1 rounded up to 128) and every ValueError as the
  JAX factories raise them;
- K12's plain version against JAX ``make_bank_kernel(interpret=True)`` at
  M = 8, b_k 16 and 128, manual and pipelined forms: SNR > 110 dB; against
  the complex tier ``channelize_full`` on the same stream: > 110 dB;
- ``bank_os2_pallas`` against JAX's: > 110 dB;
- K13's plain version: Y equal to K12's plain Y by ``torch.equal``; stats
  within rel 1e-5 (L2 over the stats array: single entries are sums with
  cancellation) of JAX's; class-major lanes equal to the standard lanes
  permuted, by ``torch.equal``; Y in class-major order against JAX's
  class-major Y: > 110 dB (the reference permutes with a one-pass matmul,
  exact on the CPU); the same at M = 128 and at M = 96 (not a power of two);
- the CUDA body's FFT schedule (``csrc/bank.cu``, mirrored by ``fft_*``)
  reproduces np.fft at M = 8, 64, 128, 256 (and 1-512), its frame-row
  accesses are conflict-free, and its tile fits the shared-memory budget.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import bank_pallas as jb
from srcdsp_tpu_torch.chains.channelizer import channelize_full, design_prototype
from srcdsp_tpu_torch.kernels import bank_pallas as tb
from srcdsp_tpu_torch.kernels import mixfir as tmf
from tests.torch_threads import one_torch_thread  # noqa: F401

M = 8


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    err = np.mean(np.abs(got - ref) ** 2)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / (err + 1e-30)))


def _planes(seed, hist_cols, k, m=M):
    return np.random.default_rng(seed).standard_normal((2, m, hist_cols + k)).astype(np.float32)


@pytest.mark.parametrize("m,tpp", [(8, 4), (16, 8), (64, 8), (4, 40), (2, 300)])
def test_hist_cols_equals_jax(m, tpp):
    h = design_prototype(m, tpp)
    _, hc = tb.make_bank_kernel(h, m, b_k=128, device="cpu")
    _, jhc = jb.make_bank_kernel(h, m, b_k=128, interpret=True)
    _, hc2 = tb.make_bank_psk_kernel(h, m, sps=4, b_k=128, device="cpu")
    assert hc == jhc == hc2 == ((tpp + 127) // 128) * 128


@pytest.mark.parametrize("b_k,pipelined", [(16, False), (16, None), (128, False), (128, True),
                                           (128, None)])
def test_k12_plain_matches_jax(b_k, pipelined):
    h = design_prototype(M, 4)
    jf, hc = jb.make_bank_kernel(h, M, b_k=b_k, pipelined=pipelined, interpret=True)
    tf, _ = tb.make_bank_kernel(h, M, b_k=b_k, pipelined=pipelined, device="cpu")
    x = _planes(b_k, hc, 4 * b_k)
    got = tf(torch.from_numpy(x))
    assert tuple(got.shape) == (2 * M, 4 * b_k) and got.dtype == torch.float32
    assert _snr_db(np.asarray(jf(jnp.asarray(x))), got.numpy()) > 110


def test_k12_plain_is_the_channelizer():
    """From zero history, Y equals chains.channelizer on the flat stream."""
    h = design_prototype(M, 8)
    fn, hc = tb.make_bank_kernel(h, M, b_k=64, device="cpu")
    k = 256
    rng = np.random.default_rng(1)
    xs = (rng.standard_normal(k * M) + 1j * rng.standard_normal(k * M)).astype(np.complex64)
    flat = np.zeros((2, (hc + k) * M), np.float32)
    flat[0, hc * M:], flat[1, hc * M:] = xs.real, xs.imag
    xp = tb.phase_major(torch.from_numpy(flat), M, hc)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jb.phase_major(jnp.asarray(flat), M, hc)))
    y = fn(xp).numpy()
    ref = channelize_full(h, torch.from_numpy(xs), M).numpy()
    assert _snr_db(ref, y[:M] + 1j * y[M:]) > 110


def test_bank_os2_matches_jax():
    h = design_prototype(M, 4)
    b_k = 32
    jf, hc = jb.make_bank_kernel(h, M, b_k=b_k, interpret=True)
    tf, _ = tb.make_bank_kernel(h, M, b_k=b_k, device="cpu")
    flat = np.random.default_rng(2).standard_normal((2, (hc + 4 * b_k) * M)).astype(np.float32)
    flat[:, :hc * M] = 0.0
    got = tb.bank_os2_pallas(tf, hc, torch.from_numpy(flat), M)
    ref = np.asarray(jb.bank_os2_pallas(jf, hc, jnp.asarray(flat), M))
    assert tuple(got.shape) == ref.shape == (2 * M, 8 * b_k)
    assert _snr_db(ref, got.numpy()) > 110


@pytest.mark.parametrize("b_k,sps,order", [(16, 4, 4), (128, 4, 4), (128, 8, 2), (96, 3, 8)])
def test_k13_plain_matches_jax_and_k12(b_k, sps, order):
    h = design_prototype(M, 4)
    k12, hc = tb.make_bank_kernel(h, M, b_k=b_k, device="cpu")
    x = torch.from_numpy(_planes(b_k + sps, hc, 3 * b_k))
    y12 = k12(x)
    ys = {}
    for cm in (False, True):
        tf, _ = tb.make_bank_psk_kernel(h, M, sps=sps, order=order, b_k=b_k, class_major=cm,
                                        device="cpu")
        jf, _ = jb.make_bank_psk_kernel(h, M, sps=sps, order=order, b_k=b_k, class_major=cm,
                                        interpret=True)
        y, st = tf(x)
        jy, jst = jf(jnp.asarray(x.numpy()))
        jst = np.asarray(jst)
        assert tuple(st.shape) == jst.shape == (3, M, tb.STATS_LANES)
        assert np.linalg.norm(st.numpy() - jst) / np.linalg.norm(jst) < 1e-5
        assert not st[:, :, 2 + 2 * sps:].any()
        assert _snr_db(np.asarray(jy), y.numpy()) > 110
        ys[cm] = (y, st)
    assert torch.equal(ys[False][0], y12)
    assert torch.equal(ys[True][1], ys[False][1])
    perm = tb.class_major_index(b_k, sps, "cpu")
    std = ys[False][0].reshape(2 * M, 3, b_k)
    assert torch.equal(ys[True][0], std[..., perm].reshape(2 * M, 3 * b_k))
    # class-major lane n holds frame (n % (b_k/sps)) * sps + n // (b_k/sps)
    n = 5
    assert int(perm[n]) == (n % (b_k // sps)) * sps + n // (b_k // sps)


def test_factories_raise_as_jax():
    h = design_prototype(M, 4)
    for make in (lambda **kw: jb.make_bank_psk_kernel(h, M, interpret=True, **kw),
                 lambda **kw: tb.make_bank_psk_kernel(h, M, device="cpu", **kw)):
        with pytest.raises(ValueError, match="power of two"):
            make(sps=4, order=3)
        with pytest.raises(ValueError, match="power of two"):
            make(sps=4, order=1)
        with pytest.raises(ValueError, match="% sps"):
            make(sps=3, b_k=128)
        with pytest.raises(ValueError, match="pipelined"):
            make(sps=4, b_k=64, pipelined=True)
    for make in (lambda **kw: jb.make_bank_kernel(h, M, interpret=True, **kw),
                 lambda **kw: tb.make_bank_kernel(h, M, device="cpu", **kw)):
        with pytest.raises(ValueError, match="pipelined"):
            make(b_k=64, pipelined=True)
    fn, hc = tb.make_bank_kernel(h, M, b_k=64, device="cpu")
    jfn, _ = jb.make_bank_kernel(h, M, b_k=64, interpret=True)
    bad = np.zeros((2, M, hc + 100), np.float32)
    with pytest.raises(ValueError, match="not a multiple of b_k"):
        jfn(jnp.asarray(bad))
    with pytest.raises(ValueError, match="not a multiple of b_k"):
        fn(torch.from_numpy(bad))
    with pytest.raises(ValueError, match="shape"):
        fn(torch.zeros((2, M + 1, hc + 64)))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros((2, M, hc + 64), dtype=torch.float64))


# --- the CUDA body's FFT schedule and tile (csrc/bank.cu), in numpy -------------

@pytest.mark.parametrize("m", [8, 64, 128, 256, 1, 2, 4, 16, 32, 512])
def test_fft_schedule_reproduces_np_fft(m):
    """The mirrored Stockham passes (radix 8, then 2 or 4) give
    M * ifft(v) = sum_p v[p] e^{+2 pi i m p/M} on random frames: to 1e-12
    with an exact table (the index map), to 1e-6 with the float32 table the
    kernels take; each pass writes every point once."""
    rng = np.random.default_rng(m)
    v = rng.standard_normal((6, m)) + 1j * rng.standard_normal((6, m))
    ref = np.fft.ifft(v, axis=-1) * m
    exact = np.exp(2j * np.pi * np.arange(m) / m)
    got = tb.fft_frames(v, np.stack([exact.real, exact.imag]))
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-12
    got32 = tb.fft_frames(v)
    assert np.linalg.norm(got32 - ref) / np.linalg.norm(ref) < 1e-6
    for radix in (4, 2):  # the plans bench_torch/ab_bank.py times
        got_r = tb.fft_frames(v, np.stack([exact.real, exact.imag]), radix)
        assert np.linalg.norm(got_r - ref) / np.linalg.norm(ref) < 1e-12
    tw = tb.fft_twiddles(m)
    assert tw.dtype == np.float32 and tw[0, 0] == 1.0 and tw[1, 0] == 0.0
    ns = 1
    for r in tb.fft_plan(m):
        src, dst, ti = tb.fft_pass_map(m, ns, r)
        for idx in (src, dst):
            np.testing.assert_array_equal(np.sort(idx.ravel()), np.arange(m))
        assert ti.min() >= 0 and ti.max() < m
        ns *= r
    assert ns == m


@pytest.mark.parametrize("m", [96, 200, 5])
def test_direct_dft_for_other_m(m):
    """Any M that is not a power of two runs the direct DFT (no plan)."""
    assert tb.fft_plan(m) is None
    v = np.random.default_rng(m).standard_normal((3, m)) + 0j
    ref = np.fft.ifft(v, axis=-1) * m
    assert np.linalg.norm(tb.fft_frames(v) - ref) / np.linalg.norm(ref) < 1e-6


@pytest.mark.parametrize("m", [8, 64, 96, 128])
def test_frame_rows_conflict_free(m):
    """Units put 32 lanes on consecutive frames of one point: 8-byte
    accesses at f*(M + 1) + c, each half-warp on 32 distinct banks."""
    for c in (0, 1, m // 2, m - 1):
        f = np.arange(16)
        words = np.concatenate([2 * (f * (m + 1) + c), 2 * (f * (m + 1) + c) + 1])
        assert tmf.worst_bank(words) == 1


@pytest.mark.parametrize("tile,b_k,sps", [(64, 512, 4), (64, 512, 8), (64, 512, 2),
                                          (32, 512, 2), (64, 96, 3), (64, 512, 32)])
def test_class_major_rows(tile, b_k, sps):
    """The buffer rows of a tile's frames are a permutation; in class-major
    runs frame jj*sps + o lands on the row of its class-major position, so
    the store reads consecutive rows and a class's frames are consecutive
    rows in frame order; elsewhere rows are frames."""
    f = np.arange(tile)
    np.testing.assert_array_equal(tb.bank_rows(f, tile, b_k, sps, False), f)
    rows = tb.bank_rows(f, tile, b_k, sps, True)
    np.testing.assert_array_equal(np.sort(rows), f)
    if b_k % tile or tile % sps:
        np.testing.assert_array_equal(rows, f)
        return
    spt = tile // sps
    for o in range(sps):
        np.testing.assert_array_equal(rows[o::sps], o * spt + np.arange(spt))
    perm = tb.class_major_index(tile, sps, "cpu").numpy()  # frame at class-major lane n
    np.testing.assert_array_equal(rows[perm], f)


@pytest.mark.parametrize("m,b_k,stats,want", [(64, 512, True, 64), (64, 512, False, 64),
                                              (8, 16, True, 16), (128, 512, True, 32),
                                              (256, 512, True, 8), (96, 512, False, 32)])
def test_bank_tile_fits(m, b_k, stats, want):
    """The tile: 64 frames at config 5 (M 64, P 8, sps 4) within the 96 KB
    budget; smaller for larger M; never above b_k's power of two."""
    f, nbytes = tb.bank_tile(m, 8, b_k, 4, stats)
    assert f == want and 0 < nbytes <= tb.BANK_BUDGET


@pytest.mark.parametrize("m", [128, 96])
def test_plain_matches_jax_above_64_channels(m):
    """K12's and K13's plain versions against the JAX kernels (interpret
    mode) at M = 128 and at M = 96 (not a power of two): Y > 110 dB, stats
    within rel 1e-5, K13's Y equal to K12's."""
    h = design_prototype(m, 4)
    b_k = 16
    jf, hc = jb.make_bank_kernel(h, m, b_k=b_k, interpret=True)
    tf, _ = tb.make_bank_kernel(h, m, b_k=b_k, device="cpu")
    x = _planes(m, hc, 2 * b_k, m=m)
    y = tf(torch.from_numpy(x))
    assert tuple(y.shape) == (2 * m, 2 * b_k)
    assert _snr_db(np.asarray(jf(jnp.asarray(x))), y.numpy()) > 110
    jp, _ = jb.make_bank_psk_kernel(h, m, sps=4, b_k=b_k, interpret=True)
    tp, _ = tb.make_bank_psk_kernel(h, m, sps=4, b_k=b_k, device="cpu")
    y13, st = tp(torch.from_numpy(x))
    jy, jst = jp(jnp.asarray(x))
    jst = np.asarray(jst)
    assert torch.equal(y13, y)
    assert _snr_db(np.asarray(jy), y13.numpy()) > 110
    assert np.linalg.norm(st.numpy() - jst) / np.linalg.norm(jst) < 1e-5
