"""K10 and K11 past the powers of two up to 8192: the plan that picks the
card's body, the bodies' schedules in numpy, and the plain versions against
the JAX kernels.

Contracts:

- `fft_plan`'s domain is the JAX kernel's with interpret=False (n2 % 128 ==
  0 and n1 % 8 == 0) plus the powers of two from 256 to 8192, capped at
  2^20: one block a frame up to 16384 (N = P M of MIXED_SHAPES), the
  four-step from 17408;
- the compile-time schedules of ``csrc/fft_lines.cuh`` (mirrored in
  ``kernels/fft_pallas``: the odd DFT's constants, the odd pass's rows and
  twiddle table, the Stockham sub-transforms on fft_regs.cuh's maps, the
  forward's register order, the transposed order of K11's inverse, the
  four-step's post-twiddles and lines, and the Bluestein lines for the
  shapes not instantiated: the chirp, the two M-point transforms at P = 1,
  the B product) run in float64 numpy on the float32 tables: rel L2 < 1e-6
  against ``np.fft.fft`` at every size of SIZES, for every odd part 3 ...
  15, for odd parts above 15 split across two register lines, and for
  Bluestein lines of 136 ... 2040 points (the tables' rounding leaves
  ~1e-7); the
  digit store equal to the natural store permuted, exactly (the same values
  moved); the transposed order after the forward gives N x back, rel L2 <
  1e-6;
- every table entry is its constant rounded once from float64, and the
  odd DFT's float32 literals in fft_lines.cuh are the float64 values rounded
  once, exactly; the shapes the host plans with (MIXED_SHAPES,
  FOUR_STEP_LINES, BLUESTEIN_LOG2M) are the ones the CUDA sources
  instantiate;
- no warp's access of the one-block body's staging (registers in the
  forward's order written, the natural and digit stores' reads at every
  n2), odd pass or sub-transform loads, nor of the four-step's tiles on
  phase 23's lines and the Bluestein lines' tiles, touches a shared-memory
  bank more than twice;
- K10's plain version against the JAX kernel with ``interpret=True`` in all
  three orders: SNR > 120 dB (the same factorization and constants, float32
  products summed in another order), against complex128 > 110 dB (the
  reference's bar);
- K11's plain version against the JAX kernel in interpret mode: > 100 dB
  (the K11 tests' bar); against a direct FIR in float64: > 90 dB (the
  reference's bar against the oracle's direct FIR); the kernel's frame
  schedule in numpy against the plain version: > 100 dB.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels.fft_pallas import make_fft_kernel as jmake_fft_kernel
from srcdsp_tpu.kernels.fftconv_pallas import fftconv_pallas as jfftconv_pallas
from srcdsp_tpu.kernels.fftconv_pallas import make_fftconv_kernel as jmake_fftconv
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch.kernels import fft_pallas as kfft
from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc
from tests.torch_threads import one_torch_thread  # noqa: F401


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    err = np.mean(np.abs(got - ref) ** 2)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / (err + 1e-30)))


def _rel(got, ref) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(ref)) / np.linalg.norm(ref))


def _cplx(flat: np.ndarray) -> np.ndarray:
    """A flat [2, size] section (real plane, imaginary plane) as complex128."""
    t = flat.astype(np.float64).reshape(2, -1)
    return t[0] + 1j * t[1]


def _line_section(flat: np.ndarray, g):
    """A line's table as complex128: a register line's odd section [2, (P -
    1) M] then its Stockham section, each its own pair of planes
    (_reg_line_table), concatenated; a Bluestein line's (Stockham section,
    B, c), each its own pair of planes (_bluestein_table)."""
    if isinstance(g, kfft.BluesteinLine):
        return _bluestein_sections(flat, g.length, g.log2m)
    size = 2 * (g.p - 1) << g.log2m
    return np.concatenate([_cplx(flat[:size]), _cplx(flat[size:])])


def _bluestein_sections(flat: np.ndarray, length: int, log2m: int) -> tuple:
    """A flat _bluestein_table as complex128 (Stockham section, B [M], c [L])."""
    stock = 2 * kfft.stockham_twiddles(1 << log2m).shape[1]
    b = stock + (2 << log2m)
    assert flat.size == b + 2 * length
    return _cplx(flat[:stock]), _cplx(flat[stock:b]), _cplx(flat[b:])


def _sections(plan: kfft.FftPlan) -> list:
    """The plan's table split as the kernels take it (FftPlan.tables'
    offsets): each line's table, then (four-step) the two post-twiddles
    [f2, f1] and [f1, f2], complex128."""
    tab, offs = plan.tables()
    ends = list(offs[1:]) + [tab.size]
    out = [_line_section(tab[a:b], g) if i < len(plan.lines) else _cplx(tab[a:b])
           for i, (a, b, g) in enumerate(zip(offs, ends, list(plan.lines) + [None] * 2))]
    if plan.body == "four_step":
        f1, f2 = plan.factors
        out[2], out[3] = out[2].reshape(f2, f1), out[3].reshape(f1, f2)
    return out


def _expand(a: np.ndarray, nd: int) -> np.ndarray:
    return a.reshape(a.shape + (1,) * nd)


# --- the compile-time schedules in numpy ---------------------------------------

def _stockham(v: np.ndarray, log2m: int, stock: np.ndarray) -> np.ndarray:
    """fft_regs.cuh's schedule on v [M, ...] (element e at v[e]) with the
    section `stock` (stockham_twiddles): pass q's butterfly j takes elements
    j + (M/R) m (thread t's registers g + (16/R) m, j = t + T g), input m
    times entry (m - 1) NS + j mod NS of the pass's part, the R-point DFT,
    output m to regs_store_index. Returns X in natural order."""
    m = v.shape[0]
    off = 0
    for q, (r, ns) in enumerate(kfft.regs_passes(log2m)):
        j = np.arange(m // r)
        x = v[j[:, None] + (m // r) * np.arange(r)[None, :]]          # [m/r, R, ...]
        if q:
            e = off + (np.arange(1, r)[None, :] - 1) * ns + (j % ns)[:, None]
            x[:, 1:] *= _expand(stock[e], v.ndim - 1)
            off += (r - 1) * ns
        kk = np.arange(r)
        y = np.moveaxis(np.tensordot(np.exp(-2j * np.pi * np.outer(kk, kk) / r), x,
                                     axes=([1], [1])), 0, 1)            # [m/r, R, ...]
        out = np.empty_like(v)
        out[kfft.regs_store_index(j[:, None], r, ns, kk[None, :])] = y
        v = out
    return v


def _odd_dft(x: np.ndarray, p: int) -> np.ndarray:
    """fft_lines.cuh odd_dft on x [P, ...] with kOddTrig's float32 constants
    (_odd_trig): a_n = x_n + x_{P-n}, b_n = x_n - x_{P-n}, y[k] = A_k - i B_k,
    y[P - k] = A_k + i B_k."""
    h = (p - 1) // 2
    cs = kfft._odd_trig(p).astype(np.float64)
    a, b = x[1:h + 1] + x[p - 1:h:-1], x[1:h + 1] - x[p - 1:h:-1]
    y = np.empty_like(x)
    y[0] = x[0] + a.sum(0)
    for k in range(1, h + 1):
        j = np.arange(1, h + 1) * k % p
        c = np.where(j == 0, 1.0, cs[np.minimum(j, p - j) - 1, 0])
        s = np.where(j == 0, 0.0, np.where(j <= h, 1.0, -1.0) * cs[np.minimum(j, p - j) - 1, 1])
        big_a = x[0] + np.tensordot(c, a, axes=1)
        big_b = np.tensordot(s, b, axes=1)
        y[k], y[p - k] = big_a - 1j * big_b, big_a + 1j * big_b
    return y


def _split(tab: np.ndarray, p: int, log2m: int):
    """A _reg_line_table (complex) as (odd section [P - 1, M], Stockham section)."""
    m = 1 << log2m
    return tab[:(p - 1) * m].reshape(p - 1, m), tab[(p - 1) * m:]


def _line_fwd(x: np.ndarray, p: int, log2m: int, tab: np.ndarray) -> np.ndarray:
    """fft_lines.cuh line_forward (mixed_forward) on x [L, ...]: the odd pass
    (butterfly n_m's inputs at rows n_m + M n_p, odd_dft, output k times
    W_L^{n_m k} to row n_m + M k), then the Stockham sub-transforms k_p over
    rows k_p M + k_m. Returns the forward's order F[k_p M + k_m] =
    X[k_p + P k_m] (_forward_order)."""
    m = 1 << log2m
    odd, stock = _split(tab, p, log2m)
    y = x.reshape((p, m) + x.shape[1:]).astype(np.complex128)
    if p > 1:
        y = _odd_dft(y, p)
        y[1:] *= _expand(odd, x.ndim - 1)
    z = np.stack([_stockham(y[k], log2m, stock) for k in range(p)])
    return z.reshape(x.shape)


def _natural(f: np.ndarray, p: int, log2m: int) -> np.ndarray:
    """The forward's order as natural order (the staging)."""
    out = np.empty_like(f)
    out[kfft._forward_order(p, log2m)] = f
    return out


def _line_dit(f: np.ndarray, p: int, log2m: int, tab: np.ndarray) -> np.ndarray:
    """fft_lines.cuh line_forward_dit / K11's inverse on an input in the
    forward's order (entry k_p M + k_m holding z[k_p + P k_m]): the Stockham
    sub-transforms on it as it lies, then the odd pass (input n_p times
    W_L^{n_p k_m}, odd_dft, output k_p to k_m + M k_p). Returns the DFT of z
    in natural order."""
    m = 1 << log2m
    odd, stock = _split(tab, p, log2m)
    w = np.stack([_stockham(f.reshape((p, m) + f.shape[1:])[k], log2m, stock)
                  for k in range(p)])
    if p > 1:
        w[1:] *= _expand(odd, f.ndim - 1)
        w = _odd_dft(w, p)
    return w.reshape(f.shape)


def _bluestein(x: np.ndarray, log2m: int, sections: tuple) -> np.ndarray:
    """fft_lines.cuh bluestein_line on x [L, ...] (natural order in and out):
    x times the chirp c, zero-padded to M, the Stockham forward at P = 1,
    times B, conjugated, the forward again, conjugated, times c, the first L
    entries."""
    stock, big_b, c = sections
    length, m = x.shape[0], 1 << log2m
    a = np.zeros((m,) + x.shape[1:], np.complex128)
    a[:length] = x * _expand(c, x.ndim - 1)
    y = np.conj(_stockham(a, log2m, stock) * _expand(big_b, x.ndim - 1))
    return np.conj(_stockham(y, log2m, stock))[:length] * _expand(c, x.ndim - 1)


def _fwd(g, v: np.ndarray, tab) -> np.ndarray:
    """A four-step line's forward transform on v [L, lines], natural order out."""
    if isinstance(g, kfft.LineShape):
        return _natural(_line_fwd(v, g.p, g.log2m, tab), g.p, g.log2m)
    return _bluestein(v.astype(np.complex128), g.log2m, tab)


def _dit(g, z: np.ndarray, tab) -> np.ndarray:
    """A four-step line's transform of z [L, lines] (natural order in) in the
    order its forward left (K11's mid): natural order out. A Bluestein line
    takes and leaves natural order, so its second transform is its forward."""
    if isinstance(g, kfft.LineShape):
        return _line_dit(z[kfft._forward_order(g.p, g.log2m)], g.p, g.log2m, tab)
    return _bluestein(z, g.log2m, tab)


def _mixed_fft(x: np.ndarray, plan: kfft.FftPlan, digit: bool) -> np.ndarray:
    """fft_mixed.cu fft_mixed_kernel on one frame: the forward, then offset
    q takes X[k] from the staging, k = q (natural) or (q mod n2) n1 + q div
    n2."""
    g = plan.lines[0]
    nat = _natural(_line_fwd(x, g.p, g.log2m, _sections(plan)[0]), g.p, g.log2m)
    q = np.arange(plan.fft_size)
    return nat[(q % plan.n2) * plan.n1 + q // plan.n2] if digit else nat


def _four_step_fft(x: np.ndarray, plan: kfft.FftPlan, digit: bool) -> np.ndarray:
    """fft_4step.cu on one frame: the columns b of [f1, f2] (element a of
    column b at b + a f2), times W_N^{b c} (the first post-twiddle), into the
    scratch at b f1 + c; the f1 lines c of the scratch, X[c + f1 d] stored at
    k or at its digit offset."""
    n = plan.fft_size
    (g1, g2), (f1, f2) = plan.lines, plan.factors
    t1, t2, post1, _ = _sections(plan)
    v = _fwd(g1, x.reshape(f1, f2), t1) * post1.T                      # [c, b]
    xk = _fwd(g2, v.T, t2)                                              # [d, c]
    out = np.empty(n, np.complex128)
    k = np.arange(f1)[None, :] + f1 * np.arange(f2)[:, None]
    out[kfft._digit_position(k, plan.n1, plan.n2) if digit else k] = xk
    return out


SIZES = [(3072, 128), (5120, 128), (7168, 128), (11264, 128), (12288, 128), (16384, 128),
         (17408, 128), (21504, 128), (65536, 128), (1024 * 1021, 128)]


@pytest.mark.parametrize("n,n2", SIZES)
def test_body_schedule_matches_numpy_fft(n, n2):
    """The planned body's schedule (one block a frame up to 16384, the
    four-step from 17408; 21 split across two register lines at 21504; 17
    and 1021 on Bluestein lines) against np.fft.fft;
    the digit store a permutation of the natural one; and, for one block a
    frame, the transposed order after the forward (K11's inverse): N x."""
    plan = kfft.fft_plan(n, n2)
    assert plan.body == ("mixed" if n <= 16384 else "four_step")
    x = np.random.default_rng(n).standard_normal((2, n))
    x = x[0] + 1j * x[1]
    run = _mixed_fft if plan.body == "mixed" else _four_step_fft
    nat = run(x, plan, False)
    assert _rel(nat, np.fft.fft(x)) < 1e-6
    dig = run(x, plan, True)
    k = np.arange(n)
    np.testing.assert_array_equal(dig[kfft._digit_position(k, plan.n1, plan.n2)], nat)
    if plan.body == "mixed":
        g, tab = plan.lines[0], _sections(plan)[0]
        fwd = _line_fwd(x, g.p, g.log2m, tab)                        # the forward's order
        back = np.conj(_line_dit(np.conj(fwd), g.p, g.log2m, tab))    # N x, natural order
        assert _rel(back, n * x) < 1e-6


@pytest.mark.parametrize("p", kfft.ODD_FACTORS)
def test_odd_part_schedules_match_numpy_fft(p):
    """Odd part p on both bodies: one block a frame at p x 1024 (forward,
    digit store, the transposed order back to N x) and the four-step at
    p x 2^15, whose lines p x 128 and 256 both run register schedules."""
    for n, body in ((p * 1024, "mixed"), (p << 15, "four_step")):
        plan = kfft.fft_plan(n)
        assert plan.body == body
        x = np.random.default_rng(n + p).standard_normal((2, n))
        x = x[0] + 1j * x[1]
        run = _mixed_fft if body == "mixed" else _four_step_fft
        nat = run(x, plan, False)
        assert _rel(nat, np.fft.fft(x)) < 1e-6
        k = np.arange(n)
        np.testing.assert_array_equal(
            run(x, plan, True)[kfft._digit_position(k, plan.n1, plan.n2)], nat)
        if body == "mixed":
            g, tab = plan.lines[0], _sections(plan)[0]
            back = np.conj(_line_dit(np.conj(_line_fwd(x, g.p, g.log2m, tab)), g.p, g.log2m,
                                     tab))
            assert _rel(back, n * x) < 1e-6
        else:
            assert all(isinstance(g, kfft.LineShape) for g in plan.lines)
            assert plan.factors == (p * 128, 256)


@pytest.mark.parametrize("q,a", [(21, 10), (45, 11), (225, 10), (35, 12), (63, 13), (27, 14)])
def test_split_odd_parts_match_numpy_fft(q, a):
    """An odd part q above 15 made of two factors up to 15 runs the four-step
    on two register lines q1 2^a1 x q2 2^a2 (_odd_pair) at every power of two
    2^10 ... 2^14: K10's schedule against np.fft.fft (rel L2 < 1e-6), the
    digit store the natural one permuted, and one K11 frame through the
    three kernels' schedule against the circular product by np.fft
    (rel L2 < 1e-6)."""
    n = q << a
    plan = kfft.fft_plan(n)
    assert plan.body == "four_step"
    assert all(isinstance(g, kfft.LineShape) and g.p > 1 for g in plan.lines), plan.lines
    f1, f2 = plan.factors
    assert f1 * f2 == n and kfft._odd_split(f1)[0] * kfft._odd_split(f2)[0] == q
    rng = np.random.default_rng(q + a)
    x = rng.standard_normal((2, n))
    x = x[0] + 1j * x[1]
    nat = _four_step_fft(x, plan, False)
    assert _rel(nat, np.fft.fft(x)) < 1e-6
    k = np.arange(n)
    np.testing.assert_array_equal(
        _four_step_fft(x, plan, True)[kfft._digit_position(k, plan.n1, plan.n2)], nat)
    h = rng.standard_normal((2, n))
    h = h[0] + 1j * h[1]
    hop = n // 4 * 3
    got = _fftconv_frames(x, h, plan, hop)
    assert _rel(got, np.fft.ifft(np.fft.fft(x) * h)[n - hop:]) < 1e-6


@pytest.mark.parametrize("length,log2m,lanes", [(136, 9, 8), (864, 11, 4), (1021, 11, 4),
                                                (1018, 11, 4), (2040, 12, 2)])
def test_bluestein_line_matches_numpy_fft(length, log2m, lanes):
    """A Bluestein line (fft_lines.cuh bluestein_line) in float64 numpy on its
    float32 table, 8 lines at once: M the least power of two >= 2L - 1,
    lanes as many of the 8 as a tile of 8192 points takes; the forward
    against np.fft.fft (rel L2 < 1e-6); K11's round trip through it (the
    forward, times H, conjugated, the line's second transform, conjugated
    and / L, as fftconv4_mid_bluestein runs it) against
    np.fft.ifft(np.fft.fft(x) H) (rel L2 < 1e-6)."""
    g = kfft._line_geometry(length, 8)
    assert g == kfft.BluesteinLine(length, log2m, lanes)
    assert (1 << log2m) >= 2 * length - 1 > (1 << (log2m - 1))
    tab = _line_section(g.table(length), g)
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, 8))
    x = x[0] + 1j * x[1]
    got = _fwd(g, x, tab)
    assert _rel(got, np.fft.fft(x, axis=0)) < 1e-6
    h = rng.standard_normal((2, length, 1))
    h = h[0] + 1j * h[1]
    back = np.conj(_dit(g, np.conj(got * h), tab)) / length
    assert _rel(back, np.fft.ifft(np.fft.fft(x, axis=0) * h, axis=0)) < 1e-6


def _fftconv_frames(x: np.ndarray, h: np.ndarray, plan: kfft.FftPlan, hop: int) -> np.ndarray:
    """K11's frames through the planned body in numpy: one block a frame
    (fftconv_mixed_kernel: the forward in its order, H in that order, conj,
    the transposed order, conj / N) or the four-step's three kernels (cols;
    mid: rows, H, conj, the rows' transposed order, W_N^{c e}, into [c, e];
    out: columns over c, n = e + f2 g); the last hop samples of each frame
    kept."""
    n = plan.fft_size
    tabs = _sections(plan)
    overlap = n - hop
    frames = (x.shape[-1] - overlap) // hop
    y = np.empty(frames * hop, np.complex128)
    hk = h[plan.h_order()]
    for f in range(frames):
        fr = x[f * hop:f * hop + n].astype(np.complex128)
        if plan.body == "mixed":
            g = plan.lines[0]
            z = np.conj(_line_fwd(fr, g.p, g.log2m, tabs[0]) * hk)
            out = np.conj(_line_dit(z, g.p, g.log2m, tabs[0])) / n
        else:
            (g1, g2), (f1, f2) = plan.lines, plan.factors
            t1, t2, post1, post2 = tabs
            v = _fwd(g1, fr.reshape(f1, f2), t1) * post1.T                 # [c, b]
            xk = _fwd(g2, v.T, t2)                                         # [d, c]
            k = np.arange(f1)[None, :] + f1 * np.arange(f2)[:, None]
            e = _dit(g2, np.conj(xk * hk[k]), t2)                          # [e, c]
            s2 = e.T * post2                                               # [c, e]
            gg = _fwd(g1, s2, t1)                                          # [g, e]
            out = np.conj(gg.ravel()) / n                                  # n = e + f2 g
        y[f * hop:(f + 1) * hop] = out[overlap:]
    return y


@pytest.mark.parametrize("n,num_taps,per_channel", [(12288, 3000, False), (16384, 4096, False),
                                                    (16384, 4096, True), (17408, 4352, False)])
def test_fftconv_plain_matches_jax_direct_fir_and_schedule(n, num_taps, per_channel):
    """K11's plain version at the new sizes against the JAX kernel in
    interpret mode and a float64 direct FIR; the planned body's frames (one
    block a frame at 12288 and 16384, the four-step at 17408) in numpy
    against the plain version."""
    c = 2
    taps = (np.stack([lowpass(num_taps, 0.05 * (i + 1)) for i in range(c)]) if per_channel
            else lowpass(num_taps, 0.1))
    tk = kfc.make_fftconv_kernel(taps, n, num_channels=c, b_frames=1, device="cpu")
    jk = jmake_fftconv(taps, n, num_channels=c, b_frames=1, interpret=True)
    assert (tk.hop, tk.overlap, tk.n1, tk.block_in()) == (jk.hop, jk.overlap, jk.n1,
                                                           jk.block_in())
    frames = 2
    rng = np.random.default_rng(n + num_taps + per_channel)
    x = rng.standard_normal((c, 2, tk.overlap + frames * tk.hop)).astype(np.float32)
    x[:, :, :tk.overlap] = 0.0
    tr, ti = kfc.fftconv_pallas(tk, torch.from_numpy(x))
    jr, ji = jfftconv_pallas(jk, jnp.asarray(x))
    plan = kfft.fft_plan(n)
    h2 = kfc.freq_response_planes(taps, n)
    for ch in range(c):
        got = tr[ch].numpy() + 1j * ti[ch].numpy()
        assert _snr_db(np.asarray(jr[ch]) + 1j * np.asarray(ji[ch]), got) > 100
        xc = x[ch, 0, tk.overlap:].astype(np.float64) + 1j * x[ch, 1, tk.overlap:]
        t = taps[ch] if per_channel else taps
        assert _snr_db(np.convolve(xc, t)[:xc.size], got) > 90
        hc = h2[ch if per_channel else 0]
        sched = _fftconv_frames(x[ch, 0] + 1j * x[ch, 1].astype(np.float64),
                                hc[0] + 1j * hc[1].astype(np.float64), plan, tk.hop)
        assert _snr_db(got, sched) > 100


@pytest.mark.parametrize("n,n2", [(12288, 128), (11264, 128), (65536, 128),
                                  (1024 * 1021, 128)])
def test_tables_hold_each_constant_once_rounded(n, n2):
    """Every entry of the plan's table is its value rounded once from float64:
    a register line's odd section W_L^{j k} at (k - 1) M + j and its
    Stockham section (stockham_twiddles); a Bluestein line's Stockham
    section, B = FFT_M(b) / M with b[m] = W_{2L}^{-(m^2 mod 2L)} for |m| < L
    (m taken mod M), and the chirp W_{2L}^{n^2 mod 2L}, the exponents exact
    integers; the four-step's post entries W_N^{b c} and W_N^{c e}."""
    plan = kfft.fft_plan(n, n2)
    tab, offs = plan.tables()
    for g, off in zip(plan.lines, offs):
        if isinstance(g, kfft.LineShape):
            m, length = 1 << g.log2m, g.length
            j, k = np.arange(m)[None, :], np.arange(1, g.p)[:, None]
            want = np.exp(-2j * np.pi * (j * k) / length).ravel()
            size = (g.p - 1) * m
            np.testing.assert_array_equal(tab[off:off + size], want.real.astype(np.float32))
            np.testing.assert_array_equal(tab[off + size:off + 2 * size],
                                          want.imag.astype(np.float32))
            stock = kfft.stockham_twiddles(m).ravel()
            np.testing.assert_array_equal(tab[off + 2 * size:off + 2 * size + stock.size], stock)
            continue
        m, length = 1 << g.log2m, g.length
        stock = kfft.stockham_twiddles(m).ravel()
        np.testing.assert_array_equal(tab[off:off + stock.size], stock)
        signed = np.where(np.arange(m) < length, np.arange(m), np.arange(m) - m)
        b = np.where(np.abs(signed) < length,
                     np.exp(2j * np.pi * (signed * signed % (2 * length)) / (2 * length)), 0)
        big_b = np.fft.fft(b) / m
        at = off + stock.size
        np.testing.assert_array_equal(tab[at:at + m], big_b.real.astype(np.float32))
        np.testing.assert_array_equal(tab[at + m:at + 2 * m], big_b.imag.astype(np.float32))
        np.testing.assert_allclose(big_b, _dft(m) @ b / m, atol=1e-12)
        j = np.arange(length, dtype=np.int64)
        chirp = np.exp(-2j * np.pi * (j * j % (2 * length)) / (2 * length))
        at += 2 * m
        np.testing.assert_array_equal(tab[at:at + length], chirp.real.astype(np.float32))
        np.testing.assert_array_equal(tab[at + length:at + 2 * length],
                                      chirp.imag.astype(np.float32))
        assert g.table(n).size == stock.size + 2 * m + 2 * length
    if plan.body == "four_step":
        secs = _sections(plan)
        f1, f2 = plan.factors
        b, c = np.arange(f2)[:, None], np.arange(f1)[None, :]
        np.testing.assert_allclose(secs[2], np.exp(-2j * np.pi * b * c / n), atol=1e-7)
        np.testing.assert_allclose(secs[3], np.exp(-2j * np.pi * c.T * b.T / n), atol=1e-7)


def _dft(m: int) -> np.ndarray:
    """The m-point DFT matrix in float64, exponents j k mod m exact."""
    j = np.arange(m)
    return np.exp(-2j * np.pi * (np.outer(j, j) % m) / m)


def test_odd_dft_literals_are_float64_rounded_once():
    """fft_lines.cuh kOddTrig holds, for P = 3, 5, ..., 15 at _odd_trig_offset,
    cos and sin of 2 pi j / P as the float32 rounding of the float64 values,
    bit for bit."""
    src = (Path(kfft.__file__).resolve().parents[1] / "csrc" / "fft_lines.cuh").read_text()
    body = re.search(r"kOddTrig\[(\d+)\] = \{(.*?)\};", src, re.S)
    lits = np.array([float(v) for v in re.findall(r"(-?\d\.\d+(?:e-?\d+)?)f", body.group(2))],
                    np.float32)
    assert lits.size == int(body.group(1)) == kfft._odd_trig_offset(17)
    for p in kfft.ODD_FACTORS:
        want = kfft._odd_trig(p).ravel()
        at = kfft._odd_trig_offset(p)
        np.testing.assert_array_equal(lits[at:at + want.size], want)


@pytest.mark.parametrize("source,macro,shapes", [
    ("fft_mixed.cu", "MIXED_SHAPES", kfft.MIXED_SHAPES),
    ("fft_4step.cu", "FOUR_STEP_LINES", kfft.FOUR_STEP_LINES),
    ("fft_4step.cu", "BLUESTEIN_LINES", tuple((m,) for m in kfft.BLUESTEIN_LOG2M))])
def test_instantiated_shapes_match_the_sources(source, macro, shapes):
    """The shapes the host plans with are the ones the CUDA source
    instantiates, in its order: fft_mixed.cu MIXED_SHAPES and fft_4step.cu
    FOUR_STEP_LINES ((P, log2 M) each) and BLUESTEIN_LINES (log2 M) against
    their Python tuples."""
    src = (Path(kfft.__file__).resolve().parents[1] / "csrc" / source).read_text()
    body = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)\n", src)
    got = tuple(tuple(int(v) for v in args.split(","))
                for args in re.findall(r"X\(([\d, ]+)\)", body.group(1)))
    assert got == tuple(shapes)


# --- shared-memory banks -------------------------------------------------------

def _worst_bank(addrs) -> int:
    """Largest number of distinct 4-byte words one bank serves for one
    warp's addresses (rows of addrs, or a list of them)."""
    worst = 0
    for row in (addrs if isinstance(addrs, list) else np.atleast_2d(addrs)):
        for b in range(32):
            worst = max(worst, len(set(row[row % 32 == b].tolist())))
    return worst


@pytest.mark.parametrize("p,log2m", kfft.MIXED_SHAPES)
def test_one_block_and_tile_banks_at_most_two_way(p, log2m):
    """The one-block body (fft_mixed.cu) at N = p 2^log2m: the odd pass's
    writes (row n_m + M k at pad(n_m) + k (M + M/32)), the sub-transforms'
    loads, the staging write of register s of thread (k_p, t) at
    _mixed_stage(k_p + P (t + (M/16) s)), and its reads by the natural store
    and the digit store at every n2 of the domain; and the four-step's tiles
    on phase 23's register lines (2^20: 1024 x 8 lanes; 65536: 512 x 16 and
    128 x 64; 21504: 96 x 32 and 224 x 32): cp.async writes, the odd pass's
    rows, the sub-transforms' loads, exchanges, staging and the row-order
    reads; and the Bluestein lines' tiles (M x lanes: 512 x 16 at 136
    points, 1024 x 8 at 272, 2048 x 4 at 1021 and 864, 2048 x 2 at 1018,
    4096 x 2 at 2040), their cp.async writes and row-order reads over L
    rows, their transforms' loads, exchanges and staging over M. Each
    warp's 32 accesses touch a bank at most twice."""
    m, n = 1 << log2m, p << log2m
    t_count, _, _ = kfft._mixed_shape(p, log2m)
    tm_count, _, _ = kfft._line_shape(p, log2m)
    t = np.arange(t_count).reshape(-1, 32)
    kp, tm = t // tm_count, t % tm_count
    sub = m + m // 32
    worst = 0
    for i in range(-(-m // t_count)):
        nm = t + t_count * i
        nm = np.where(nm < m, nm, nm % m)
        for k in range(p):
            worst = max(worst, _worst_bank(kfft.regs_pad(nm) + k * sub))
    for s in range(kfft.REGS_VALS):
        worst = max(worst, _worst_bank(kp * sub + kfft.regs_pad(tm + tm_count * s)),
                    _worst_bank(kfft._mixed_stage(kfft._line_order(p, log2m, kp, tm, s))),
                    _worst_bank(kfft._mixed_stage(t + t_count * s)))
    q = np.arange(n).reshape(-1, 32)
    for n2 in range(128, n + 1, 128):
        if n % n2 or (n // n2) % 8:
            continue
        n1 = n // n2
        worst = max(worst, _worst_bank(kfft._mixed_stage((q % n2) * n1 + q // n2)))
    assert worst <= 2
    # the four-step's tiles of phase 23's register lines (21504: 96 x 224 on
    # (3, 5) and (7, 5), 32 lanes each), then of Bluestein lines (P = 1 on M
    # rows, L of them loaded and stored)
    tiles = [(*kfft._reg_line(length), lanes, length)
             for length, lanes in ((1024, 8), (512, 16), (128, 64), (96, 32), (224, 32))]
    tiles += [(1, lm, lanes, length) for lm, lanes, length in
              ((9, 16, 136), (10, 8, 272), (11, 4, 1021), (11, 4, 864), (11, 2, 1018),
               (12, 2, 2040))]
    for lp, lm, lanes, length in tiles:
        log2lanes = lanes.bit_length() - 1
        tl_all = np.arange((lanes * lp << lm) // kfft.REGS_VALS)
        lane, tl = tl_all % lanes, tl_all // lanes
        tmc, tlc, _ = kfft._line_shape(lp, lm)
        kp, tm, mm_ = tl // tmc, tl % tmc, 1 << lm
        worst = _worst_bank(_warps(kfft.regs_pad(np.arange(lanes * length))))
        for i in range(-(-mm_ // tlc) if lp > 1 else 0):   # the odd pass's rows
            nm = tl + tlc * i
            nm = np.where(nm < mm_, nm, nm % mm_)
            for k in range(lp):
                worst = max(worst, _worst_bank(kfft._line_at(nm + mm_ * k, lane, log2lanes)
                                               .reshape(-1, 32)))
        for r, ns in kfft.regs_passes(lm)[:-1]:
            g_count = kfft.REGS_VALS // r
            for g in range(g_count):
                j = tm + tmc * g
                for mm in range(r):
                    e = kp * mm_ + kfft.regs_store_index(j, r, ns, mm)
                    worst = max(worst, _worst_bank(kfft._line_at(e, lane, log2lanes)
                                                   .reshape(-1, 32)))
        for s in range(kfft.REGS_VALS):
            e = kfft._line_order(lp, lm, kp, tm, s)
            worst = max(worst, _worst_bank(kfft._line_at(e, lane, log2lanes).reshape(-1, 32)),
                        _worst_bank(kfft._line_at(kp * mm_ + tm + tmc * s, lane, log2lanes)
                                    .reshape(-1, 32)))
        u = np.arange(lanes * length)
        worst = max(worst, _worst_bank(_warps(kfft._line_at(u % length, u // length,
                                                            log2lanes))))
        assert worst <= 2, (length, lanes, worst)


def _warps(a: np.ndarray) -> list:
    """A flat array of a loop's addresses as its warps' rows of 32 (the last
    one shorter)."""
    return [a[i:i + 32] for i in range(0, a.size, 32)]


# --- K10's plain version against the JAX kernel ------------------------------

@pytest.mark.parametrize("order", [True, False, "kernel"])
@pytest.mark.parametrize("n,n2", [(3072, 128), (3072, 384), (16384, 128)])
def test_plain_fft_matches_jax_interpret(n, n2, order):
    """The port's plain K10 (the JAX kernel's factorization at n1 = N / n2)
    against the JAX kernel in interpret mode and complex128, 2 frames."""
    b = 2
    jk = jmake_fft_kernel(n, n2=n2, b_frames=1, natural_order=order, interpret=True)
    tk = kfft.make_fft_kernel(n, n2=n2, b_frames=1, natural_order=order, device="cpu")
    assert (tk.n1, tk.n2) == (jk.n1, jk.n2)
    x = np.random.default_rng(n + n2).standard_normal((2, b, n)).astype(np.float32)
    jr, ji = jk.fn(jnp.asarray(x[0]), jnp.asarray(x[1]))
    tr, ti = tk.fn(torch.from_numpy(x[0]), torch.from_numpy(x[1]))
    got = tr.numpy() + 1j * ti.numpy()
    assert tuple(got.shape) == tuple(jr.shape)
    assert _snr_db(np.asarray(jr) + 1j * np.asarray(ji), got) > 120
    ref = np.fft.fft(x[0].astype(np.float64) + 1j * x[1], axis=-1)
    if order is False:
        ref = ref.reshape(b, n2, n // n2).swapaxes(-1, -2).reshape(got.shape)
    assert _snr_db(ref, got) > 110


# --- the plan ----------------------------------------------------------------

def test_plan_domain_and_bodies():
    """Every size of the domain gets its body and lines within the
    shared-memory and thread budgets; sizes outside raise with the rule."""
    for n, n2, body in [(256, 128, "regs"), (8192, 128, "regs"), (4096, 64, "regs"),
                        (3072, 384, "mixed"), (1024 * 15, 128, "mixed"),
                        (1024 * 13, 128, "mixed"), (16384, 128, "mixed"),
                        (16384, 2048, "mixed"), (17408, 128, "four_step"),
                        (1 << 20, 1024, "four_step"), (1 << 20, 128, "four_step"),
                        (6144, 384, "mixed"), (1024 * 1023, 128, "four_step"),
                        (3 << 15, 128, "four_step"), (21504, 128, "four_step"),
                        (27 << 15, 128, "four_step")]:
        plan = kfft.fft_plan(n, n2)
        assert plan.body == body, (n, n2)
        tab, offs = plan.tables()
        assert len(offs) == {"regs": 1, "mixed": 1, "four_step": 4}[body]
        for g in plan.lines:
            assert g.smem_bytes() + 256 <= 232448            # a block's shared memory
            if isinstance(g, kfft.LineShape):
                assert g.threads <= 1024
                assert (g.p, g.log2m) in (kfft.MIXED_SHAPES if body == "mixed"
                                          else kfft.FOUR_STEP_LINES)
            else:
                assert isinstance(g, kfft.BluesteinLine) and kfft._reg_line(g.length) is None
                assert g.log2m in kfft.BLUESTEIN_LOG2M and 1 << g.log2m >= 2 * g.length - 1
                assert g.threads <= 512 and g.lanes << g.log2m <= kfft.LINE_TILE
        if body == "four_step":
            f1, f2 = plan.factors
            assert f1 * f2 == n and tab.size == offs[3] + 2 * n
            assert f2 % plan.lines[0].lanes == 0 and f1 % plan.lines[1].lanes == 0
    # 136 = 17 x 8 and 1021: Bluestein lines on M = 512 and 2048
    assert kfft.fft_plan(17408).lines == (kfft.BluesteinLine(136, 9, 16),
                                          kfft.LineShape(1, 7, 8))
    assert kfft.fft_plan(1024 * 1021).lines == (kfft.LineShape(1, 10, 1),
                                                kfft.BluesteinLine(1021, 11, 4))
    assert kfft.fft_plan(21504).lines == (kfft.LineShape(3, 5, 32), kfft.LineShape(7, 5, 32))
    # 27 x 2^15: no two lines of 2^5 ... 2^7 points beside an odd factor make 2^15, so
    # the 864-point rows (27 x 32) are a Bluestein line
    assert kfft.fft_plan(27 << 15).lines == (kfft.LineShape(1, 10, 8),
                                             kfft.BluesteinLine(864, 11, 4))
    assert kfft.fft_plan(3 << 15).factors == (384, 256)
    for n, n2 in [(1536, 128), (1000, 128), (1 << 21, 128), (3072, 256), (128, 128)]:
        with pytest.raises(ValueError, match="n2 % 128 == 0 and n1 % 8 == 0"):
            kfft.fft_plan(n, n2)
