"""K10 and K11 at the sizes past the powers of two up to 8192: the plan that
picks the card's body, the bodies' schedules in numpy, and the plain
versions against the JAX kernels.

Contracts:

- `fft_plan`'s domain is the JAX kernel's with interpret=False (n2 % 128 ==
  0 and n1 % 8 == 0) plus the powers of two from 256 to 8192, capped at
  2^20: one block a frame below 16384, the four-step from there;
- the schedules of ``csrc/fft_lines.cuh``, ``fft_mixed.cu`` and
  ``fft_4step.cu`` (mirrored in ``kernels/fft_pallas``: radices, spans,
  butterfly elements, twiddle and direct-DFT exponents, the rev table, the
  four-step's input, twiddle and scratch maps, the digit store) run in
  float64 numpy on the float32 twiddle table: rel L2 < 1e-6 against
  ``np.fft.fft`` (the table's rounding leaves ~1e-7); the digit store equal
  to the natural store permuted, exactly (the same values moved); the
  transposed (DIT) passes after the forward ones give N x back, rel L2 <
  1e-6;
- K10's plain version against the JAX kernel with ``interpret=True`` in all
  three orders: SNR > 120 dB (the same factorization and constants, float32
  products summed in another order), against complex128 > 110 dB (the
  reference's bar);
- K11's plain version against the JAX kernel in interpret mode: > 100 dB
  (the K11 tests' bar); against a direct FIR in float64: > 90 dB (the
  reference's bar against the oracle's direct FIR); the kernel's frame
  schedule in numpy against the plain version: > 100 dB.
"""

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


def _cplx(t: np.ndarray) -> np.ndarray:
    t = t.astype(np.float64)
    return t[0] + 1j * t[1]


def _tables(plan: kfft.FftPlan):
    """The plan's table split as the kernels take it: each line geometry's
    section, then (four-step) the two post-twiddles [f2, f1] and [f1, f2]."""
    tab = _cplx(plan.tables()[0])
    out, at = [], 0
    for g in plan.lines:
        size = kfft._line_table(g, plan.fft_size).shape[1]
        out.append(tab[at:at + size])
        at += size
    if plan.body == "four_step":
        f1, f2 = plan.factors
        n = plan.fft_size
        out += [tab[at:at + n].reshape(f2, f1), tab[at + n:at + 2 * n].reshape(f1, f2)]
        assert at + 2 * n == tab.size
    return out


# --- the bodies' schedules in numpy ------------------------------------------

def _passes(v: np.ndarray, g: kfft.LineGeometry, tab: np.ndarray, dit: bool) -> np.ndarray:
    """fft_lines.cuh lines_transform on v [L, lines] (element j of a line at
    v[j]): every pass in place at _line_elements, its DFT constants at
    _line_dft_index and its twiddles at _line_twiddle_index of the geometry's
    table, the twiddles before the DFT for DIT, after it for DIF; DIT runs
    the passes in reverse."""
    v = v.copy()
    length = g.length
    spans = kfft._line_spans(g.radices, length)
    offs = kfft._line_table_offsets(g.radices, length)
    order = range(len(g.radices) - 1, -1, -1) if dit else range(len(g.radices))
    for q in order:
        r, m, off = g.radices[q], spans[q], offs[q]
        bf = np.arange(length // r)[:, None]
        k = np.arange(r)[None, :]
        idx = kfft._line_elements(bf, m, r, k)                        # [bf, R]
        tw = np.where(k == 0, 1.0, tab[kfft._line_twiddle_index(bf, m, np.maximum(k, 1), off)])
        dft = tab[kfft._line_dft_index(k.T, k, r, m, off)]            # [n, k]
        x = v[idx]                                                   # [bf, R, lines]
        if dit:
            x = x * tw[..., None]
        y = np.matmul(dft.T[None], x)                                # [bf, k, lines]
        if not dit:
            y = y * tw[..., None]
        v[idx] = y
    return v


def _mixed_fft(x: np.ndarray, plan: kfft.FftPlan, digit: bool) -> np.ndarray:
    """fft_mixed.cu fft_mixed_kernel on one frame: the DIF passes, then offset
    q takes X[k] from rev[k], k = q (natural) or (q mod n2) n1 + q div n2."""
    n = plan.fft_size
    g = plan.lines[0]
    v = _passes(x[:, None].astype(np.complex128), g, _tables(plan)[0], False)[:, 0]
    q = np.arange(n)
    k = (q % plan.n2) * plan.n1 + q // plan.n2 if digit else q
    return v[kfft._line_rev(g.radices, n)[k]]


def _four_step_fft(x: np.ndarray, plan: kfft.FftPlan, digit: bool) -> np.ndarray:
    """fft_4step.cu on one frame: step 1 over the f2 columns b of [f1, f2]
    (element a of column b at b + a f2), times W_N^{b c} (the first
    post-twiddle), into the scratch at b f1 + c; step 2 over the f1 lines c
    of the scratch, X[c + f1 d] stored at k or at its digit offset."""
    n = plan.fft_size
    (g1, g2), (f1, f2) = plan.lines, plan.factors
    t1, t2, post1, _ = _tables(plan)
    b, a = np.arange(f2)[None, :], np.arange(f1)[:, None]
    v = _passes(x[b + a * f2].astype(np.complex128), g1, t1, False)
    c = np.arange(f1)[:, None]
    y = v[kfft._line_rev(g1.radices, f1)[c[:, 0]]] * post1.T          # [c, b] x W_N^{b c}
    s = np.empty(n, np.complex128)
    s[b * f1 + c] = y                          # [c, b] -> b f1 + c
    c_, b_ = np.arange(f1)[None, :], np.arange(f2)[:, None]
    v = _passes(s[c_ + b_ * f1], g2, t2, False)  # [b -> d, c]
    d = np.arange(f2)[:, None]
    xk = v[kfft._line_rev(g2.radices, f2)[d[:, 0]]]                   # [d, c] = X[c + f1 d]
    k = c_ + f1 * d
    out = np.empty(n, np.complex128)
    out[kfft._digit_position(k, plan.n1, plan.n2) if digit else k] = xk
    return out


SIZES = [(3072, 128), (5120, 128), (7168, 128), (11264, 128), (12288, 128), (16384, 128),
         (65536, 128), (1024 * 1021, 128)]


@pytest.mark.parametrize("n,n2", SIZES)
def test_body_schedule_matches_numpy_fft(n, n2):
    """The planned body's schedule (one block a frame below 16384, the
    four-step from there; 11264's 11 and 1021 as direct-DFT passes) against
    np.fft.fft; the digit store a permutation of the natural one; and, for
    one block a frame, the transposed passes taking the forward's order back
    to natural (K11's inverse): N x."""
    plan = kfft.fft_plan(n, n2)
    assert plan.body == ("mixed" if n < 16384 else "four_step")
    x = np.random.default_rng(n).standard_normal((2, n))
    x = x[0] + 1j * x[1]
    run = _mixed_fft if plan.body == "mixed" else _four_step_fft
    nat = run(x, plan, False)
    assert _rel(nat, np.fft.fft(x)) < 1e-6
    dig = run(x, plan, True)
    k = np.arange(n)
    np.testing.assert_array_equal(dig[kfft._digit_position(k, plan.n1, plan.n2)], nat)
    if plan.body == "mixed":
        g, tab = plan.lines[0], _tables(plan)[0]
        fwd = _passes(x[:, None], g, tab, False)                     # X at rev order
        back = np.conj(_passes(np.conj(fwd), g, tab, True)[:, 0])    # N x, natural order
        assert _rel(back, n * x) < 1e-6


def _fftconv_frames(x: np.ndarray, h: np.ndarray, plan: kfft.FftPlan, hop: int) -> np.ndarray:
    """K11's frames through the planned body in numpy: one block a frame
    (fftconv_mixed_kernel: DIF, H at rev[k], conj, DIT, conj / N) or the
    four-step's three kernels (fft4_step1, fftconv4_mid: rows, H, conj, the
    inverse's rows by DIT, W_N^{c e}, into [c, e]; fftconv4_out: columns
    over c, n = e + f2 g); the last hop samples of each frame kept."""
    n = plan.fft_size
    tabs = _tables(plan)
    overlap = n - hop
    frames = (x.shape[-1] - overlap) // hop
    y = np.empty(frames * hop, np.complex128)
    for f in range(frames):
        fr = x[f * hop:f * hop + n].astype(np.complex128)
        if plan.body == "mixed":
            g = plan.lines[0]
            rev = kfft._line_rev(g.radices, n)
            v = _passes(fr[:, None], g, tabs[0], False)[:, 0]
            v[rev] = np.conj(v[rev] * h)
            out = np.conj(_passes(v[:, None], g, tabs[0], True)[:, 0]) / n
        else:
            (g1, g2), (f1, f2) = plan.lines, plan.factors
            t1, t2, post1, post2 = tabs
            rev1, rev2 = kfft._line_rev(g1.radices, f1), kfft._line_rev(g2.radices, f2)
            b, a = np.arange(f2)[None, :], np.arange(f1)[:, None]
            c = np.arange(f1)[:, None]
            v = _passes(fr[b + a * f2], g1, t1, False)
            s = np.empty(n, np.complex128)
            s[b * f1 + c] = v[rev1] * post1.T
            c_, b_ = np.arange(f1)[None, :], np.arange(f2)[:, None]
            v = _passes(s[c_ + b_ * f1], g2, t2, False)
            d = np.arange(f2)[:, None]
            v[rev2] = np.conj(v[rev2] * h[c_ + f1 * d])               # [d at rev, c]
            v = _passes(v, g2, t2, True)                              # [e, c], natural e
            e = np.arange(f2)[:, None]
            s2 = np.empty(n, np.complex128)
            s2[c_ * f2 + e] = v * post2.T                             # [c, e] at c f2 + e
            e_, cc = np.arange(f2)[None, :], np.arange(f1)[:, None]
            v = _passes(s2[e_ + cc * f2], g1, t1, False)
            gg = np.arange(f1)[:, None]
            out = np.empty(n, np.complex128)
            out[e_ + f2 * gg] = np.conj(v[rev1]) / n
        y[f * hop:(f + 1) * hop] = out[overlap:]
    return y


@pytest.mark.parametrize("n,num_taps,per_channel", [(12288, 3000, False), (16384, 4096, False),
                                                    (16384, 4096, True)])
def test_fftconv_plain_matches_jax_direct_fir_and_schedule(n, num_taps, per_channel):
    """K11's plain version at the new sizes against the JAX kernel in
    interpret mode and a float64 direct FIR; the planned body's frames
    (one block a frame at 12288, the four-step at 16384) in numpy against
    the plain version."""
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


@pytest.mark.parametrize("n,n2", [(12288, 128), (11264, 128), (65536, 128)])
def test_tables_hold_each_constant_once_rounded(n, n2):
    """Every entry of the plan's table is W_N^e rounded once from float64 at
    the exponent its index stands for: twiddle (m, n0) of a pass
    _line_twiddle_exponent, DFT constant j W_R^j, the four-step's post
    entries W_N^{b c} and W_N^{c e}."""
    plan = kfft.fft_plan(n, n2)
    tabs = _tables(plan)
    for g, tab in zip(plan.lines, tabs):
        for r, m, off in zip(g.radices, kfft._line_spans(g.radices, g.length),
                             kfft._line_table_offsets(g.radices, g.length)):
            bf, k = np.arange(m)[None, :], np.arange(1, r)[:, None]
            e = kfft._line_twiddle_exponent(bf, m, r, k, n, g.length)
            want = np.exp(-2j * np.pi * e / n)
            got = tab[kfft._line_twiddle_index(bf, m, k, off)]
            np.testing.assert_array_equal(got.real, want.real.astype(np.float32))
            np.testing.assert_array_equal(got.imag, want.imag.astype(np.float32))
            j = np.arange(r)
            want = np.exp(-2j * np.pi * j / r)
            got = tab[kfft._line_dft_index(j, 1, r, m, off)]
            np.testing.assert_allclose(got, want, atol=1e-7)
    if plan.body == "four_step":
        f1, f2 = plan.factors
        b, c = np.arange(f2)[:, None], np.arange(f1)[None, :]
        np.testing.assert_allclose(tabs[2], np.exp(-2j * np.pi * b * c / n), atol=1e-7)
        np.testing.assert_allclose(tabs[3], np.exp(-2j * np.pi * c.T * b.T / n), atol=1e-7)


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
    """Every size of the domain gets its body and geometry within the
    shared-memory budget; sizes outside raise with the rule."""
    for n, n2, body in [(256, 128, "regs"), (8192, 128, "regs"), (4096, 64, "regs"),
                        (3072, 384, "mixed"), (1024 * 15, 128, "mixed"),
                        (1024 * 13, 128, "mixed"), (16384, 128, "four_step"),
                        (1 << 20, 1024, "four_step"), (1 << 20, 128, "four_step"),
                        (6144, 384, "mixed"), (1024 * 1023, 128, "four_step")]:
        plan = kfft.fft_plan(n, n2)
        assert plan.body == body, (n, n2)
        for g in plan.lines:
            assert np.prod(g.radices) == g.length
            assert g.smem_bytes() + 256 <= 232448            # a block's shared memory
            assert kfft.fft_plan(n, n2).tables()[1].size == sum(x.length for x in plan.lines)
        if body == "four_step":
            f1, f2 = plan.factors
            assert f1 * f2 == n and plan.lines[0].length == f1
            assert f2 % plan.lines[0].lanes == 0 and f1 % plan.lines[1].lanes == 0
    for n, n2 in [(1536, 128), (1000, 128), (1 << 21, 128), (3072, 256), (128, 128)]:
        with pytest.raises(ValueError, match="n2 % 128 == 0 and n1 % 8 == 0"):
            kfft.fft_plan(n, n2)
