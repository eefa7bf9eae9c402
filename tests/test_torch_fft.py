"""Port vs JAX package: the four-step plane FFT (``ops/fft_planes``), the
batched FFT kernel K10's plain version (``kernels/fft_pallas``) and the
oracle's FFT binding.

Contracts:

- `make_fft_planes` against the JAX function on the same input: rel L2
  < 1e-6 (the same constants and stage order; float32 products summed in
  another order), and < 1e-5 against the C++ oracle (the reference's bar);
- `fft_planes_flops`, the kernel's constants and the oracle binding: equal;
- K10's plain version against the JAX kernel run with ``interpret=True``, in
  all three output orders: SNR > 120 dB (the same factorization); against
  numpy (complex128): > 110 dB, the reference's bar;
- the digit layout: X[k1 + n1*k2] at frame row k1, lane k2 (n1 = N / n2);
  natural == digit + unscramble bit for bit;
- the conj inverse round trip: > 110 dB;
- the CUDA kernel's schedule (``csrc/fft_regs.cuh``, mirrored in
  ``kernels/fft_pallas``: pass radices, Stockham index maps, twiddle
  exponents and table, the padded exchange address) run thread by thread in
  float64 numpy: rel L2 < 1e-6 against ``np.fft.fft`` for every N the card
  takes (the float32 twiddle table leaves ~1e-8); every element written once
  per exchange; no warp's exchange write or read, nor the digit-order
  staging at n2 128, touching a shared-memory bank more than twice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import oracle as joracle
from srcdsp_tpu.kernels.fft_pallas import make_fft_kernel as jmake_fft_kernel
from srcdsp_tpu.ops.fft_planes import fft_planes_flops as jflops
from srcdsp_tpu.ops.fft_planes import make_fft_planes as jmake_fft_planes
from srcdsp_tpu_torch import oracle as toracle
from srcdsp_tpu_torch.kernels import fft_pallas as kfft
from srcdsp_tpu_torch.ops.fft_planes import fft_planes_flops, make_fft_planes
from tests.torch_threads import one_torch_thread  # noqa: F401


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    err = np.mean(np.abs(got - ref) ** 2)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / (err + 1e-30)))


def _rel(got, ref) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(ref)) / np.linalg.norm(ref))


def _planes(rng, b, n):
    x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    return x, np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)


@pytest.mark.parametrize("n,n1", [(64, 8), (256, 16), (1024, 32), (4096, 64), (512, 16)])
def test_fft_planes_matches_jax(n, n1):
    x, xr, xi = _planes(np.random.default_rng(n), 3, n)
    jr, ji = jmake_fft_planes(n, n1)(jnp.asarray(xr), jnp.asarray(xi))
    tr, ti = make_fft_planes(n, n1, device="cpu")(torch.from_numpy(xr), torch.from_numpy(xi))
    got = tr.numpy() + 1j * ti.numpy()
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < 1e-6
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=-1)) < 1e-5


def test_fft_planes_default_factor_and_oracle():
    x, xr, xi = _planes(np.random.default_rng(1), 1, 1024)
    tr, ti = make_fft_planes(1024, device="cpu")(torch.from_numpy(xr), torch.from_numpy(xi))
    got = (tr.numpy() + 1j * ti.numpy())[0]
    jr, ji = jmake_fft_planes(1024)(jnp.asarray(xr), jnp.asarray(xi))
    assert _rel(got, (np.asarray(jr) + 1j * np.asarray(ji))[0]) < 1e-6
    assert _rel(got, toracle.fft(x[0])) < 1e-5
    with pytest.raises(ValueError):
        make_fft_planes(100, device="cpu")


@pytest.mark.parametrize("batch,n,n1", [(16, 4096, None), (3, 1024, 8), (8192, 4096, 32)])
def test_fft_planes_flops_equal(batch, n, n1):
    assert fft_planes_flops(batch, n, n1) == jflops(batch, n, n1)


@pytest.mark.parametrize("n", [16, 1024, 4096])
def test_oracle_fft_equals_jax_binding(n):
    x, _, _ = _planes(np.random.default_rng(n + 1), 1, n)
    for inverse in (False, True):
        np.testing.assert_array_equal(toracle.fft(x[0], inverse), joracle.fft(x[0], inverse))
    with pytest.raises(ValueError, match="power-of-two"):
        toracle.fft(np.zeros(12, np.complex64))


@pytest.mark.parametrize("n,n2,b", [(4096, 128, 4), (1024, 256, 2)])
def test_kernel_consts_equal_jax(n, n2, b):
    jk = jmake_fft_kernel(n, n2=n2, b_frames=b, interpret=True)
    tk = kfft.make_fft_kernel(n, n2=n2, b_frames=b, device="cpu")
    assert (tk.n1, tk.n2, tk.b_frames, tk.fft_size) == (jk.n1, jk.n2, jk.b_frames, jk.fft_size)
    for t, j in zip(tk.consts, jk.consts):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("order", [True, False, "kernel"])
@pytest.mark.parametrize("n,n2,b", [(4096, 128, 4), (2048, 128, 2), (1024, 128, 8)])
def test_kernel_plain_matches_jax_interpret(n, n2, b, order):
    jk = jmake_fft_kernel(n, n2=n2, b_frames=b, natural_order=order, interpret=True)
    tk = kfft.make_fft_kernel(n, n2=n2, b_frames=b, natural_order=order, device="cpu")
    x, xr, xi = _planes(np.random.default_rng(n), 2 * b, n)
    jr, ji = jk.fn(jnp.asarray(xr), jnp.asarray(xi))
    tr, ti = tk.fn(torch.from_numpy(xr), torch.from_numpy(xi))
    assert tuple(tr.shape) == tuple(jr.shape)
    got = tr.numpy() + 1j * ti.numpy()
    assert _snr_db(np.asarray(jr) + 1j * np.asarray(ji), got) > 120
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    if order is False:
        ref = ref.reshape(2 * b, n2, n // n2).swapaxes(-1, -2).reshape(got.shape)
    assert _snr_db(ref, got) > 110


def test_transposed_digit_layout():
    """natural_order=False returns X[k1 + n1*k2] at frame row k1, lane k2,
    with the kernel's n1 = N / n2 (8 at 1024 points), not fft_planes' 32."""
    k = kfft.make_fft_kernel(1024, n2=128, b_frames=2, natural_order=False, device="cpu")
    assert k.n1 == 8
    x = np.random.default_rng(2).standard_normal((2, 1024)).astype(np.float32)
    yr, yi = k.fn(torch.from_numpy(x), torch.zeros(2, 1024))
    got = (yr.numpy() + 1j * yi.numpy()).reshape(2, k.n1, 128)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1).reshape(2, 128, k.n1)
    assert _snr_db(ref.swapaxes(-1, -2), got) > 110


def test_natural_equals_digit_unscrambled_bit_for_bit():
    x, xr, xi = _planes(np.random.default_rng(4), 4, 2048)
    xr_t, xi_t = torch.from_numpy(xr), torch.from_numpy(xi)
    nat = kfft.make_fft_kernel(2048, b_frames=2, device="cpu").fn(xr_t, xi_t)
    knat = kfft.make_fft_kernel(2048, b_frames=2, natural_order="kernel", device="cpu").fn(
        xr_t, xi_t)
    dk = kfft.make_fft_kernel(2048, b_frames=2, natural_order=False, device="cpu")
    dig = dk.fn(xr_t, xi_t)
    for a, b_, d in zip(nat, knat, dig):
        assert torch.equal(a, b_)
        assert torch.equal(a, kfft.unscramble(d, dk.n1, dk.n2))


def test_ifft_round_trip():
    k = kfft.make_fft_kernel(2048, b_frames=2, device="cpu")
    _, xr, xi = _planes(np.random.default_rng(3), 4, 2048)
    yr, yi = k.fn(torch.from_numpy(xr), torch.from_numpy(xi))
    rr, ri = kfft.ifft_pallas(k, yr, yi)
    assert _snr_db(xr, rr.numpy()) > 110
    assert _snr_db(xi, ri.numpy()) > 110


def test_kernel_rejects_bad_shapes():
    with pytest.raises(ValueError, match="% n2"):
        kfft.make_fft_kernel(1000, n2=128, device="cpu")
    k = kfft.make_fft_kernel(1024, b_frames=4, device="cpu")
    with pytest.raises(ValueError, match="B % 4"):
        k.fn(torch.zeros(6, 1024), torch.zeros(6, 1024))
    with pytest.raises(ValueError, match="rows"):
        k.fn_rows(torch.zeros(8, 128), torch.zeros(8, 128))
    for bad in (1536, 1000, 1 << 21):
        with pytest.raises(ValueError, match="n2 % 128 == 0 and n1 % 8 == 0"):
            kfft.fft_plan(bad)
    assert [kfft.fft_plan(n).body for n in (256, 8192, 3072, 16384, 17408, 1 << 20)] == [
        "regs", "regs", "mixed", "mixed", "four_step", "four_step"]


def test_twiddle_table():
    tw = kfft.fft_twiddles(4096)
    assert tw.shape == (2, 2048) and tw.dtype == np.float32
    ref = np.exp(-2j * np.pi * np.arange(2048) / 4096)
    np.testing.assert_array_equal(tw[0], ref.real.astype(np.float32))
    np.testing.assert_array_equal(tw[1], ref.imag.astype(np.float32))


# --- the CUDA kernel's schedule (csrc/fft_regs.cuh), in numpy ---------------

def _dft(r: int) -> np.ndarray:
    k = np.arange(r)
    return np.exp(-2j * np.pi * np.outer(k, k) / r)


def _regs_dft(x: np.ndarray) -> np.ndarray:
    """fft_regs_dft on x [R, ...]: R <= 4 directly; R = 16 and 8 split n = 4 n1
    + n2, m = m1 + (R/4) m2 (the R/4-point DFTs over n1, W_R^{n2 m1}, the
    4-point DFTs over n2)."""
    r = x.shape[0]
    if r <= 4:
        return np.tensordot(_dft(r), x, axes=1)
    a = r // 4
    xs = x.reshape(a, 4, *x.shape[1:])                      # [n1, n2, ...]
    y = np.tensordot(_dft(a), xs, axes=1)                   # [m1, n2, ...]
    tw = np.exp(-2j * np.pi * np.outer(np.arange(a), np.arange(4)) / r)
    y = y * tw.reshape(a, 4, *([1] * (x.ndim - 1)))
    y = np.moveaxis(np.tensordot(_dft(4), y, axes=([1], [1])), 0, 1)  # [m1, m2, ...]
    return np.swapaxes(y, 0, 1).reshape(r, *x.shape[1:])   # y[m1 + a m2]


def _regs_fft(x: np.ndarray) -> np.ndarray:
    """One frame through the kernel's schedule: thread t's register s holds
    element t + T*s; each pass twiddles from the kernel's table, runs its
    butterflies and exchanges through the Stockham store map."""
    n = x.shape[-1]
    log2n = n.bit_length() - 1
    t_count = kfft.regs_shape(log2n)[0]
    t = np.arange(t_count)
    grid = t[:, None] + t_count * np.arange(kfft.REGS_VALS)[None, :]
    v = x[grid].astype(np.complex128)                       # [T, 16] registers
    tw = kfft.stockham_twiddles(n).astype(np.float64)
    tw = tw[0] + 1j * tw[1]
    passes = kfft.regs_passes(log2n)
    off = 0
    for q, (r, ns) in enumerate(passes):
        g_count = kfft.REGS_VALS // r
        for g in range(g_count):
            j = t + t_count * g
            regs = g + g_count * np.arange(r)
            if q:
                e = off + (np.arange(1, r)[:, None] - 1) * ns + (j % ns)[None, :]
                v[:, regs[1:]] *= tw[e].T
            v[:, regs] = _regs_dft(v[:, regs].T).T
        if q:
            off += (r - 1) * ns
        if q + 1 < len(passes):
            y = np.full(n, np.nan + 0j)
            for g in range(g_count):
                for m in range(r):
                    y[kfft.regs_store_index(t + t_count * g, r, ns, m)] = v[:, g + g_count * m]
            assert not np.isnan(y).any()
            v = y[grid]
    out = np.empty(n, np.complex128)
    out[grid] = v
    return out


@pytest.mark.parametrize("log2n", range(8, 14))
def test_regs_schedule_matches_numpy_fft(log2n):
    n = 1 << log2n
    x = np.random.default_rng(log2n).standard_normal((2, n))
    x = x[0] + 1j * x[1]
    assert _rel(_regs_fft(x), np.fft.fft(x)) < 1e-6


@pytest.mark.parametrize("log2n", range(8, 14))
def test_regs_twiddle_table_is_fft_twiddles(log2n):
    """Each table entry is W_N^e (e from the mirrored exponent map) as
    fft_twiddles rounds it, negated exactly for e >= N/2."""
    n = 1 << log2n
    table, tw = kfft.stockham_twiddles(n), kfft.fft_twiddles(n)
    got, at = [], 0
    for r, ns in kfft.regs_passes(log2n)[1:]:
        for m in range(1, r):
            e = kfft.regs_twiddle_exponent(np.arange(ns), r, ns, m, n)
            ref = np.where(e < n // 2, tw[:, e % (n // 2)], -tw[:, e % (n // 2)])
            np.testing.assert_array_equal(table[:, at:at + ns], ref)
            got.append(e)
            at += ns
    assert at == table.shape[1]
    e = np.concatenate(got)
    np.testing.assert_allclose(table[0] + 1j * table[1], np.exp(-2j * np.pi * e / n),
                               atol=1e-7)


def _worst_bank(addrs: np.ndarray) -> int:
    """Largest number of distinct 4-byte words one bank serves for a warp's
    32 addresses."""
    return max(len(set(addrs[addrs % 32 == b].tolist())) for b in range(32))


def _warps(log2n: int):
    """(t, frame-plane base) of the 32 lanes of each warp of a block."""
    t_count, frames, plane = kfft.regs_shape(log2n)
    for w in range(t_count * frames // 32):
        lane = 32 * w + np.arange(32)
        yield lane % t_count, 2 * plane * (lane // t_count)


@pytest.mark.parametrize("log2n", range(8, 14))
def test_regs_exchange_at_most_two_way_bank_conflicts(log2n):
    t_count = kfft.regs_shape(log2n)[0]
    worst = 0
    for r, ns in kfft.regs_passes(log2n)[:-1]:
        g_count = kfft.REGS_VALS // r
        for t, base in _warps(log2n):
            for g in range(g_count):
                for m in range(r):
                    a = kfft.regs_store_index(t + t_count * g, r, ns, m)
                    worst = max(worst, _worst_bank(base + kfft.regs_pad(a)))
            for s in range(kfft.REGS_VALS):
                worst = max(worst, _worst_bank(base + kfft.regs_pad(t + t_count * s)))
    assert worst <= 2


@pytest.mark.parametrize("log2n", range(8, 14))
def test_regs_digit_staging_at_most_two_way_bank_conflicts(log2n, n2=128):
    """The digit store's staging (fft.cu): natural write, then the read of
    X[k1 + n1 k2] for offset k1 n2 + k2, at the default n2."""
    t_count = kfft.regs_shape(log2n)[0]
    log2n2 = n2.bit_length() - 1
    worst = 0
    for t, base in _warps(log2n):
        for s in range(kfft.REGS_VALS):
            p = t + t_count * s
            k = ((p & (n2 - 1)) << (log2n - log2n2)) + (p >> log2n2)
            worst = max(worst, _worst_bank(base + kfft.regs_pad(p)),
                        _worst_bank(base + kfft.regs_pad(k)))
    assert worst <= 2


# --- K11's frame (csrc/fftconv.cu) on the same schedule, in numpy ------------

def _regs_fftconv(x: np.ndarray, h2: np.ndarray, n: int, hop: int) -> np.ndarray:
    """fftconv.cu's frames through the mirrored schedule: frame f is the n
    samples at f*hop of x [overlap + F*hop] (thread t's register s holds
    sample t + T*s); forward; register s times H[t + T*s] (natural order, as
    the forward leaves X[t + T*s] there) and conjugated; the same forward
    again; conjugated and scaled by 1/n; the registers with t + T*s >= overlap
    stored at f*hop + (t + T*s) - overlap."""
    log2n = n.bit_length() - 1
    t_count = kfft.regs_shape(log2n)[0]
    grid = np.arange(t_count)[:, None] + t_count * np.arange(kfft.REGS_VALS)[None, :]
    h = (h2[0] + 1j * h2[1]).astype(np.complex128)
    overlap = n - hop
    frames = (x.shape[-1] - overlap) // hop
    y = np.full(frames * hop, np.nan + 0j)
    for f in range(frames):
        z = np.empty(n, np.complex128)
        z[grid] = np.conj(_regs_fft(x[f * hop:f * hop + n])[grid] * h[grid])
        v = np.conj(_regs_fft(z)[grid]) / n
        keep = grid >= overlap
        y[f * hop + grid[keep] - overlap] = v[keep]
    assert not np.isnan(y).any()
    return y


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("n,n2,num_taps", [(256, 16, 17), (512, 32, 33), (1024, 64, 65),
                                           (2048, 128, 200), (4096, 128, 1024),
                                           (8192, 128, 1024)])
def test_fftconv_frame_schedule_matches_plain_and_jax(n, n2, num_taps, per_channel):
    """K11's frame on the register schedule against the port's plain K11 and
    the JAX kernel in interpret mode (> 100 dB, the K11 tests' bar), at the
    hops of fftconv_geometry, for every N the card takes."""
    from srcdsp_tpu.kernels.fftconv_pallas import fftconv_pallas as jfftconv_pallas
    from srcdsp_tpu.kernels.fftconv_pallas import make_fftconv_kernel as jmake_fftconv
    from srcdsp_tpu.ops.window import lowpass as jlowpass
    from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc

    c = 2
    taps = (np.stack([jlowpass(num_taps, 0.05 * (i + 1)) for i in range(c)]) if per_channel
            else jlowpass(num_taps, 0.1))
    tk = kfc.make_fftconv_kernel(taps, n, num_channels=c, n2=n2, b_frames=2, device="cpu")
    jk = jmake_fftconv(taps, n, num_channels=c, n2=n2, b_frames=2, interpret=True)
    assert (tk.hop, tk.overlap) == (jk.hop, jk.overlap)
    rng = np.random.default_rng(n + per_channel)
    x = rng.standard_normal((c, 2, tk.overlap + 2 * tk.block_in())).astype(np.float32)
    x[:, :, :tk.overlap] = 0.0
    tr, ti = kfc.fftconv_pallas(tk, torch.from_numpy(x))
    jr, ji = jfftconv_pallas(jk, jnp.asarray(x))
    h2 = kfc.freq_response_planes(taps, n)
    for ch in range(c):
        got = _regs_fftconv(x[ch, 0] + 1j * x[ch, 1], h2[ch if per_channel else 0], n, tk.hop)
        assert _snr_db(tr[ch].numpy() + 1j * ti[ch].numpy(), got) > 100
        assert _snr_db(np.asarray(jr[ch]) + 1j * np.asarray(ji[ch]), got) > 100
