"""Port vs JAX package: kernel K8 (fused NCO mix + rational L/M resample).

On a CPU tensor the port's wrappers run the plain PyTorch version (mix by the
exact u32 word, then the fixed-order polyphase sum of ``ops.resample``); it is
held against the Pallas kernel in interpret mode on the same numpy planes.
Contracts:

- host code (`toeplitz_resample`, `banded_resample_taps`,
  `combine_fir_resample_taps`): bit-equal to the JAX functions;
- against the Pallas kernel: rel L2 < 1e-5 (float32 sums in another order,
  and the JAX kernel factors its phasor into column x row angles);
- bit-exact: each channel of the multichannel form against the
  single-channel form, and chunked calls (history carried, word0 advanced by
  N*dword) against one call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import resample_pallas as jrp
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import resample_pallas as trp
from srcdsp_tpu_torch.ops.resample import resample_full

PAIRS = [(3, 4), (1, 2), (2, 3), (5, 4)]  # tests/unit/test_resample_kernel.py:15


def _rel(got, ref) -> float:
    """rel L2 < 1e-5 against the Pallas kernel (see the module docstring)."""
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _cplx(yr, yi):
    return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)


def _tile(up, down):
    """The reference test's tile: out_tile = block_cols, with block_cols*down % up == 0."""
    return 128 * up if (128 * down) % up else 128


def _combined():
    return trp.combine_fir_resample_taps(lowpass(128, 0.2), lowpass(48, 0.3), 3)


@pytest.mark.parametrize("up,down,out_tile,hist", [(3, 4, 384, 128), (2, 3, 96, 128),
                                                   (1, 2, 128, 256), (5, 4, 640, 128)])
def test_host_taps_bit_equal_to_jax(up, down, out_tile, hist):
    taps = lowpass(48, 0.3 / max(up, down))
    np.testing.assert_array_equal(trp.toeplitz_resample(taps, up, down, out_tile, hist),
                                  jrp.toeplitz_resample(taps, up, down, out_tile, hist))
    bc = out_tile // 2 if (out_tile // 2 * down) % up == 0 else out_tile
    np.testing.assert_array_equal(
        trp.banded_resample_taps(taps, up, down, out_tile, hist, bc),
        jrp.banded_resample_taps(taps, up, down, out_tile, hist, bc))


@pytest.mark.parametrize("up", [1, 3, 4])
def test_combined_taps_bit_equal_to_jax(up):
    h1, h2 = lowpass(128, 0.2), lowpass(48, 0.3)
    got = trp.combine_fir_resample_taps(h1, h2, up)
    np.testing.assert_array_equal(got, jrp.combine_fir_resample_taps(h1, h2, up))
    assert got.dtype == np.float32 and len(got) == 48 + up * 127


@pytest.mark.parametrize("up", [1, 3, 5])
def test_phase_taps_regroup_every_tap_once(up):
    h = np.arange(1, 430, dtype=np.float32)
    ph = trp.phase_taps(h, up)
    assert ph.shape == (up, -(-429 // up))
    for phi in range(up):
        np.testing.assert_array_equal(ph[phi, :len(h[phi::up])], h[phi::up])
    assert np.count_nonzero(ph) == 429


@pytest.mark.parametrize("up,down", [(3, 4), (1, 2), (2, 1), (4, 3)])
def test_plain_equals_dense_toeplitz_matmul(up, down):
    """The polyphase index map against `toeplitz_resample` used as a dense
    matrix (the ground truth of the band layout), row by row, at a tiny size;
    L = 1 and L > M included. rel L2 < 1e-6: the same products in float64."""
    taps = np.random.default_rng(up).standard_normal(37).astype(np.float32)
    ot = 12 * up
    k = trp.make_mix_resample_kernel(taps, up, down, out_tile=ot, b_rows=2, device="cpu")
    hist, stride = k.hist, ot * down // up
    x = np.random.default_rng(down).standard_normal((2, hist + 3 * k.block_in())
                                                    ).astype(np.float32)
    yr, yi = k.fn(0, 0, torch.from_numpy(x))
    h = trp.toeplitz_resample(taps, up, down, ot, hist).astype(np.float64)
    xc = x[0].astype(np.float64) + 1j * x[1]
    ref = np.stack([xc[r * stride:r * stride + stride + hist] @ h for r in range(yr.shape[0])])
    assert _rel(_cplx(yr, yi), ref) < 1e-6


@pytest.mark.parametrize("up,down", PAIRS)
def test_plain_matches_pallas_interpret(up, down):
    taps = lowpass(48, 0.3 / max(up, down))
    bc = _tile(up, down)
    jk = jrp.make_mix_resample_kernel(taps, up, down, out_tile=bc, b_rows=2, block_cols=bc,
                                      interpret=True)
    tk = trp.make_mix_resample_kernel(taps, up, down, out_tile=bc, b_rows=2, device="cpu")
    assert (tk.hist, tk.block_in()) == (jk.hist, jk.block_in())
    x = np.random.default_rng(up * 10 + down).standard_normal(
        (2, jk.hist + 4 * jk.block_in())).astype(np.float32)
    word = int(freq_to_word(0.123))
    word0 = (-jk.hist * word) % (1 << 32)
    jr, ji = jrp.mix_resample_pallas(jk, word0, word, jnp.asarray(x))
    tr, ti = trp.mix_resample(tk, word0, word, torch.from_numpy(x))
    assert tr.shape == jr.shape
    assert _rel(_cplx(tr, ti), _cplx(jr, ji)) < 1e-5


def test_combined_taps_plain_matches_pallas_interpret():
    """The config-2 geometry: 429 combined taps (hist 256), out_tile 384."""
    hc = _combined()
    jk = jrp.make_mix_resample_kernel(hc, 3, 4, out_tile=384, b_rows=2, block_cols=192,
                                      interpret=True)
    tk = trp.make_mix_resample_kernel(hc, 3, 4, out_tile=384, b_rows=2, device="cpu")
    assert (tk.hist, tk.block_in(), tk.num_taps) == (jk.hist, jk.block_in(), 429)
    assert tk.hist == 256
    x = np.random.default_rng(7).standard_normal((2, jk.hist + 2 * jk.block_in())
                                                 ).astype(np.float32)
    x[:, :jk.hist] = 0.0
    word = int(freq_to_word(0.07))
    word0 = (-jk.hist * word) % (1 << 32)
    jr, ji = jrp.mix_resample_pallas(jk, word0, word, jnp.asarray(x))
    tr, ti = trp.mix_resample(tk, word0, word, torch.from_numpy(x))
    assert _rel(_cplx(tr, ti), _cplx(jr, ji)) < 1e-5


def test_combined_taps_equal_fir_then_resample():
    """hc = h2 conv up_3(h1): one K8 over the mixed input equals the port's
    FIR(h1) -> resample(h2) chain, rel L2 < 5e-6 (the reference's bound)."""
    from srcdsp_tpu_torch.ops.fir import fir_full
    from srcdsp_tpu_torch.ops.nco import nco_apply, nco_init

    tk = trp.make_mix_resample_kernel(_combined(), 3, 4, out_tile=384, b_rows=2, device="cpu")
    rng = np.random.default_rng(5)
    n = 2 * tk.block_in()
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    planes = np.zeros((2, tk.hist + n), np.float32)
    planes[0, tk.hist:], planes[1, tk.hist:] = x.real, x.imag
    word = int(freq_to_word(0.07))
    tr, ti = trp.mix_resample(tk, (-tk.hist * word) % (1 << 32), word,
                              torch.from_numpy(planes))
    _, mixed = nco_apply(word, nco_init(device="cpu"), torch.from_numpy(x))
    ref = resample_full(lowpass(48, 0.3), fir_full(lowpass(128, 0.2), mixed), 3, 4)
    assert _rel(_cplx(tr, ti)[0], ref.numpy()) < 5e-6


def test_mc_matches_pallas_and_each_channel_equals_single():
    up, down, c = 3, 4, 4
    taps = lowpass(48, 0.3 / down)
    jk = jrp.make_mix_resample_kernel_mc(taps, up, down, c, out_tile=384, b_rows=2,
                                         block_cols=384, interpret=True)
    tk = trp.make_mix_resample_kernel_mc(taps, up, down, c, out_tile=384, b_rows=2,
                                         device="cpu")
    t1 = trp.make_mix_resample_kernel(taps, up, down, out_tile=384, b_rows=2, device="cpu")
    words = np.asarray([int(freq_to_word(0.02 * (i + 1))) for i in range(c)], np.uint32)
    words0 = np.asarray([(-tk.hist * int(w)) % (1 << 32) for w in words], np.uint32)
    x = np.random.default_rng(11).standard_normal((c, 2, tk.hist + 2 * tk.block_in())
                                                  ).astype(np.float32)
    jr, ji = jrp.mix_resample_pallas_mc(jk, words0, words, jnp.asarray(x))
    tr, ti = trp.mix_resample_mc(tk, words0, words, torch.from_numpy(x))
    assert tr.shape == jr.shape
    assert _rel(_cplx(tr, ti), _cplx(jr, ji)) < 1e-5
    for i in range(c):
        r1, i1 = trp.mix_resample(t1, int(words0[i]), int(words[i]), torch.from_numpy(x[i]))
        assert torch.equal(tr[i], r1[0]) and torch.equal(ti[i], i1[0])


@pytest.mark.parametrize("up,down", [(3, 4), (2, 1)])
def test_chunked_equals_one_shot_bit_exact(up, down):
    """Two calls, the second with the last hist samples of the first's input
    prepended and word0 advanced by N1*dword, equal one call bit for bit."""
    hc = trp.combine_fir_resample_taps(lowpass(16, 0.2), lowpass(24, 0.3), up)
    k = trp.make_mix_resample_kernel_mc(hc, up, down, 2, out_tile=96 * up, b_rows=2,
                                        device="cpu")
    n1 = 2 * k.block_in()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 2, k.hist + n1 + 3 * k.block_in())).astype(np.float32))
    words = [int(freq_to_word(0.07)), int(freq_to_word(-0.21))]
    words0 = [(-k.hist * w) % (1 << 32) for w in words]
    yr, yi = trp.mix_resample_mc(k, words0, words, x)
    ar, ai = trp.mix_resample_mc(k, words0, words, x[..., :k.hist + n1].contiguous())
    w1 = [(w0 + n1 * w) % (1 << 32) for w0, w in zip(words0, words)]
    br, bi = trp.mix_resample_mc(k, w1, words, x[..., n1:].contiguous())
    assert torch.equal(torch.cat([ar, br], -1), yr) and torch.equal(torch.cat([ai, bi], -1), yi)


def test_wrappers_check_layout_and_count_no_cpu_launch():
    k = trp.make_mix_resample_kernel(lowpass(48, 0.1), 3, 4, out_tile=384, b_rows=2,
                                     device="cpu")
    kc = trp.make_mix_resample_kernel_mc(lowpass(48, 0.1), 3, 4, 2, out_tile=384, b_rows=2,
                                         device="cpu")
    _build.reset_launches()
    ok = torch.zeros((2, k.hist + k.block_in()))
    assert k.fn(0, 1, ok)[0].shape == (2, 384)
    assert kc.fn([0, 0], [1, 2], torch.stack([ok, ok]))[0].shape == (2, 2, 384)
    assert all(v == 0 for v in _build.LAUNCHES.values())
    with pytest.raises(ValueError, match="multiple of kernel block"):
        k.fn(0, 1, torch.zeros((2, k.hist + k.block_in() // 2)))
    with pytest.raises(ValueError, match="dtype"):
        k.fn(0, 1, ok.double())
    with pytest.raises(ValueError, match=r"\[2, 2, hist\+N\]"):
        kc.fn([0], [1], ok[None])
    with pytest.raises(ValueError, match="multiple of up"):
        trp.make_mix_resample_kernel(lowpass(48, 0.1), 3, 4, out_tile=100, device="cpu")
