"""Port vs JAX package: kernel K18 (``kernels/mixfir_rows``), mix once per
sample by a factored row x lane phasor, then K1's real-tap FIR.

On a CPU tensor the port runs its plain version; it is held against the
Pallas kernel in interpret mode and against the port's own K1 plain version
(``kernels/mixfir``) on the same numpy planes, each at rel L2 < 2e-6, the
reference's own bound between its row and classic kernels
(tests/unit/test_mixfir_kernel.py::test_rows_kernel_matches_classic): the
phasor is a product of two, so it rounds unlike K1's one phasor per sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import mixfir_rows as jrows
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import mixfir as tmf
from srcdsp_tpu_torch.kernels import mixfir_rows as trows
from tests.torch_threads import one_torch_thread  # noqa: F401


def _cplx(yr, yi):
    return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _case(t, decim, freq, seed, ot=512, br=4, blocks=3):
    taps = lowpass(t, 0.4 / decim)
    word = int(freq_to_word(freq))
    k = trows.make_mix_fir_rows_kernel(taps, decim, out_tile=ot, b_rows=br, device="cpu")
    n = blocks * k.block_in()
    x = np.random.default_rng(seed).standard_normal((2, k.hist + n)).astype(np.float32)
    return taps, word, k, x, (-k.hist * word) % (1 << 32)


@pytest.mark.parametrize("t,decim,freq,ot", [(64, 2, 0.11, 512), (33, 4, -0.2173, 256),
                                             (129, 1, 0.3001, 512)])
def test_plain_matches_pallas_interpret(t, decim, freq, ot):
    taps, word, k, x, w0 = _case(t, decim, freq, seed=t, ot=ot)
    jk = jrows.make_mix_fir_rows_kernel(taps, decim, out_tile=ot, b_rows=4, interpret=True)
    assert (k.hist, k.block_in(), k.num_taps) == (jk.hist, jk.block_in(), jk.num_taps)
    ref = _cplx(*jrows.mix_fir_rows_pallas(jk, w0, word, jnp.asarray(x)))
    tr, ti = trows.mix_fir_rows(k, w0, word, torch.from_numpy(x))
    assert tr.shape == (1, ref.shape[-1]) and tr.dtype == torch.float32
    assert _rel(_cplx(tr, ti), ref) < 2e-6


@pytest.mark.parametrize("t,decim,freq,ot", [(64, 2, 0.11, 512), (33, 4, 0.0417, 256)])
def test_plain_matches_port_k1_plain(t, decim, freq, ot):
    taps, word, k, x, w0 = _case(t, decim, freq, seed=7, ot=ot)
    k1 = tmf.make_mix_fir_kernel(taps, decim, out_tile=ot, b_rows=4, device="cpu")
    xt = torch.from_numpy(x)
    ref = _cplx(*tmf.mix_fir_decim(k1, w0, word, xt))
    assert _rel(_cplx(*trows.mix_fir_rows(k, w0, word, xt)), ref) < 2e-6


def test_wrapper_pads_the_tail_and_fn_takes_the_jax_word_arrays():
    taps, word, k, x, w0 = _case(64, 2, 0.11, seed=1)
    xt = torch.from_numpy(x)
    yr, yi = trows.mix_fir_rows(k, w0, word, xt)
    rows = -(-(x.shape[-1]) // 128) + 8
    x3 = torch.cat([xt, torch.zeros((2, rows * 128 - x.shape[-1]))], -1).reshape(2, -1, 128)
    as_i32 = [np.asarray([[w]], np.uint32).view(np.int32) for w in (w0, word)]
    fr, fi = k.fn(*as_i32, x3, n=x.shape[-1] - k.hist)
    assert torch.equal(fr.reshape(1, -1), yr) and torch.equal(fi.reshape(1, -1), yi)


def test_layout_errors_as_jax():
    taps = lowpass(64, 0.2)
    for kw in (dict(out_tile=100), dict(block_cols=32, decim=1, out_tile=128),
               dict(block_cols=96)):
        d = kw.pop("decim", 2)
        with pytest.raises(ValueError):
            jrows.make_mix_fir_rows_kernel(taps, d, interpret=True, **kw)
        with pytest.raises(ValueError):
            trows.make_mix_fir_rows_kernel(taps, d, device="cpu", **kw)
    k = trows.make_mix_fir_rows_kernel(taps, 2, out_tile=512, b_rows=4, device="cpu")
    with pytest.raises(ValueError, match="must be"):
        k.fn(0, 1, torch.zeros((2, 64, 64)))
    with pytest.raises(ValueError, match="multiple"):
        k.fn(0, 1, torch.zeros((2, 64, 128)), n=4096 + 512)
    with pytest.raises(ValueError, match="pad the tail"):
        k.fn(0, 1, torch.zeros((2, 33, 128)), n=4096)
    with pytest.raises(ValueError, match="float32"):
        k.fn(0, 1, torch.zeros((2, 64, 128), dtype=torch.float64), n=4096)


def test_cpu_tensors_run_the_plain_version_without_launching():
    taps, word, k, x, w0 = _case(64, 2, 0.11, seed=2, blocks=1)
    _build.reset_launches()
    yr, _ = trows.mix_fir_rows(k, w0, word, torch.from_numpy(x))
    assert yr.device.type == "cpu"
    assert all(v == 0 for v in _build.LAUNCHES.values())


@pytest.mark.parametrize("t,decim,freq,ot", [(64, 2, 0.11, 512), (33, 4, -0.2173, 256),
                                             (129, 1, 0.3001, 512), (48, 3, 0.0417, 128)])
def test_kernel_staging_mirror_matches_plain(t, decim, freq, ot):
    """Every block of K18's CUDA body (csrc/rows.cu, mirrored by rows_window)
    stages each window sample with the plain version's row and lane words
    and, on the plain version's phasors, its mixed sample bit for bit; zeros
    where Planes has no sample (left of 0, past the padded view); every
    output J reads u[J*decim + hist - a] inside the window; the blocks tile
    the outputs, the last one part full at decim 1, 2 and 4."""
    taps, word, k, x, w0 = _case(t, decim, freq, seed=t, ot=ot, br=3, blocks=1)
    x3, n = trows.rows_view(k, torch.from_numpy(x))
    rows = x3.shape[1]
    tables = tuple(v.numpy() for v in trows.rows_phasors(w0, word, rows))
    u = trows.rows_mix_plain(w0, word, x3).numpy()
    outputs = n // decim
    per_block = tmf.fir_shape(decim).outputs
    blocks = -(-outputs // per_block)
    assert outputs % per_block or decim == 3  # part full (decim 3: 128 outputs a block)
    seen = []
    for blk in range(blocks):
        w = trows.rows_window(k, blk, w0, word, x3.numpy(), tables)
        g, ld = w["g"], w["loaded"]
        assert 0 <= w["row"].min() and w["row"].max() < w["nrows"]
        row, lane = np.divmod(g, 128)
        np.testing.assert_array_equal(ld, (g >= 0) & (g < rows * 128))
        np.testing.assert_array_equal(w["row_words"][ld],
                                      (w0 + row[ld] * ((128 * word) & 0xFFFFFFFF)) & 0xFFFFFFFF)
        np.testing.assert_array_equal(w["lane_words"], (lane * word) & 0xFFFFFFFF)
        np.testing.assert_array_equal(w["staged"][:, ld], u[:, g[ld]])
        assert not w["staged"][:, ~ld].any()
        j, e = trows.rows_outputs(k, blk)
        np.testing.assert_array_equal(g[0] + e, j * decim + k.hist)
        assert (e - (t - 1)).min() >= 0 and e.max() < len(g)
        seen.append(j[j < outputs])
    np.testing.assert_array_equal(np.sort(np.concatenate(seen).ravel()), np.arange(outputs))
