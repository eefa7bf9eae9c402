"""Port vs JAX package: kernel K1 (fused NCO mix + FIR + decimate).

On a CPU tensor the port's wrapper runs the plain PyTorch version; it is held
against the Pallas kernel in interpret mode (out_tile=128, b_rows=2) on the
same numpy planes: rel L2 < 1e-5 (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import mixfir as jk
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import mixfir as tk


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _planes(rng, c, length):
    return rng.standard_normal((c, 2, length)).astype(np.float32)


@pytest.mark.parametrize("t,m", [(64, 2), (33, 4)])
def test_single_channel_matches_pallas_interpret(t, m):
    taps = lowpass(t, 0.4 / max(m, 2))
    jkern = jk.make_mix_fir_kernel(taps, m, out_tile=128, b_rows=2, interpret=True)
    tkern = tk.make_mix_fir_kernel(taps, m, out_tile=128, b_rows=2, device="cpu")
    assert tkern.hist == jkern.hist and tkern.block_in() == jkern.block_in()
    x = _planes(np.random.default_rng(t), 1, jkern.hist + 3 * jkern.block_in())[0]
    word = int(freq_to_word(0.0931))
    word0 = (-jkern.hist * word) % (1 << 32)
    jr, ji = jk.mix_fir_decim_pallas(jkern, word0, word, jnp.asarray(x))
    tr, ti = tk.mix_fir_decim(tkern, word0, word, torch.as_tensor(x))
    assert tr.shape == jr.shape
    ref = np.asarray(jr) + 1j * np.asarray(ji)
    assert _rel(tr.numpy() + 1j * ti.numpy(), ref) < 1e-5


@pytest.mark.parametrize("per_channel", [False, True])
def test_multichannel_matches_pallas_interpret(per_channel):
    c, m = 3, 4
    taps = lowpass(64, 0.03)
    if per_channel:
        taps = np.stack([lowpass(64, 0.03 + 0.01 * i) for i in range(c)])
    jkern = jk.make_mix_fir_kernel_mc(taps, m, c, out_tile=128, b_rows=2, interpret=True)
    tkern = tk.make_mix_fir_kernel_mc(taps, m, c, out_tile=128, b_rows=2, device="cpu")
    x = _planes(np.random.default_rng(7), c, jkern.hist + 2 * jkern.block_in())
    dwords = np.asarray([freq_to_word(-0.11 - 0.01 * i) for i in range(c)], np.uint32)
    words0 = np.asarray([(-jkern.hist * int(w)) % (1 << 32) for w in dwords], np.uint32)
    jr, ji = jk.mix_fir_decim_pallas_mc(jkern, words0, dwords, jnp.asarray(x))
    tr, ti = tk.mix_fir_decim_mc(tkern, words0, dwords, torch.as_tensor(x))
    ref = np.asarray(jr) + 1j * np.asarray(ji)
    assert _rel(tr.numpy() + 1j * ti.numpy(), ref) < 1e-5


def test_chunked_equals_one_shot_bit_exact():
    """Two launches over chunks (u32 phase carried as the start word) equal
    one launch over the whole buffer, bit for bit."""
    taps = lowpass(32, 0.2)
    k = tk.make_mix_fir_kernel(taps, 2, out_tile=128, b_rows=2, device="cpu")
    n = 4 * k.block_in()
    x = torch.as_tensor(_planes(np.random.default_rng(1), 1, k.hist + n)[0])
    word = int(freq_to_word(0.217))
    word0 = (-k.hist * word) % (1 << 32)
    yr, yi = tk.mix_fir_decim(k, word0, word, x)
    half = n // 2
    r1, i1 = tk.mix_fir_decim(k, word0, word, x[:, :k.hist + half].contiguous())
    r2, i2 = tk.mix_fir_decim(k, (word0 + half * word) % (1 << 32), word,
                              x[:, half:].contiguous())
    assert torch.equal(torch.cat([r1, r2], -1), yr)
    assert torch.equal(torch.cat([i1, i2], -1), yi)


@pytest.mark.parametrize("t,m,ot,hist", [(16, 2, 8, 16), (64, 4, 128, 128), (33, 1, 64, 128)])
def test_toeplitz_and_banded_taps_bit_equal(t, m, ot, hist):
    taps = lowpass(t, 0.2)
    np.testing.assert_array_equal(tk.toeplitz_taps(taps, m, ot, hist),
                                  jk.toeplitz_taps(taps, m, ot, hist))
    bc = min(ot, 64)
    np.testing.assert_array_equal(tk.banded_taps(taps, m, ot, hist, bc),
                                  jk.banded_taps(taps, m, ot, hist, bc))


def test_cpu_tensor_runs_plain_version_without_launching():
    _build.reset_launches()
    k = tk.make_mix_fir_kernel_mc(lowpass(64, 0.03), 4, 2, out_tile=128, b_rows=2, device="cpu")
    x = torch.zeros((2, 2, k.hist + k.block_in()))
    yr, yi = tk.mix_fir_decim_mc(k, [0, 0], [1, 2], x)
    assert yr.shape == (2, k.block_in() // 4) and yi.device.type == "cpu"
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_wrapper_rejects_bad_inputs():
    k = tk.make_mix_fir_kernel_mc(lowpass(64, 0.03), 4, 2, out_tile=128, b_rows=2, device="cpu")
    good = torch.zeros((2, 2, k.hist + k.block_in()))
    with pytest.raises(ValueError, match="float32"):
        k.fn([0, 0], [1, 1], good.double())
    with pytest.raises(ValueError, match="multiple"):
        k.fn([0, 0], [1, 1], good[..., 1:].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        k.fn([0, 0], [1, 1], torch.zeros((2, 2, 2 * good.shape[-1]))[..., ::2])
    with pytest.raises(ValueError, match="kernel built for cpu"):
        k.fn([0, 0], [1, 1], good.to("meta"))
