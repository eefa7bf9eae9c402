"""Port vs JAX package: kernel K17 (``kernels/ctaps_aligned``), K4 with the
history as its own operand.

On a CPU tensor the port runs its plain version (K4's plain version over the
concatenated stream); it is held against the Pallas kernel in interpret mode
at the reference test's tiling (out_tile 128, b_rows 4, block_cols 64) on the
same numpy planes. Contracts:

- against the Pallas kernel: atol 1e-4, the reference's own bound between its
  aligned and K4 kernels (tests/unit/test_ctaps_aligned.py), and rel L2 <=
  1e-6 (float32 sums in another order and another phasor evaluation);
- bit-exact: K17 against K4 on the same stream (the port has no split matmul,
  so every column block is K4's), and chunked streaming against one call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import ctaps_aligned as jca
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import ctaps_aligned as tca
from srcdsp_tpu_torch.kernels import mixfir_ctaps as tct
from tests.torch_threads import one_torch_thread  # noqa: F401

DECIM, OT, BR, BC = 2, 128, 4, 64


def _kernel(taps, word):
    return tca.make_ctaps_aligned_kernel(taps, word, DECIM, out_tile=OT, b_rows=BR,
                                         block_cols=BC, device="cpu")


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("freq,seed", [(0.11, 0), (-0.2317, 3)])
def test_plain_matches_pallas_interpret(freq, seed):
    taps = lowpass(64, 0.2)
    word = int(freq_to_word(freq))
    ja = jca.make_ctaps_aligned_kernel(taps, word, DECIM, out_tile=OT, b_rows=BR,
                                       block_cols=BC, interpret=True)
    ta = _kernel(taps, word)
    assert (ta.hist, ta.block_in(), ta.dword, ta.num_taps) == (ja.hist, ja.block_in(), ja.dword,
                                                               ja.num_taps)
    hist, n = ta.hist, 3 * ta.block_in()
    x = np.random.default_rng(seed).standard_normal((2, hist + n)).astype(np.float32)
    w0 = int(freq_to_word(0.013))          # a stream that starts mid-way
    jr, ji = jca.ctaps_aligned_pallas(ja, w0, jnp.asarray(x[:, :hist]), jnp.asarray(x[:, hist:]))
    xt = torch.from_numpy(x)
    tr, ti = tca.ctaps_aligned(ta, w0, xt[:, :hist], xt[:, hist:])
    assert tr.shape == jr.shape and tr.dtype == torch.float32
    ref = np.asarray(jr, np.float64) + 1j * np.asarray(ji, np.float64)
    got = tr.numpy().astype(np.float64) + 1j * ti.numpy()
    np.testing.assert_allclose(got.real, ref.real, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.imag, ref.imag, rtol=0, atol=1e-4)
    assert _rel(got, ref) <= 1e-6


def test_plain_equals_k4_plain_on_the_same_stream():
    """word0 = 0 for body sample 0 is K4's start word -hist*dword."""
    taps = lowpass(64, 0.2)
    word = int(freq_to_word(0.11))
    ta = _kernel(taps, word)
    k4 = tct.make_mix_fir_ctaps_kernel(taps, word, DECIM, out_tile=OT, b_rows=BR, device="cpu")
    hist = ta.hist
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, hist + 3 * ta.block_in())).astype(np.float32))
    yr, yi = tca.ctaps_aligned(ta, 0, x[:, :hist], x[:, hist:])
    rr, ri = tct.mix_fir_ctaps(k4, (-hist * word) % (1 << 32), x)
    assert torch.equal(yr, rr) and torch.equal(yi, ri)


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_streaming_equals_one_call(chunks):
    taps = lowpass(64, 0.2)
    word = int(freq_to_word(-0.07))
    ta = _kernel(taps, word)
    hist, n = ta.hist, ta.block_in() * 4
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, n)).astype(np.float32))
    z = torch.zeros((2, hist))
    yr1, yi1 = tca.ctaps_aligned(ta, 0, z, x)
    parts, carry, q = [], z, n // chunks
    for i in range(chunks):
        body = x[:, i * q:(i + 1) * q]
        parts.append(tca.ctaps_aligned(ta, (i * q * word) % (1 << 32), carry, body))
        carry = body[:, -hist:]
    assert torch.equal(torch.cat([p[0] for p in parts], -1), yr1)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), yi1)


def test_word0_accepts_the_jax_word_array():
    taps = lowpass(64, 0.2)
    word = int(freq_to_word(0.11))
    ta = _kernel(taps, word)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, ta.hist + ta.block_in())).astype(np.float32))
    w0 = (3 << 30) + 5
    a = tca.ctaps_aligned(ta, w0, x[:, :ta.hist], x[:, ta.hist:])
    b = tca.ctaps_aligned(ta, np.asarray([[w0]], np.uint32).view(np.int32), x[:, :ta.hist],
                          x[:, ta.hist:])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_rejects_narrow_blocks_as_jax():
    taps = lowpass(200, 0.2)   # hist 256 > BC*decim 128
    with pytest.raises(ValueError):
        jca.make_ctaps_aligned_kernel(taps, 123, DECIM, out_tile=OT, b_rows=BR, block_cols=BC,
                                      interpret=True)
    with pytest.raises(ValueError, match="block_cols"):
        tca.make_ctaps_aligned_kernel(taps, 123, DECIM, out_tile=OT, b_rows=BR, block_cols=BC,
                                      device="cpu")
    with pytest.raises(ValueError, match="block_cols"):
        tca.make_ctaps_aligned_kernel(lowpass(64, 0.2), 123, DECIM, out_tile=OT, block_cols=96,
                                      device="cpu")


def test_layout_errors():
    ta = _kernel(lowpass(64, 0.2), 123)
    hist, stride = ta.hist, OT * DECIM
    body = torch.zeros((2, BR, stride))
    ta.fn(0, torch.zeros((2, hist)), body)
    with pytest.raises(ValueError, match="x_hist"):
        ta.fn(0, torch.zeros((2, hist - 1)), body)
    with pytest.raises(ValueError, match="last dim"):
        ta.fn(0, torch.zeros((2, hist)), torch.zeros((2, BR, stride + 128)))
    with pytest.raises(ValueError, match="multiple"):
        ta.fn(0, torch.zeros((2, hist)), torch.zeros((2, BR + 1, stride)))
    with pytest.raises(ValueError, match="float32"):
        ta.fn(0, torch.zeros((2, hist)), body.double())
    with pytest.raises(ValueError, match="contiguous"):
        ta.fn(0, torch.zeros((2, hist)), torch.zeros((2, stride, BR)).transpose(1, 2))
    with pytest.raises(ValueError, match="kernel built for cpu"):
        ta.fn(0, torch.zeros((2, hist)), body.to("meta"))


def test_cpu_tensors_run_the_plain_version_without_launching():
    ta = _kernel(lowpass(64, 0.2), 123)
    _build.reset_launches()
    yr, _ = ta.fn(0, torch.zeros((2, ta.hist)), torch.ones((2, BR, OT * DECIM)))
    assert yr.device.type == "cpu" and tuple(yr.shape) == (BR, OT)
    assert all(v == 0 for v in _build.LAUNCHES.values())
