"""Port vs JAX package: the rational L/M resampler (``ops/resample.py``) and
the strided ``complex_conv`` beneath the FIR (``ops/fir.py``).

Contracts, as the reference states them (tests/unit/test_resample.py):

- against the JAX resampler on the same numpy input: rel L2 < 1e-5 (float32
  sums in another order: the port sums the polyphase terms one tap at a
  time, XLA runs a dilated convolution);
- against a float64 zero-stuff + lfilter reference: SNR > 110 dB;
- block joins bit-exact: blocks streamed through the carried tail equal one
  whole-signal call, for the reference's block lists;
- `complex_conv` against the JAX one: atol 1e-5 (one conv1d against XLA's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from srcdsp_tpu.ops import resample as jrs
from srcdsp_tpu.ops.fir import complex_conv as jax_complex_conv
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.ops import resample as trs
from srcdsp_tpu_torch.ops.fir import complex_conv

PAIRS = [(3, 4, 4096), (1, 2, 1024), (2, 1, 1024), (5, 3, 3072), (7, 4, 2048)]


def _iq(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / np.mean(np.abs(got - ref) ** 2)))


def _taps(up, down):
    return lowpass(16 * max(up, down) + 1, 0.4 / max(up, down)) * up


@pytest.mark.parametrize("up,down,n", PAIRS)
def test_resample_full_matches_jax(up, down, n):
    h = _taps(up, down)
    x = _iq(np.random.default_rng(up * 7 + down), 2, n)
    want = np.asarray(jrs.resample_full(h, jnp.asarray(x), up, down))
    got = trs.resample_full(h, torch.from_numpy(x), up, down)
    assert got.shape == want.shape == (2, n * up // down)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("up,down,n", PAIRS)
def test_resample_matches_float64_reference(up, down, n):
    h = _taps(up, down)
    x = _iq(np.random.default_rng(n), n)
    u = np.zeros(n * up, np.complex128)
    u[::up] = x
    ref = sps.lfilter(h.astype(np.float64), [1.0], u)[::down][:n * up // down]
    assert _snr_db(ref, trs.resample_full(h, torch.from_numpy(x), up, down).numpy()) > 110.0


@pytest.mark.parametrize("up,down,blocks", [(3, 4, [1024, 512, 2048]), (2, 3, [768, 768]),
                                            (4, 1, [128, 384, 512])])
def test_block_joins_bit_exact(up, down, blocks):
    h = lowpass(64, 0.2 / max(up, down)) * up
    x = _iq(np.random.default_rng(sum(blocks)), sum(blocks))
    whole = trs.resample_full(h, torch.from_numpy(x), up, down)
    st = trs.resample_init(len(h), up, device="cpu")
    outs, off = [], 0
    for b in blocks:
        st, y = trs.resample_apply(h, st, torch.from_numpy(x[off:off + b]), up, down)
        outs.append(y)
        off += b
    assert torch.equal(torch.cat(outs), whole)
    want = np.asarray(jrs.resample_full(h, jnp.asarray(x), up, down))
    assert _rel(whole.numpy(), want) < 1e-5


def test_apply_matches_jax_block_by_block_and_state():
    up, down = 3, 4
    h = lowpass(48, 0.3)
    x = _iq(np.random.default_rng(4), 3, 3 * 512)
    js = jrs.resample_init(len(h), up, (3,))
    ts = trs.resample_init(len(h), up, (3,), device="cpu")
    assert tuple(ts.tail.shape) == js.tail.shape == (3, 16)
    for b in range(3):
        xb = x[:, b * 512:(b + 1) * 512]
        js, jy = jrs.resample_apply(h, js, jnp.asarray(xb), up, down)
        ts, ty = trs.resample_apply(h, ts, torch.from_numpy(xb), up, down)
        assert _rel(ty.numpy(), np.asarray(jy)) < 1e-5
        np.testing.assert_array_equal(ts.tail.numpy(), np.asarray(js.tail))


def test_jax_state_carried_into_port_gives_the_same_next_block():
    """A stream started by the JAX package continues in the port: its
    ResampleState through `convert.resample_state_from`, then the next block
    agrees with JAX's (rel < 1e-5) and the tail comes back bit-equal."""
    up, down = 3, 4
    h = lowpass(48, 0.3)
    x = _iq(np.random.default_rng(5), 2, 1024)
    js, _ = jrs.resample_apply(h, jrs.resample_init(len(h), up, (2,)), jnp.asarray(x[:, :512]),
                               up, down)
    js2, jy2 = jrs.resample_apply(h, js, jnp.asarray(x[:, 512:]), up, down)
    ts = convert.resample_state_from(js, device="cpu")
    ts2, ty2 = trs.resample_apply(h, ts, torch.from_numpy(x[:, 512:]), up, down)
    assert _rel(ty2.numpy(), np.asarray(jy2)) < 1e-5
    np.testing.assert_array_equal(ts2.tail.numpy(), np.asarray(js2.tail))


@pytest.mark.parametrize("num_taps,up,want", [(48, 3, 49), (49, 3, 49), (31, 1, 31),
                                              (64, 4, 65), (2, 2, 3)])
def test_padded_len_and_pad_taps(num_taps, up, want):
    assert trs._padded_len(num_taps, up) == jrs._padded_len(num_taps, up) == want
    h = np.arange(1, num_taps + 1, dtype=np.float32)
    np.testing.assert_array_equal(trs.pad_taps(h, up).numpy(), np.asarray(jrs.pad_taps(h, up)))


def test_misaligned_block_and_wrong_state_raise():
    st = trs.resample_init(31, 3, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        trs.resample_apply(np.ones(31, np.float32), st, torch.zeros(100, dtype=torch.complex64),
                           3, 7)
    with pytest.raises(ValueError, match="state tail"):
        trs.resample_apply(np.ones(40, np.float32), st, torch.zeros(12, dtype=torch.complex64),
                           3, 4)


@pytest.mark.parametrize("stride,n", [(1, 50), (2, 51), (3, 49), (4, 64)])
@pytest.mark.parametrize("complex_taps", [False, True])
def test_complex_conv_strided_matches_jax(stride, n, complex_taps):
    rng = np.random.default_rng(stride * 10 + n)
    x = _iq(rng, 3, n)
    h = rng.standard_normal(7).astype(np.float32)
    if complex_taps:
        h = _iq(rng, 7)
    want = np.asarray(jax_complex_conv(jnp.asarray(x), jnp.asarray(h), stride=stride))
    got = complex_conv(torch.from_numpy(x), torch.from_numpy(h), stride=stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
