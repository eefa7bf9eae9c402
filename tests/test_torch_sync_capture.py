"""Port vs JAX package: O&M timing pieces and the capture reader/writer."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import sync as jsync
from srcdsp_tpu.io import capture as jcap
from srcdsp_tpu_torch.chains import sync as tsync
from srcdsp_tpu_torch.io import capture as tcap
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_timing_estimate_and_sample_match_jax():
    rng = np.random.default_rng(0)
    sps = 8
    metric = rng.random((3, 1024)).astype(np.float32)
    x = rng.standard_normal((3, 1024)).astype(np.float32)
    acc0 = (rng.standard_normal(3) + 1j * rng.standard_normal(3)).astype(np.complex64)
    jacc, jtau = jsync.timing_estimate(jnp.asarray(acc0), jnp.asarray(metric), sps)
    tacc, ttau = tsync.timing_estimate(torch.as_tensor(acc0), torch.as_tensor(metric), sps)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-5)
    np.testing.assert_allclose(ttau.numpy(), np.asarray(jtau), atol=1e-4)
    last = rng.standard_normal((3, sps + 1)).astype(np.float32)
    jl, jsym = jsync.timing_sample(jnp.asarray(last), jnp.asarray(x), jtau, sps)
    tl, tsym = tsync.timing_sample(torch.as_tensor(last), torch.as_tensor(x),
                                   torch.as_tensor(np.array(jtau)), sps)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tsym.numpy(), np.asarray(jsym), atol=1e-6)


def _np_pairwise(x: np.ndarray) -> np.ndarray:
    """numpy twin of `fixed_sum`: zero-pad to a power of two, add halves."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    x = np.concatenate([x, np.zeros((*x.shape[:-1], width - n), x.dtype)], axis=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


@pytest.mark.parametrize("n", [1, 5, 1024, 1000, 32768])
def test_fixed_sum_is_one_order_for_every_batch(n):
    """`fixed_sum` (the timing and V&V accumulators' reduction) equals its
    numpy twin bit for bit, and each row is the same sum whatever the number
    of rows or torch's thread count: a channel-sharded demod equals the
    unsharded one."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))).astype(np.complex64)
    full = tsync.fixed_sum(torch.as_tensor(x))
    assert np.array_equal(full.numpy(), _np_pairwise(x))
    threads = torch.get_num_threads()
    try:
        for t in (1, 4):
            torch.set_num_threads(t)
            parts = torch.cat([tsync.fixed_sum(torch.as_tensor(x[i:i + 2])) for i in (0, 2, 4, 6)])
            assert torch.equal(parts, full)
            assert torch.equal(tsync.fixed_sum(torch.as_tensor(x[3])), full[3])
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(full.numpy(), x.astype(np.complex128).sum(-1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("prev", [-1.0, 0.2, 7.9, 14.5])
def test_phase_unwrap_matches_jax(prev):
    tau = np.linspace(0.0, 7.99, 41).astype(np.float32)
    p = np.full_like(tau, prev)
    ref = np.asarray(jsync.phase_unwrap(jnp.asarray(p), jnp.asarray(tau), 8))
    got = tsync.phase_unwrap(torch.as_tensor(p), torch.as_tensor(tau), 8).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("fmt", ["ci16", "cf32", "cu8", "ci8"])
def test_capture_roundtrip_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(1)
    x = (0.4 * (rng.standard_normal(1000) + 1j * rng.standard_normal(1000))).astype(np.complex64)
    pj, pt = os.path.join(tmp_path, "j.iq"), os.path.join(tmp_path, "t.iq")
    jcap.write_capture(pj, x, jcap.CaptureMeta(fmt=fmt, sample_rate=2.0))
    tcap.write_capture(pt, x, tcap.CaptureMeta(fmt=fmt, sample_rate=2.0))
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert open(pj + ".json").read() == open(pt + ".json").read()
    xj, _ = jcap.read_capture(pj)
    xt, meta = tcap.read_capture(pt)
    assert meta.fmt == fmt and meta.num_samples == 1000
    np.testing.assert_array_equal(xt, xj)
    blocks = list(tcap.device_blocks(pt, 256, start_block=1, planes=True, device="cpu"))
    assert len(blocks) == 2 and blocks[0].shape == (2, 256)
    np.testing.assert_array_equal(blocks[0].numpy(),
                                  np.stack([xj[256:512].real, xj[256:512].imag]))
