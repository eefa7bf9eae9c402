"""Port vs JAX package: ``ops/spectrum`` (Welch PSD, spectrogram, streaming
Welch) on the same numpy inputs at the JAX unit tests' shapes.

Contracts: every spectrum within rel L2 1e-5 of JAX's (float32 FFTs of two
libraries, summed in another order); frames equal; the streaming form equal
to the port's one-shot `welch` within rel L2 1e-5 (the reference's own rtol
between the two); the plane-FFT tier within rel L2 1e-3 of the torch.fft tier
(the reference's bound between its two tiers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops import spectrum as js
from srcdsp_tpu_torch.ops import spectrum as ts
from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes
from tests.torch_threads import one_torch_thread  # noqa: F401


def _noise(n, seed, complex_=True):
    rng = np.random.default_rng(seed)
    if complex_:
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return rng.standard_normal(n).astype(np.float32)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("nfft,hop", [(8, 4), (8, 3), (16, 16)])
def test_frames_equal_jax(nfft, hop):
    x = np.arange(40.0, dtype=np.float32)
    assert np.array_equal(ts.frame_signal(torch.from_numpy(x), nfft, hop).numpy(),
                          np.asarray(js.frame_signal(jnp.asarray(x), nfft, hop)))
    with pytest.raises(ValueError):
        ts.frame_signal(torch.from_numpy(x[:4]), nfft, hop)


@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("window,detrend", [("hann", "constant"), ("hamming", None)])
def test_welch_matches_jax(scaling, complex_, window, detrend):
    x = _noise(4096, seed=1, complex_=complex_)
    got = ts.welch(torch.from_numpy(x), 256, window=window, detrend=detrend, scaling=scaling)
    ref = js.welch(jnp.asarray(x), 256, window=window, detrend=detrend, scaling=scaling)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < 1e-5


def test_welch_multichannel_custom_window_and_errors():
    x = np.stack([_noise(4096, seed=5), _noise(4096, seed=6)])
    w = np.kaiser(256, 6.0)
    got = ts.welch(torch.from_numpy(x), 256, hop=64, window=w)
    assert got.shape == (2, 256)
    assert _rel(got, js.welch(jnp.asarray(x), 256, hop=64, window=w)) < 1e-5
    for kw in (dict(window="nope"), dict(window=np.ones(100)), dict(scaling="nope")):
        with pytest.raises(ValueError):
            js.welch(jnp.asarray(x), 256, **kw)
        with pytest.raises(ValueError):
            ts.welch(torch.from_numpy(x), 256, **kw)


@pytest.mark.parametrize("nfft,hop", [(128, 64), (64, 48)])
def test_spectrogram_matches_jax(nfft, hop):
    x = _noise(2048, seed=2)
    got = ts.spectrogram(torch.from_numpy(x), nfft, hop)
    ref = js.spectrogram(jnp.asarray(x), nfft, hop)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("nfft,hop,blocks", [(256, 128, 8), (128, 64, 16)])
def test_welch_stream_matches_jax_and_one_shot(nfft, hop, blocks):
    x = _noise(8192, seed=3)
    st = ts.welch_stream_init(nfft, hop, device="cpu")
    jst = js.welch_stream_init(nfft, hop)
    for i, b in enumerate(np.split(x, blocks)):
        st = ts.welch_stream_update(st, torch.from_numpy(b), nfft, hop, first=(i == 0))
        jst = js.welch_stream_update(jst, jnp.asarray(b), nfft, hop, first=(i == 0))
    got = ts.welch_stream_finalize(st, nfft)
    assert float(st.count) == float(jst.count)
    assert _rel(got, js.welch_stream_finalize(jst, nfft)) < 1e-5
    assert _rel(got, ts.welch(torch.from_numpy(x), nfft, hop)) < 1e-5
    with pytest.raises(ValueError):
        ts.welch_stream_update(st, torch.from_numpy(x[:hop + 1]), nfft, hop)


def test_welch_plane_fft_tier():
    x = _noise(2048, seed=7)
    fft = make_fft_planes(256, device="cpu")
    got = ts.welch(torch.from_numpy(x), 256, fft_fn=fft)
    assert _rel(got, ts.welch(torch.from_numpy(x), 256)) < 1e-3
    xr = _noise(2048, seed=8, complex_=False)
    assert _rel(ts.welch(torch.from_numpy(xr), 256, fft_fn=fft),
                js.welch(jnp.asarray(xr), 256)) < 1e-3
