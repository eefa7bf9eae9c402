"""Port vs JAX package: the open-loop trackers, ``chains/feedforward``.

Fixtures (numpy, seeded), the reference's own (``tests/unit/test_feedforward.py``)
at 2 channels: matched-filtered QPSK at sps 4 on a sinusoidally warped clock
(amp 1.5, period 2048) with CFO 1e-4 and noise, 1,024 symbols, blocks of
128; FSK discriminator planes at sps 8 on the same warp, blocks of 256; the
ragged forms on a 3000 ppm fast clock over 4,096 symbols (12 more come out). The same planes go through JAX
(jitted) and the port (CPU); JAX runs once per module.

Contracts (open loop):

- decisions, validity masks and ragged emission counts equal to JAX's;
- soft symbols and the tau / phi block trajectories within rel L2 1e-5
  (measured here: <= 2.6e-6; the port's prefix sum is a cumsum where JAX
  multiplies by a triangular matrix, and its pick is a gather where JAX
  reduces a one-hot window, which returns the same sample);
- SER / BER 0 against the transmitted data after the settle, as the
  reference asks of each form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import feedforward as jff
from srcdsp_tpu_torch.chains import feedforward as tff
from srcdsp_tpu_torch.chains.psk import make_psk_params
from srcdsp_tpu_torch.chains.tracking import compact_ragged
from srcdsp_tpu_torch.ops.fir import fir_full
from srcdsp_tpu_torch.ops.resample import resample_full
from srcdsp_tpu_torch.testing.signals import fsk_baseband
from tests.torch_threads import one_torch_thread  # noqa: F401

C, SPS, ORDER = 2, 4, 4
NSYM = 1024
REL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _warp(x, amp, period):
    n = np.arange(x.shape[-1] - int(np.ceil(amp)) - 1, dtype=np.float64)
    t = n + amp * np.sin(2 * np.pi * n / period)
    i0 = np.floor(t).astype(np.int64)
    f = t - i0
    return ((1 - f) * x[..., i0] + f * x[..., i0 + 1]).astype(np.complex64)


def _sustained(x, rho):
    nmax = int((x.shape[-1] - 2) / (1 + rho))
    t = np.arange(nmax, dtype=np.float64) * (1 + rho)
    i0 = np.floor(t).astype(np.int64)
    f = t - i0
    return ((1 - f) * x[..., i0] + f * x[..., i0 + 1]).astype(np.complex64)


def _psk_planes(seed, clock, block, nsym=NSYM):
    taps = make_psk_params(0.0, 1, SPS, ORDER, device="cpu").taps
    rng = np.random.default_rng(seed)
    data = rng.integers(0, ORDER, (C, nsym + 64))
    sym = np.exp(2j * np.pi * (data + 0.5) / ORDER).astype(np.complex64)
    x = clock(resample_full(taps, torch.from_numpy(sym), up=SPS, down=1).numpy())
    x = x * np.exp(2j * np.pi * 1e-4 * np.arange(x.shape[-1]))[None]
    x = (x + 0.02 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)))
    y = fir_full(taps, torch.from_numpy(x.astype(np.complex64))).numpy()
    k = (y.shape[-1] // block) * block
    return data, np.ascontiguousarray(y.real[:, :k]), np.ascontiguousarray(y.imag[:, :k])


def _fsk_planes(seed, clock, block, nsym=NSYM, sps=8):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (C, nsym + 32))
    x = clock(fsk_baseband(bits, sps, 0.04))
    x = (x + 0.03 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)))
    y = fir_full(torch.full((4,), 0.25), torch.from_numpy(x.astype(np.complex64))).numpy()
    d = (np.angle(y[:, 1:] * np.conj(y[:, :-1])) / (2 * np.pi)).astype(np.float32)
    k = (d.shape[-1] // block) * block
    return bits, np.ascontiguousarray(d[:, :k])


# name -> (port fn, JAX fn, fixture, block, fsk?)
FORMS = {
    "psk": (tff.ff_psk_demod_planes, jff.ff_psk_demod_planes, "psk_warp", 128, False),
    "psk_ragged": (tff.ff_psk_demod_ragged, jff.ff_psk_demod_ragged, "psk_ppm", 128, False),
    "fsk": (tff.ff_fsk_demod_planes, jff.ff_fsk_demod_planes, "fsk_warp", 256, True),
    "fsk_ragged": (tff.ff_fsk_demod_ragged, jff.ff_fsk_demod_ragged, "fsk_ppm", 256, True),
}


def _call(fn, planes, name):
    _, _, _, block, fsk = FORMS[name]
    if fsk:
        return fn(planes[0], 8, block=block)
    return fn(planes[0], planes[1], SPS, ORDER, block=block, offset=0.5)


@pytest.fixture(scope="module")
def ref():
    fix = {
        "psk_warp": _psk_planes(7, lambda x: _warp(x, 1.5, 2048.0), 128),
        "psk_ppm": _psk_planes(11, lambda x: _sustained(x, 3e-3), 128, 4 * NSYM),
        "fsk_warp": _fsk_planes(9, lambda x: _warp(x, 1.5, 2048.0), 256),
        "fsk_ppm": _fsk_planes(13, lambda x: _sustained(x, 3e-3), 256, 4 * NSYM),
    }
    out = {"fix": fix}
    for name, (_, jfn, fk, _, _) in FORMS.items():
        planes = [jnp.asarray(p) for p in fix[fk][1:]]
        out[name] = jax.tree_util.tree_map(
            np.asarray, jax.jit(lambda *p, f=jfn, n=name: _call(f, p, n))(*planes))
    return out


def _flat(o):
    return jax.tree_util.tree_leaves(o)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_ff_equal_to_jax(ref, name):
    fn, _, fk, _, _ = FORMS[name]
    got = _call(fn, [torch.from_numpy(p) for p in ref["fix"][fk][1:]], name)
    lt = _flat(jax.tree_util.tree_map(lambda t: t.numpy(), got))
    lj = _flat(ref[name])
    assert len(lt) == len(lj)
    for t, j in zip(lt, lj):
        assert t.shape == j.shape
        if t.dtype.kind in "iub":
            np.testing.assert_array_equal(t, j)
        else:
            assert t.dtype == np.float32 and rel(t, j) <= REL


def _best_err(got, want, order, lags=24):
    best = None
    for lag in range(lags):
        m = min(got.size - lag, want.size) - 16
        for rot in range(order):
            err = int(((got[lag: lag + m] + rot) % order != want[:m]).sum())
            best = err if best is None else min(best, err)
    return best


@pytest.mark.parametrize("name", sorted(FORMS))
def test_ff_decodes_its_fixture(ref, name):
    """SER / BER 0 after settle; the ragged forms emit the actual (+0.3 %)
    count, the bounded ones follow a tau trajectory spanning > 2 samples."""
    fn, _, fk, block, fsk = FORMS[name]
    data = ref["fix"][fk][0]
    out = _call(fn, [torch.from_numpy(p) for p in ref["fix"][fk][1:]], name)
    ragged = name.endswith("ragged")
    idx, valid, diag = out[0], (out[2] if ragged else None), out[-1]
    for ch in range(C):
        got = compact_ragged(idx[ch], valid[ch]) if ragged else idx[ch].numpy()
        if ragged:
            nominal = ref["fix"][fk][1].shape[-1] // (8 if fsk else SPS)
            assert got.size > nominal + 5
        assert _best_err(got, data[ch], 2 if fsk else ORDER) == 0
    assert float(torch.min(diag["tau_blocks"].amax(-1) - diag["tau_blocks"].amin(-1))) > 2.0


def test_unwrap_blocks_equal_to_jax():
    rng = np.random.default_rng(0)
    vals = np.mod(np.cumsum(rng.normal(0, 0.6, (3, 200)), axis=-1), 4.0).astype(np.float32)
    got = tff._unwrap_blocks(torch.from_numpy(vals), 4.0).numpy()
    want = np.asarray(jff._unwrap_blocks(jnp.asarray(vals), 4.0))
    assert rel(got, want) <= REL
    np.testing.assert_array_equal(np.round(got - vals), np.round(want - vals))


def test_shape_errors():
    z = torch.zeros(2, 1000)
    with pytest.raises(ValueError, match="block"):
        tff.ff_psk_demod_planes(z, z, 4, 4, block=128)
    with pytest.raises(ValueError, match="block"):
        tff.ff_fsk_demod_ragged(torch.zeros(2, 1024), 8, block=100)
    with pytest.raises(ValueError, match="lookahead"):
        tff.ff_psk_demod_ragged(torch.zeros(2, 1024), torch.zeros(2, 1024), 4, 4, block=32,
                                window_syms=8)
