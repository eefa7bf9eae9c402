"""Port vs JAX package: the closed-loop tier, ``chains/sync_loop``,
``chains/tracking`` and ``chains/tracking_planes``.

Fixtures (numpy, seeded), the reference's own (``tests/e2e/test_tracking.py``)
cut to 2 channels and 2 blocks: QPSK at sps 4 with a sinusoidally warped
clock (amp 1.5, period 2048), blocks of 2048 samples; binary FSK at centre
0.11, decim 2, sps 8, dev 0.05 on a warp of amp 2, period 8192, blocks of
4096; the ragged forms on a 3000 ppm (PSK) and 2000 ppm (FSK) fast clock.
JAX runs each chain once per module (jitted); the port runs it on the CPU.

Contracts:

- decisions (symbol indices, bits, valid masks, ragged emission counts)
  equal to JAX's;
- soft outputs within rel L2 1e-4 and every float of the final states
  within 1e-4 absolute (int words equal): the loops re-inject rounding,
  and XLA contracts multiply-adds into FMAs where eager torch does not.
  Two state fields are held otherwise. The Gardner `tau` (samples,
  integrated over every step) within 2e-4: measured up to 1.2e-4 on this
  fixture (seed runs 0-5 of the same fixture: 2.0e-5 to 1.2e-4). The
  free-running `pos` within one float32 ulp at its buffer span (below).
  Measured here on the other fields: soft rel L2 <= 5e-5, states <= 4e-5;
- `gardner_free_cap` equal;
- a JAX tracker's state handed to the port after block 0 gives JAX's own
  block 1 (``convert.*_state_from``), for the complex and the plane
  trackers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import fsk as jfsk
from srcdsp_tpu.chains import psk as jpsk
from srcdsp_tpu.chains import sync_loop as jsl
from srcdsp_tpu.chains import tracking as jtr
from srcdsp_tpu.chains import tracking_planes as jtp
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import fsk as tfsk
from srcdsp_tpu_torch.chains import psk as tpsk
from srcdsp_tpu_torch.chains import sync_loop as tsl
from srcdsp_tpu_torch.chains import tracking as ttr
from srcdsp_tpu_torch.chains import tracking_planes as ttp
from srcdsp_tpu_torch.ops.resample import resample_full
from srcdsp_tpu_torch.testing.signals import fsk_baseband, tone
from tests.torch_threads import one_torch_thread  # noqa: F401

C = 2
PSK_SPS, PSK_BLOCK = 4, 2048
FSK_CENTER, FSK_DECIM, FSK_SPS, FSK_DEV, FSK_BLOCK = 0.11, 2, 8, 0.05, 4096
REL, ABS, TAU_ABS = 1e-4, 1e-4, 2e-4


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(s, name=""):
    if isinstance(s, tuple):
        return [x for f, v in zip(s._fields, s) for x in _leaves(v, f)]
    return [(name, s)]


def assert_state_close(port, ref, span=0):
    """Every leaf within ABS (int words equal), Gardner `tau` within
    TAU_ABS (see the module docstring). The free-running strobe
    position `pos` is accumulated in buffer coordinates up to `span`
    samples and re-based after the block, so it is held to ABS or one
    float32 ulp at `span`, whichever is larger (a single rounding of
    pos + adv there, 2.4e-4 at span 2052)."""
    lp, lr = _leaves(port), _leaves(ref)
    assert [n for n, _ in lp] == [n for n, _ in lr]
    for (name, p), (_, r) in zip(lp, lr):
        p, r = p.detach().cpu().numpy(), np.asarray(r)
        assert p.shape == r.shape
        if r.dtype.kind in "iu":
            np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64))
        else:
            tol = {"pos": max(ABS, float(np.spacing(np.float32(span)))),
                   "tau": TAU_ABS}.get(name, ABS)
            np.testing.assert_allclose(p, r, rtol=0, atol=tol)


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


def _psk_signal(seed, nsamp, clock):
    """Differentially encoded QPSK, RRC-shaped at sps 4 (the reference's)."""
    data = np.random.default_rng(seed).integers(0, 4, (C, nsamp // PSK_SPS + 64))
    tx = tpsk.diff_encode(torch.from_numpy(data), 4).numpy()
    sym = np.exp(2j * np.pi * (tx + 0.5) / 4).astype(np.complex64)
    taps = tpsk.make_psk_params(0.0, 1, PSK_SPS, 4, device="cpu").taps
    x = resample_full(taps, torch.from_numpy(sym), up=PSK_SPS, down=1).numpy()
    return np.ascontiguousarray(clock(x)[:, :nsamp])


def _fsk_signal(seed, nsamp, clock):
    bits = np.random.default_rng(seed).integers(0, 2, (C, nsamp // (FSK_DECIM * FSK_SPS) + 64))
    x = fsk_baseband(bits, FSK_DECIM * FSK_SPS, FSK_DEV / FSK_DECIM)
    x = (x * tone(x.shape[-1], FSK_CENTER)).astype(np.complex64)
    return np.ascontiguousarray(clock(x)[:, :nsamp])


def _planes(x):
    return np.stack([x.real, x.imag], axis=1).astype(np.float32)


def _params():
    return dict(
        psk=(tpsk.make_psk_params(0.0, 1, PSK_SPS, 4, device="cpu"),
             jpsk.make_psk_params(0.0, decim=1, sps=PSK_SPS, order=4)),
        fsk=(tfsk.make_fsk_params(FSK_CENTER, 64, 0.04, FSK_DECIM, FSK_SPS, FSK_DEV,
                                  device="cpu"),
             jfsk.make_fsk_params(FSK_CENTER, 64, 0.04, FSK_DECIM, FSK_SPS, FSK_DEV)))


# chain name -> (params key, port init/apply, JAX init/apply, signal, block, planes?)
CHAINS = {
    "psk_track": ("psk", ttr.psk_track_init, ttr.psk_track_apply, jtr.psk_track_init,
                  jtr.psk_track_apply, "psk_warp", PSK_BLOCK, False),
    "fsk_track": ("fsk", ttr.fsk_track_init, ttr.fsk_track_apply, jtr.fsk_track_init,
                  jtr.fsk_track_apply, "fsk_warp", FSK_BLOCK, False),
    "psk_track_ragged": ("psk", ttr.psk_track_ragged_init, ttr.psk_track_ragged_apply,
                         jtr.psk_track_ragged_init, jtr.psk_track_ragged_apply, "psk_ppm",
                         PSK_BLOCK, False),
    "fsk_track_ragged": ("fsk", ttr.fsk_track_ragged_init, ttr.fsk_track_ragged_apply,
                         jtr.fsk_track_ragged_init, jtr.fsk_track_ragged_apply, "fsk_ppm",
                         FSK_BLOCK, False),
    "psk_track_planes": ("psk", ttp.psk_track_planes_init, ttp.psk_track_planes_apply,
                         jtp.psk_track_planes_init, jtp.psk_track_planes_apply, "psk_warp",
                         PSK_BLOCK, True),
    "fsk_track_planes": ("fsk", ttp.fsk_track_planes_init, ttp.fsk_track_planes_apply,
                         jtp.fsk_track_planes_init, jtp.fsk_track_planes_apply, "fsk_warp",
                         FSK_BLOCK, True),
    "psk_track_ragged_planes": ("psk", ttp.psk_track_ragged_planes_init,
                                ttp.psk_track_ragged_planes_apply,
                                jtp.psk_track_ragged_planes_init,
                                jtp.psk_track_ragged_planes_apply, "psk_ppm", PSK_BLOCK, True),
    "fsk_track_ragged_planes": ("fsk", ttp.fsk_track_ragged_planes_init,
                                ttp.fsk_track_ragged_planes_apply,
                                jtp.fsk_track_ragged_planes_init,
                                jtp.fsk_track_ragged_planes_apply, "fsk_ppm", FSK_BLOCK, True),
}


@pytest.fixture(scope="module")
def ref():
    """Every chain over 2 blocks, JAX once per module; the inputs kept."""
    params = _params()
    sig = {
        "psk_warp": _psk_signal(0, 2 * PSK_BLOCK, lambda x: _warp(x, 1.5, 2048.0)),
        "psk_ppm": _psk_signal(1, 2 * PSK_BLOCK, lambda x: _sustained(x, 3e-3)),
        "fsk_warp": _fsk_signal(2, 2 * FSK_BLOCK, lambda x: _warp(x, 2.0, 8192.0)),
        "fsk_ppm": _fsk_signal(3, 2 * FSK_BLOCK, lambda x: _sustained(x, 2e-3)),
    }
    out = {"params": params, "sig": sig}
    for name, (pk, _, _, jinit, japply, sk, block, planes) in CHAINS.items():
        jpar = params[pk][1]
        st = jinit(jpar, C) if planes else jinit(jpar, (C,))
        step = jax.jit(lambda s, v, f=japply, p=jpar: f(p, s, v))
        states, outs = [st], []
        for b in range(2):
            xb = sig[sk][:, b * block:(b + 1) * block]
            st, o = step(st, jnp.asarray(_planes(xb) if planes else xb))
            states.append(st)
            outs.append([np.asarray(v) for v in o])
        out[name] = (states, outs)
    return out


def _port_blocks(ref, name, state=None, start=0):
    pk, tinit, tapply, _, _, sk, block, planes = CHAINS[name]
    tpar = ref["params"][pk][0]
    if state is None:
        state = tinit(tpar, C) if planes else tinit(tpar, (C,))
    outs = []
    for b in range(start, 2):
        xb = ref["sig"][sk][:, b * block:(b + 1) * block]
        state, o = tapply(tpar, state, torch.from_numpy(_planes(xb) if planes else xb))
        outs.append(o)
    return state, outs


def _span(ref, name) -> int:
    """Samples in a ragged tracker's strobe buffer: [sps tail | block/decim]."""
    p = ref["params"][CHAINS[name][0]][0]
    return p.sps + CHAINS[name][6] // p.decim


def _is_decision(v) -> bool:
    return v.dtype in (torch.int32, torch.bool)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_equal_to_jax(ref, name):
    states, jouts = ref[name]
    st, touts = _port_blocks(ref, name)
    for to, jo in zip(touts, jouts):
        assert len(to) == len(jo)
        for t, j in zip(to, jo):
            assert tuple(t.shape) == j.shape
            if _is_decision(t):
                np.testing.assert_array_equal(t.numpy(), j)
            else:
                assert rel(t.numpy(), j) <= REL
    assert_state_close(st, states[-1], span=_span(ref, name))


@pytest.mark.parametrize("name", ["psk_track_ragged", "fsk_track_ragged",
                                  "psk_track_ragged_planes", "fsk_track_ragged_planes"])
def test_ragged_counts_follow_the_clock(ref, name):
    """Emission counts equal JAX's, and exceed the nominal count on the fast
    clock (the skip/stuff point); compact_ragged gives JAX's own stream."""
    _, jouts = ref[name]
    _, touts = _port_blocks(ref, name)
    sps = ref["params"][CHAINS[name][0]][0].sps
    decim = ref["params"][CHAINS[name][0]][0].decim
    nominal = 2 * CHAINS[name][6] // (decim * sps)
    tv = torch.cat([o[-1] for o in touts], dim=-1)
    ti = torch.cat([o[0] for o in touts], dim=-1)
    jv = np.concatenate([o[-1] for o in jouts], axis=-1)
    ji = np.concatenate([o[0] for o in jouts], axis=-1)
    np.testing.assert_array_equal(tv.sum(-1).numpy(), jv.sum(-1))
    assert int(tv.sum(-1).min()) > nominal
    for got, want in zip(ttr.compact_ragged(ti, tv), jtr.compact_ragged(ji, jv)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,convert_fn", [
    ("psk_track", convert.psk_track_state_from),
    ("fsk_track_ragged", convert.fsk_track_ragged_state_from),
    ("psk_track_planes", convert.psk_track_planes_state_from),
    ("fsk_track_planes", convert.fsk_track_planes_state_from),
    ("psk_track_ragged_planes", convert.psk_track_ragged_planes_state_from),
])
def test_jax_state_handed_over_mid_stream(ref, name, convert_fn):
    """JAX runs block 0, the port takes its state and runs block 1: JAX's
    own block 1 comes out."""
    states, jouts = ref[name]
    st, touts = _port_blocks(ref, name, state=convert_fn(states[1], device="cpu"), start=1)
    for t, j in zip(touts[0], jouts[1]):
        if _is_decision(t):
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            assert rel(t.numpy(), j) <= REL
    assert_state_close(st, states[-1], span=_span(ref, name))


def _rc_qpsk(seed, nsym, sps, channels=C):
    """Pulse-shaped QPSK (RRC twice: raised cosine) at a fixed offset."""
    rng = np.random.default_rng(seed)
    p = tpsk.make_psk_params(0.0, 1, sps, 4, device="cpu")
    sym = np.exp(2j * np.pi * (rng.integers(0, 4, (channels, nsym)) + 0.5) / 4)
    x = resample_full(p.taps, torch.from_numpy(sym.astype(np.complex64)), up=sps, down=1)
    return np.ascontiguousarray(x.numpy()[:, : nsym * sps])


def test_gardner_scan_and_planes_equal_to_jax():
    sps = 8
    x = _rc_qpsk(4, 300, sps)
    jst, jsym = jsl.gardner_scan(jsl.gardner_init((C,), tau0=3.0), jnp.asarray(x), sps)
    tst, tsym = tsl.gardner_scan(tsl.gardner_init((C,), tau0=3.0, device="cpu"),
                                 torch.from_numpy(x), sps)
    assert tsym.dtype == torch.complex64 and rel(tsym.numpy(), jsym) <= REL
    assert_state_close(tst, jst)
    jst, (jr, ji) = jtp.gardner_scan_planes(jsl.gardner_init((C,), tau0=3.0),
                                            jnp.asarray(x.real), jnp.asarray(x.imag), sps)
    tst, (tr, ti) = ttp.gardner_scan_planes(tsl.gardner_init((C,), tau0=3.0, device="cpu"),
                                            torch.from_numpy(x.real.copy()),
                                            torch.from_numpy(x.imag.copy()), sps)
    assert rel(tr.numpy(), jr) <= REL and rel(ti.numpy(), ji) <= REL
    assert_state_close(tst, jst)


def test_gardner_free_scan_and_planes_equal_to_jax():
    sps = 4
    x = _sustained(_rc_qpsk(5, 300, sps), 3e-3)[:, : 1 + 256 * sps]
    x = np.ascontiguousarray(x[:, : sps + 256 * sps - 4])  # [sps tail | N]
    jst, (jsym, jv) = jsl.gardner_free_scan(jsl.gardner_free_init((C,), tau0=1.0),
                                            jnp.asarray(x), sps)
    tst, (tsym, tv) = tsl.gardner_free_scan(tsl.gardner_free_init((C,), tau0=1.0, device="cpu"),
                                            torch.from_numpy(x), sps)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert rel(tsym.numpy(), jsym) <= REL
    assert_state_close(tst, jst, span=x.shape[-1])
    jst, (jr, ji, jv) = jtp.gardner_free_scan_planes(
        jtp.gardner_free_init_planes((C,), tau0=1.0), jnp.asarray(x.real),
        jnp.asarray(x.imag), sps)
    tst, (tr, ti, tv) = ttp.gardner_free_scan_planes(
        ttp.gardner_free_init_planes((C,), tau0=1.0, device="cpu"),
        torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()), sps)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert rel(tr.numpy(), jr) <= REL and rel(ti.numpy(), ji) <= REL
    assert_state_close(tst, jst, span=x.shape[-1])


@pytest.mark.parametrize("order,masked", [(4, False), (4, True), (2, False), (8, True)])
def test_costas_scan_and_planes_equal_to_jax(order, masked):
    rng = np.random.default_rng(order)
    k = 300
    off = tpsk.constellation_offset(order)
    sym = np.exp(2j * np.pi * (rng.integers(0, order, (C, k)) + off) / order)
    sym = (sym * np.exp(1j * (0.3 + 0.004 * np.arange(k)))).astype(np.complex64)
    valid = rng.random((C, k)) > 0.2 if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    jst, jout = jsl.costas_scan(jsl.costas_init((C,)), jnp.asarray(sym), order, offset=off,
                                valid=jv)
    tst, tout = tsl.costas_scan(tsl.costas_init((C,), device="cpu"), torch.from_numpy(sym),
                                order, offset=off, valid=tv)
    assert tout.dtype == torch.complex64 and rel(tout.numpy(), jout) <= REL
    assert_state_close(tst, jst)
    jst, (jr, ji) = jtp.costas_scan_planes(jsl.costas_init((C,)), jnp.asarray(sym.real),
                                           jnp.asarray(sym.imag), order, offset=off, valid=jv)
    tst, (tr, ti) = ttp.costas_scan_planes(tsl.costas_init((C,), device="cpu"),
                                           torch.from_numpy(sym.real.copy()),
                                           torch.from_numpy(sym.imag.copy()), order,
                                           offset=off, valid=tv)
    assert rel(tr.numpy(), jr) <= REL and rel(ti.numpy(), ji) <= REL
    assert_state_close(tst, jst)
    np.testing.assert_array_equal(
        ttp.psk_slice_planes(tr, ti, order, off).numpy(),
        np.asarray(jtp.psk_slice_planes(jr, ji, order, off)))


def test_gardner_free_cap_equal():
    for n in (256, 1000, 4096, 65536):
        for sps in (2, 4, 8):
            for dev in (0.0, 0.01, 0.05, 0.2):
                assert tsl.gardner_free_cap(n, sps, dev) == jsl.gardner_free_cap(n, sps, dev)


def test_inits_match_jax_shapes():
    params = _params()
    for name, (pk, tinit, _, jinit, _, _, _, planes) in CHAINS.items():
        tpar, jpar = params[pk]
        ts = tinit(tpar, C, tau0=0.5) if planes else tinit(tpar, (C,), tau0=0.5)
        js = jinit(jpar, C, tau0=0.5) if planes else jinit(jpar, (C,), tau0=0.5)
        assert_state_close(ts, js)
