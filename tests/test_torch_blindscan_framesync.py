"""Port vs JAX package: the blind survey and the burst detector,
``chains/blindscan`` and ``chains/framesync``.

Fixtures (numpy, seeded): the reference's three-signal capture
(``tests/unit/test_blindscan.py``: QPSK at 0.15, CPFSK at -0.22, a tone at
0.35 over noise, 2^16 samples; the PSK bursts RRC-shaped here in numpy), a
CSS stream at sf 8 and -5 dB with a timing offset and CFO, and a 64-symbol
QPSK preamble at three starts in 8,192 samples at 10 dB, streamed in blocks
of 1,024 (one burst straddles a block seam). The JAX side runs once per
module.

Contracts:

- bit-exact: the detections' bin extents (bandwidth) and their order,
  `baud_estimate` and `classify_mpsk` (host numpy on both sides),
  `detect_css`'s decision, sf and direction, the frame-sync masks, first
  indices, peak indices and burst starts;
- the survey's floats from the Welch PSD (centers within 1e-6 cycles,
  power within 1e-4 dB; the PSD itself agrees to float32 rounding);
  `detect_css`'s scores (rounded to 0.01 by the function) within 0.01;
- frame-sync scores within rel L2 1e-5 (one pass), and every mask decision
  clears its threshold and its neighbours by at least 1e-4 (measured:
  0.239), far above that rounding, so no mask can flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import blindscan as jbs
from srcdsp_tpu.chains import framesync as jfs
from srcdsp_tpu.chains.css import css_modulate, make_css_params
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import blindscan as tbs
from srcdsp_tpu_torch.chains import framesync as tfs
from srcdsp_tpu_torch.ops.window import root_raised_cosine
from srcdsp_tpu_torch.testing.signals import fsk_baseband, tone
from tests.torch_threads import one_torch_thread  # noqa: F401

N_SCAN, BLOCK, T = 1 << 16, 1024, 64
STARTS = [500, 2040, 7000]       # 2040 + 63 straddles the 2048 seam


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _psk(rng, nsym, order, sps, center):
    sym = np.exp(2j * np.pi * (rng.integers(0, order, nsym) + 0.5) / order)
    up = np.zeros(nsym * sps, np.complex128)
    up[::sps] = sym
    y = np.convolve(up, root_raised_cosine(sps, 8))[: up.size]
    return (y * tone(y.size, center)).astype(np.complex64)


def _survey_capture():
    rng = np.random.default_rng(0)
    x = (0.02 * (rng.standard_normal(N_SCAN) + 1j * rng.standard_normal(N_SCAN))
         ).astype(np.complex64)
    x += _psk(rng, N_SCAN // 8, 4, 8, 0.15)
    fsk = fsk_baseband(rng.integers(0, 2, N_SCAN // 16), 16, 0.01) * 0.7
    x[: fsk.size] += fsk * tone(fsk.size, -0.22)
    x += 0.5 * tone(N_SCAN, 0.35)
    return x


def _css_capture():
    rng = np.random.default_rng(5)
    p = make_css_params(sf=8)
    x = np.concatenate([np.zeros(173, np.complex64), css_modulate(p, rng.integers(0, p.n, 60))])
    x = x * np.exp(2j * np.pi * 0.013 * np.arange(x.size))
    sigma = np.sqrt(10 ** (5 / 10) / 2)
    return (x + sigma * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
            ).astype(np.complex64)


def _scene():
    rng = np.random.default_rng(42)
    pre = np.exp(2j * np.pi * (rng.integers(0, 4, T) + 0.5) / 4).astype(np.complex64)
    x = 10 ** (-0.5) * (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)) / np.sqrt(2)
    for s in STARTS:
        x[s:s + T] += pre
    return pre, x.astype(np.complex64)


@pytest.fixture(scope="module")
def ref():
    out = {"x": _survey_capture(), "css": _css_capture()}
    out["scan"] = jbs.scan(out["x"], nfft=4096)
    out["detect"] = jbs.detect_css(out["css"])
    pre, x = _scene()
    params = jfs.make_frame_sync_params(pre, threshold=0.6)
    step = jax.jit(lambda s, v: jfs.frame_sync_apply(params, s, v))
    st = jfs.frame_sync_init(params)
    states, outs = [], []
    for b in range(0, x.size, BLOCK):
        st, o = step(st, jnp.asarray(x[b:b + BLOCK]))
        states.append(st)
        outs.append([np.asarray(v) for v in o])
    out.update(pre=pre, scene=x, params=params, states=states, outs=outs)
    return out


def test_scan_equal(ref):
    got = tbs.scan(ref["x"], nfft=4096, device="cpu")
    want = ref["scan"]
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.bandwidth == w.bandwidth
        assert abs(g.center - w.center) <= 1e-6 and abs(g.power_db - w.power_db) <= 1e-4
    np.testing.assert_allclose(sorted(d.center for d in got[:3]), [-0.22, 0.15, 0.35], atol=0.01)


def test_scan_takes_a_tensor_where_it_lies(ref):
    got = tbs.scan(torch.as_tensor(ref["x"]), nfft=4096)
    assert [d.bandwidth for d in got] == [d.bandwidth for d in ref["scan"]]


@pytest.mark.parametrize("sps,center", [(8, 0.0), (6, 0.19)])
def test_baud_estimate_equal(sps, center):
    x = _psk(np.random.default_rng(sps), 4096, 4, sps, center) * tone(4096 * sps, -center)
    got = tbs.baud_estimate(torch.as_tensor(x), f_lo=0.02)
    assert got == jbs.baud_estimate(x, f_lo=0.02)
    np.testing.assert_allclose(got[0], 1 / sps, rtol=0.01)


@pytest.mark.parametrize("order", [2, 4])
def test_classify_mpsk_equal(order):
    rng = np.random.default_rng(4 + order)
    x = _psk(rng, 2048, order, 4, 0.07)
    x = (x + 0.05 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
         ).astype(np.complex64)
    got = tbs.classify_mpsk(x)
    assert got == jbs.classify_mpsk(x) and got[0] == order


def test_detect_css_equal(ref):
    got = tbs.detect_css(ref["css"], device="cpu")
    want = ref["detect"]
    assert (got["detected"], got["sf"], got["direction"]) == (True, 8, "up")
    assert (got["detected"], got["sf"], got["direction"]) == (
        want["detected"], want["sf"], want["direction"])
    assert got["scores"].keys() == want["scores"].keys()
    for k in want["scores"]:
        assert abs(got["scores"][k] - want["scores"][k]) <= 0.01 + 1e-9
    noise = np.random.default_rng(9).standard_normal(1 << 14).astype(np.complex64)
    assert tbs.detect_css(noise, device="cpu")["detected"] is False


def _decision_margin(ext: np.ndarray, thr: float) -> float:
    """Least distance by which any mask decision is decided: a True mask
    needs all three comparisons, a False one its clearest failing one."""
    n = ext.size - 2
    mid, left, right = ext[1:n + 1], ext[:n], ext[2:]
    d = np.stack([mid - thr, mid - left, mid - right])   # True where > (>= right)
    ok = (d[0] > 0) & (d[1] > 0) & (d[2] >= 0)
    return float(min(d[:, ok].min(initial=np.inf),
                     np.where(d[:, ~ok] <= 0, -d[:, ~ok], 0).max(axis=0).min(initial=np.inf)))


def _run_port(params, x, state=None, start=0):
    st = tfs.frame_sync_init(params, ()) if state is None else state
    outs = []
    for b in range(start, x.size, BLOCK):
        st, o = tfs.frame_sync_apply(params, st, torch.as_tensor(x[b:b + BLOCK]))
        outs.append(o)
    return st, outs


def _check(outs, jouts):
    for (s, m, f), (js, jm, jf) in zip(outs, jouts):
        assert m.dtype == torch.bool and s.dtype == torch.float32
        np.testing.assert_array_equal(m.numpy(), jm)
        assert int(f) == int(jf)
        assert rel(s.numpy(), js) <= 1e-5


def test_frame_sync_stream_equal(ref):
    params = tfs.make_frame_sync_params(ref["pre"], threshold=0.6, device="cpu")
    st, outs = _run_port(params, ref["scene"])
    _check(outs, ref["outs"])
    jst = ref["states"][-1]
    assert int(st.base) == int(jst.base)
    assert rel(st.prev2.numpy(), jst.prev2) <= 1e-5
    peaks = tfs.peak_indices([o[1] for o in outs], [int(o[2]) for o in outs])
    jpeaks = jfs.peak_indices([o[1] for o in ref["outs"]], [int(o[2]) for o in ref["outs"]])
    np.testing.assert_array_equal(peaks, jpeaks)
    assert sorted(tfs.peak_to_burst_start(pk, T) for pk in peaks) == STARTS
    # every decision sits far from float32 rounding of the scores
    ext = np.concatenate([np.zeros(1, np.float32)] + [o[0].numpy() for o in outs]
                         + [np.zeros(1, np.float32)])
    assert _decision_margin(ext, 0.6) >= 1e-4


def test_frame_sync_jax_state_handoff(ref):
    params = convert.frame_sync_params_from(ref["params"], device="cpu")
    st = convert.frame_sync_state_from(ref["states"][2], device="cpu")
    _, outs = _run_port(params, ref["scene"], state=st, start=3 * BLOCK)
    _check(outs, ref["outs"][3:])


def test_frame_sync_params_round_trip(ref):
    p = convert.frame_sync_params_from(ref["params"], device="cpu")
    q = tfs.make_frame_sync_params(ref["pre"], threshold=0.6, device="cpu")
    assert torch.equal(p.mf_taps, q.mf_taps) and torch.equal(p.en_taps, q.en_taps)
    assert (p.pnorm, p.threshold) == (q.pnorm, q.threshold)
