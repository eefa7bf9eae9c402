"""Port vs JAX package: `ops/fresh` and `ops/fresh_planes` (FRESH
cyclostationary interference rejection).

Fixtures: the reference tests' co-channel BPSK pair (sps 8 at carrier 0.02,
sps 5 at 0.035, RRC beta 0.9, noise 0.03; numpy, seeded), 16,384 samples,
the design on the first half and the filter on the second with n0 carrying
the global index; a stationary (noise-only) problem. The JAX side runs once
per module.

Contracts:

- bit for bit: the host helpers (`bpsk_branches`, `merge_branches`,
  `refine_cycle`, `_moment_lines`, `blind_bpsk_branches`), the FreshFilter
  carried across (`convert.fresh_filter_from`);
- rel L2 <= 1e-5: the regressors (`fresh_frames`: float32 rotators from the
  same float64 frac phase), `fresh_apply` with JAX's weights carried
  across, `make_fresh_planes` against the JAX planes function for the same
  filter;
- the port's own design: output SINR within 0.1 dB of JAX's design (the
  ridge Gram is rank-deficient, so the weights are not compared), the
  reference tests' margins over Wiener, the n0 phase-continuity loss;
- the planes against the port's `fresh_apply`: atol 2e-3 of the output's
  RMS (the u32-word against the float64 rotator phases) and SINR within
  0.1 dB (the reference test's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops import fresh as jfr
from srcdsp_tpu.ops import fresh_planes as jfp
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.ops import fresh as tfr
from srcdsp_tpu_torch.ops import fresh_planes as tfp
from srcdsp_tpu_torch.ops.window import root_raised_cosine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
N, TAPS = 16384, 24
HALF = N // 2


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bpsk(rng, nsym, sps, fc, beta=0.9):
    h = root_raised_cosine(sps, 8, beta)
    sym = 1.0 - 2.0 * rng.integers(0, 2, nsym).astype(np.float64)
    up = np.zeros(nsym * sps)
    up[::sps] = sym
    bb = np.convolve(up, h, mode="same")
    return (bb * np.exp(2j * np.pi * fc * np.arange(bb.size))).astype(np.complex64)


def _sinr(a, y, delay):
    d = a[HALF:][TAPS - 1 - delay: TAPS - 1 - delay + y.size]
    return 10 * np.log10(np.mean(np.abs(d) ** 2) / np.mean(np.abs(y - d) ** 2))


def _tuple(br):
    return tuple((float(b.alpha), bool(b.conj)) for b in br)


@pytest.fixture(scope="module")
def link():
    rng = np.random.default_rng(0)
    a = _bpsk(rng, N // 8 + 8, 8, 0.02)[:N]
    b = _bpsk(rng, N // 5 + 8, 5, 0.035)[:N]
    x = (a + b + 0.03 * (rng.standard_normal(N) + 1j * rng.standard_normal(N))).astype(np.complex64)
    genie = jfr.merge_branches(jfr.bpsk_branches(0.02, 1 / 8), jfr.bpsk_branches(0.035, 1 / 5))
    blind = jfr.blind_bpsk_branches(x[:HALF])
    out = dict(a=a, x=x, genie=genie, blind=blind, f={}, y={})
    for name, br in (("genie", genie), ("blind", blind), ("wiener", (jfr.FreshBranch(0.0, False),))):
        f = jfr.fresh_design(jnp.asarray(x[:HALF]), jnp.asarray(a[:HALF]), br, taps=TAPS, n0=0)
        out["f"][name] = f
        out["y"][name] = np.asarray(jfr.fresh_apply(f, jnp.asarray(x[HALF:]), n0=HALF))
    f = out["f"]["genie"]
    out["frames"] = np.asarray(jfr.fresh_frames(jnp.asarray(x[:2048]), genie, TAPS, n0=777))
    raw = jfp.make_fresh_planes(f, stride=128)
    nn = ((HALF - raw.hist) // 128) * 128
    seg = x[HALF: HALF + nn + raw.hist]
    yr, yi = jax.jit(raw, static_argnums=2)(jnp.asarray(seg.real[None, :]),
                                            jnp.asarray(seg.imag[None, :]), HALF)
    out["planes"] = (np.asarray(yr) + 1j * np.asarray(yi))[0]
    out["seg"] = seg
    out["geometry"] = (raw.hist, raw.stride, raw.taps_padded)
    return out


def test_branch_sets_bit_for_bit(link):
    for fc, baud, h in ((0.02, 1 / 8, 1), (0.035, 0.2, 2), (-0.1, 0.05, 3)):
        assert _tuple(tfr.bpsk_branches(fc, baud, h)) == _tuple(jfr.bpsk_branches(fc, baud, h))
    t = tfr.merge_branches(tfr.bpsk_branches(0.02, 1 / 8), tfr.bpsk_branches(0.035, 1 / 5))
    assert _tuple(t) == _tuple(link["genie"])


def test_host_cycle_helpers_bit_for_bit(link):
    x = link["x"][:HALF]
    for a0, conj in ((0.04, True), (0.125, False), (0.0701, True)):
        assert tfr.refine_cycle(x, a0, conj) == jfr.refine_cycle(x, a0, conj)
    assert tfr.refine_cycle(torch.as_tensor(x), 0.2, False) == jfr.refine_cycle(x, 0.2, False)
    v = x * x
    assert tfr._moment_lines(v, 2, 5e-3, 0.0) == jfr._moment_lines(v, 2, 5e-3, 0.0)
    m = (x * np.conj(x)).real
    assert tfr._moment_lines(m, 2, 5e-3, 2e-2, fold=True) == jfr._moment_lines(m, 2, 5e-3, 2e-2,
                                                                              fold=True)
    blind = tfr.blind_bpsk_branches(x)
    assert _tuple(blind) == _tuple(link["blind"])
    al = sorted(round(b.alpha, 4) for b in blind if not b.conj)
    assert -0.125 in al and 0.2 in al


def test_frames_and_filter_hand_over(link):
    phi = tfr.fresh_frames(link["x"][:2048], tfr.merge_branches(
        tfr.bpsk_branches(0.02, 1 / 8), tfr.bpsk_branches(0.035, 1 / 5)), TAPS, n0=777, device=CPU)
    assert phi.shape == link["frames"].shape == (2048 - TAPS + 1, len(link["genie"]) * TAPS)
    assert rel(phi.numpy(), link["frames"]) <= 1e-5
    for name in ("genie", "blind", "wiener"):
        jf = link["f"][name]
        f = convert.fresh_filter_from(jf, device=CPU)
        np.testing.assert_array_equal(f.weights.numpy(), np.asarray(jf.weights))
        assert (_tuple(f.branches), f.taps, f.delay) == (_tuple(jf.branches), jf.taps, jf.delay)
        y = tfr.fresh_apply(f, link["x"][HALF:], n0=HALF, device=CPU)
        assert rel(y.numpy(), link["y"][name]) <= 1e-5


def test_frames_content():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(np.complex64)
    br = (tfr.FreshBranch(0.0, False), tfr.FreshBranch(0.25, True))
    phi = tfr.fresh_frames(x, br, taps=4, device=CPU).numpy()
    assert phi.shape == (61, 8)
    np.testing.assert_array_equal(phi[:, 2], x[2:63])
    rot = np.conj(x) * np.exp(2j * np.pi * 0.25 * np.arange(64))
    np.testing.assert_allclose(phi[:, 4], rot[:61].astype(np.complex64), atol=1e-5)


def test_design_sinr_and_margins(link):
    """The port's own design on the same training block: SINR within 0.1 dB
    of JAX's for every branch set; FRESH beats Wiener by > 6 dB (genie) and
    > 8 dB (blind), and the blind set is within 2 dB of the genie one."""
    x, a = link["x"], link["a"]
    s = {}
    for name in ("genie", "blind", "wiener"):
        br = tuple(tfr.FreshBranch(float(b.alpha), bool(b.conj)) for b in link["f"][name].branches)
        f = tfr.fresh_design(x[:HALF], a[:HALF], br, taps=TAPS, n0=0, device=CPU)
        y = tfr.fresh_apply(f, torch.as_tensor(x[HALF:]), n0=HALF).numpy()
        s[name] = _sinr(a, y, f.delay)
        assert abs(s[name] - _sinr(a, link["y"][name], f.delay)) <= 0.1, name
    assert s["genie"] > s["wiener"] + 6.0 and s["genie"] > 9.0
    assert s["blind"] > s["wiener"] + 8.0 and s["blind"] > s["genie"] - 2.0
    f = tfr.fresh_design(x[:HALF], a[:HALF], tfr.merge_branches(
        tfr.bpsk_branches(0.02, 1 / 8), tfr.bpsk_branches(0.035, 1 / 5)), taps=TAPS, device=CPU)
    wrong = tfr.fresh_apply(f, x[HALF:], n0=0, device=CPU).numpy()
    assert s["genie"] > _sinr(a, wrong, f.delay) + 3.0


def test_apply_chunks_equal_one_chunk(link, monkeypatch):
    f = convert.fresh_filter_from(link["f"]["genie"], device=CPU)
    whole = tfr.fresh_apply(f, link["x"][HALF:], n0=HALF, device=CPU)
    monkeypatch.setattr(tfr, "APPLY_ROWS", 1000)
    chunked = tfr.fresh_apply(f, link["x"][HALF:], n0=HALF, device=CPU)
    assert chunked.shape == whole.shape and rel(chunked.numpy(), whole.numpy()) <= 1e-6


def test_reduces_to_wiener_without_cycles():
    rng = np.random.default_rng(4)
    n, taps = 4096, 9
    d = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    x = np.convolve(d, [1.0, 0.4, -0.2], mode="same").astype(np.complex64)
    x += (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)

    def mse(branches):
        f = tfr.fresh_design(x[: n // 2], d[: n // 2], branches, taps=taps, device=CPU)
        y = tfr.fresh_apply(f, x[n // 2:], device=CPU).numpy()
        dref = d[n // 2:][taps - 1 - f.delay: taps - 1 - f.delay + y.size]
        return float(np.mean(np.abs(y - dref) ** 2))

    m_w = mse((tfr.FreshBranch(0.0, False),))
    m_f = mse((tfr.FreshBranch(0.0, False), tfr.FreshBranch(0.21, False),
               tfr.FreshBranch(0.13, True)))
    assert abs(10 * np.log10(m_f / m_w)) < 1.0


def test_planes_equal_jax_planes_and_apply(link):
    f = convert.fresh_filter_from(link["f"]["genie"], device=CPU)
    fn = tfp.make_fresh_planes(f, stride=128, device=CPU)
    assert (fn.hist, fn.stride, fn.taps_padded) == link["geometry"] == (32, 128, 33)
    seg = link["seg"]
    yr, yi = fn(torch.as_tensor(seg.real[None, :].copy()), torch.as_tensor(seg.imag[None, :].copy()),
                HALF)
    y = (yr + 1j * yi).numpy()[0]
    assert rel(y, link["planes"]) <= 1e-5
    ref = tfr.fresh_apply(f, link["x"][HALF:], n0=HALF, device=CPU).numpy()[: y.size]
    scale = np.sqrt(np.mean(np.abs(ref) ** 2))
    np.testing.assert_allclose(y, ref, atol=2e-3 * scale)
    assert abs(_sinr(link["a"], y, f.delay) - _sinr(link["a"], ref, f.delay)) < 0.1
    assert _sinr(link["a"], y, f.delay) > 9.0


def test_planes_precision_and_geometry(link):
    f = convert.fresh_filter_from(link["f"]["wiener"], device=CPU)
    for prec in ("highest", "default", None, jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT):
        tfp.make_fresh_planes(f, precision=prec, device=CPU)
    for prec in ("high", jax.lax.Precision.HIGH, "bf16"):
        with pytest.raises(ValueError, match="precision"):
            tfp.make_fresh_planes(f, precision=prec, device=CPU)
    big = f._replace(weights=torch.zeros(160, dtype=torch.complex64), taps=160)
    with pytest.raises(ValueError, match="stride"):
        tfp.make_fresh_planes(big, stride=128, device=CPU)
    fn = tfp.make_fresh_planes(f, stride=128, device=CPU)
    with pytest.raises(ValueError, match="multiple of stride"):
        fn(torch.zeros(1, 100 + fn.hist), torch.zeros(1, 100 + fn.hist))
