"""Port vs JAX package: ``chains/{rds, gps}``.

Inputs are numpy, made from seeds; the JAX references run once per module
(the GPS searches jitted, as ``tests/unit/test_gps.py`` runs them).

Contracts:

- bit for bit: RDS checkwords, groups (versions A and B), all window
  syndromes, the biphase baseband and `rds_inject_mpx`; the C/A codes and
  the all-shifts operator (made on the device by a gather, equal to the
  reference's `np.roll` stack), `nav_preamble_detect`;
- decisions equal: `rds_sync_decode` on clean and single-bit-corrupted
  streams at an arbitrary offset; `rds_demod_mpx` bits on the MPX round trip
  of ``tests/unit/test_rds.py`` (stereo + RDS + noise); GPS peak cell
  (Doppler and code-phase index) of `acquire_ca` and `acquire_ca_planes`,
  the tracker's nav bits and bit phase, the preamble hits;
- rel L2 <= 1e-5: the GPS metric, `ratio`, the per-ms correlators, the fine
  code phase and Doppler, and the tracker's prompt. The reference's
  products are complex64 (`acquire_ca`) and DEFAULT-precision planes
  (`acquire_ca_planes`, float32 on the CPU); the port's are one float32
  matmul with TF32 off;
- the median: `jnp.median` averages the two middle values of an even count
  ([D, N] at sps 2 is even), `median_midpoint` does too; an odd count (sps
  1, odd D) takes the middle one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import gps as jg
from srcdsp_tpu.chains import rds as jr
from srcdsp_tpu.chains.analog import fm_stereo_mpx
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import gps as tg
from srcdsp_tpu_torch.chains import rds as tr
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
REL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- RDS -------------------------------------------------------------------

def _groups(rng, count):
    return [[int(v) for v in rng.integers(0, 1 << 16, 4)] for _ in range(count)]


def test_rds_codec_and_syndromes_bit_for_bit():
    rng = np.random.default_rng(0)
    for info in rng.integers(0, 1 << 16, 8):
        assert tr.rds_checkword(int(info)) == jr.rds_checkword(int(info))
    for v in ("A", "B"):
        for g in _groups(rng, 3):
            np.testing.assert_array_equal(tr.rds_encode_group(g, v), jr.rds_encode_group(g, v))
    bits = rng.integers(0, 2, 700).astype(np.int32)
    np.testing.assert_array_equal(tr.rds_syndromes(bits, device=CPU), jr.rds_syndromes(bits))
    np.testing.assert_array_equal(tr.rds_syndromes(torch.as_tensor(bits)), jr.rds_syndromes(bits))
    assert tr.rds_syndromes(bits[:20], device=CPU).size == 0
    np.testing.assert_array_equal(tr.rds_baseband(bits, 3), jr.rds_baseband(bits, 3))
    mpx = rng.standard_normal(5000).astype(np.float32)
    np.testing.assert_array_equal(tr.rds_inject_mpx(mpx, bits, 19 / 228, 4),
                                  jr.rds_inject_mpx(mpx, bits, 19 / 228, 4))


def test_rds_sync_decode_equals_reference():
    rng = np.random.default_rng(1)
    groups = _groups(rng, 6)
    stream = np.concatenate([rng.integers(0, 2, 37)] + [
        jr.rds_encode_group(g, "A" if k % 2 else "B") for k, g in enumerate(groups)]
        + [rng.integers(0, 2, 50)]).astype(np.int32)
    bad = stream.copy()
    bad[37 + 104 * 2 + 30] ^= 1
    bad[37 + 104 * 4 + 90] ^= 1
    for s in (stream, bad):
        for mg in (None, 3):
            got = tr.rds_sync_decode(torch.as_tensor(s), max_groups=mg)
            assert got == jr.rds_sync_decode(s, max_groups=mg)
    got = tr.rds_sync_decode(bad)
    assert [g["words"] for g in got] == groups and sum(g["corrected"] for g in got) == 2


def test_rds_mpx_round_trip_equals_reference():
    """tests/unit/test_rds.py's MPX: stereo + RDS at 228 kHz, sps_half 96."""
    fs = 228000.0
    f_pilot = 19000.0 / fs
    rng = np.random.default_rng(2)
    groups = _groups(rng, 4)
    bits = np.concatenate([jr.rds_encode_group(g) for g in groups])
    n = bits.size * 2 * 96 + 8000
    t = np.arange(n)
    mpx = fm_stereo_mpx(0.4 * np.sin(2 * np.pi * 1100.0 / fs * t),
                        0.4 * np.sin(2 * np.pi * 2700.0 / fs * t), f_pilot)
    mpx = jr.rds_inject_mpx(mpx, bits, f_pilot, 96, level=0.06)
    mpx = (mpx + 0.01 * rng.standard_normal(n).astype(np.float32)).astype(np.float32)
    want = jr.rds_demod_mpx(jnp.asarray(mpx), f_pilot, 96)
    got = tr.rds_demod_mpx(mpx, f_pilot, 96, device=CPU)
    np.testing.assert_array_equal(got, want)
    dec = tr.rds_sync_decode(got)
    assert dec == jr.rds_sync_decode(want)
    assert [g["words"] for g in dec] == groups[1:] or [g["words"] for g in dec] == groups


# --- GPS -------------------------------------------------------------------

def _gps_signal(prn, sps, nb, true_p, f, snr_amp, rng, nav=None):
    acq_code = jg.sample_ca(jg.ca_code(prn), sps)
    n = acq_code.size
    base = np.roll(acq_code, true_p)
    signs = np.ones(nb) if nav is None else np.repeat(1.0 - 2.0 * nav, 20)[:nb]
    chips = (base[None, :] * signs[:, None]).reshape(-1)
    t = np.arange(nb * n)
    x = snr_amp * chips * np.exp(2j * np.pi * f * t + 0.7j)
    x = x + (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size)) / np.sqrt(2)
    return x.astype(np.complex64)


@pytest.fixture(scope="module")
def gps_refs():
    """Two searches (sps 2: even count; sps 1 with 7 Dopplers: odd count),
    the plane form, fine acquisition and the tracker on a nav signal."""
    rng = np.random.default_rng(3)
    out = {}
    for name, (prn, sps, nb, p, k, ndop) in {"even": (7, 2, 4, 1234, 3.3, 9),
                                            "odd": (21, 1, 4, 500, -1.2, 7)}.items():
        acq = jg.make_gps_acq(prn, sps)
        n = acq.n
        x = _gps_signal(prn, sps, nb, p, k / (2.0 * n), 0.5, rng)
        dop = np.arange(-(ndop // 2), ndop // 2 + 1) / (2.0 * n)
        res = jax.jit(lambda v: jg.acquire_ca(acq, v, dop))(jnp.asarray(x))
        out[name] = (acq, x, dop, res, jg.fine_acquire(acq, res))
    acq, x, dop = out["even"][:3]
    out["planes"] = jax.jit(lambda a, b: jg.acquire_ca_planes(acq, a, b, dop))(
        jnp.asarray(x.real), jnp.asarray(x.imag))
    nav = np.concatenate([jg.NAV_PREAMBLE, rng.integers(0, 2, 8)]).astype(np.float64)
    acq3 = jg.make_gps_acq(3, 2)
    n = acq3.n
    xt = _gps_signal(3, 2, nav.size * 20, 700, 2.0 / (2.0 * n), 0.8, rng, nav)
    dop3 = np.arange(-4, 5) / (2.0 * n)
    res3 = jg.acquire_ca(acq3, jnp.asarray(xt), dop3)
    fine3 = jg.fine_acquire(acq3, res3)
    out["track"] = (acq3, xt, dop3, nav, jg.track_ca(acq3, jnp.asarray(xt), res3, fine3))
    return out


def test_ca_codes_and_operator_bit_for_bit():
    for prn in (1, 7, 19, 32):
        np.testing.assert_array_equal(tg.ca_code(prn), jg.ca_code(prn))
    acq = jg.make_gps_acq(7, 1)
    mine = tg.make_gps_acq(7, 1, device=CPU)
    np.testing.assert_array_equal(mine.shifts_t.numpy(), np.asarray(acq.shifts_t))
    assert (mine.n, mine.sps, mine.prn) == (acq.n, acq.sps, acq.prn)
    conv = convert.gps_acq_from_jax(acq, device=CPU)
    np.testing.assert_array_equal(conv.shifts_t.numpy(), mine.shifts_t.numpy())
    with pytest.raises(ValueError):
        tg.ca_code(33)


@pytest.mark.parametrize("case", ["even", "odd"])
def test_acquire_and_fine_equal_reference(gps_refs, case):
    acq_j, x, dop, res_j, fine_j = gps_refs[case]
    acq = convert.gps_acq_from_jax(acq_j, device=CPU)
    res = tg.acquire_ca(acq, x, dop)
    assert (int(res["d_idx"]), int(res["p_idx"])) == (int(res_j["d_idx"]), int(res_j["p_idx"]))
    assert rel(res["metric"], res_j["metric"]) <= REL
    assert rel(res["ratio"], res_j["ratio"]) <= REL
    assert rel(res["corr"], res_j["corr"]) <= REL
    assert float(res["doppler"]) == float(res_j["doppler"])
    fine = tg.fine_acquire(acq, res)
    assert rel(fine["code_phase"], fine_j["code_phase"]) <= REL
    assert rel(fine["doppler"], fine_j["doppler"]) <= REL
    count = res["metric"].numel()
    assert count % 2 == (0 if case == "even" else 1)
    assert float(tg.median_midpoint(res["metric"])) == pytest.approx(
        float(jnp.median(jnp.asarray(res["metric"].numpy()))), rel=1e-7)


def test_median_midpoint_even_and_odd_counts():
    for n in (1, 2, 7, 8, 41 * 2046):
        v = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        assert float(tg.median_midpoint(torch.as_tensor(v))) == float(jnp.median(v))
    v = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(tg.median_midpoint(v)) == 2.5 and float(torch.median(v)) == 2.0


def test_plane_form_equals_reference(gps_refs):
    acq_j, x, dop = gps_refs["even"][:3]
    res_j = gps_refs["planes"]
    acq = convert.gps_acq_from_jax(acq_j, device=CPU)
    res = tg.acquire_ca_planes(acq, x.real, x.imag, dop)
    assert (int(res["d_idx"]), int(res["p_idx"])) == (int(res_j["d_idx"]), int(res_j["p_idx"]))
    assert rel(res["metric"], res_j["metric"]) <= REL
    assert rel(res["ratio"], res_j["ratio"]) <= REL
    for a, b in zip(res["corr_planes"], res_j["corr_planes"]):
        assert rel(a, b) <= REL
    fine, fine_j = tg.fine_acquire(acq, res), jg.fine_acquire(acq_j, res_j)
    assert rel(fine["code_phase"], fine_j["code_phase"]) <= REL
    assert rel(fine["doppler"], fine_j["doppler"]) <= REL


def test_track_and_nav_bits_equal_reference(gps_refs):
    acq_j, xt, dop, nav, trk_j = gps_refs["track"]
    acq = tg.make_gps_acq(3, 2, device=CPU)
    res = tg.acquire_ca(acq, xt, dop)
    trk = tg.track_ca(acq, xt, res, tg.fine_acquire(acq, res))
    np.testing.assert_array_equal(trk["bits"].numpy(), np.asarray(trk_j["bits"]))
    assert trk["bit_phase"] == trk_j["bit_phase"]
    assert rel(trk["prompt"], trk_j["prompt"]) <= REL
    assert rel(trk["cn0_db_hz"], trk_j["cn0_db_hz"]) <= REL
    hits = tg.nav_preamble_detect(trk["bits"])
    assert hits == jg.nav_preamble_detect(np.asarray(trk_j["bits"]))
    b = trk["bits"].numpy()
    assert np.array_equal(b, nav.astype(np.int32)) or np.array_equal(1 - b, nav.astype(np.int32))


def test_track_with_code_doppler_equals_reference():
    """The host-built per-block replicas (tests/unit/test_gps.py's drift case)."""
    rng = np.random.default_rng(9)
    acq_j = jg.make_gps_acq(9, 2)
    acq = convert.gps_acq_from_jax(acq_j, device=CPU)
    nav = rng.integers(0, 2, 6).astype(np.float64)
    nb = nav.size * 20
    drift = 0.05
    cs = jg.sample_ca(jg.ca_code(9), 2)
    x = np.concatenate([np.roll(cs, 40 + int(round(b * drift))) * (1 - 2 * nav[b // 20])
                        for b in range(nb)]).astype(np.complex64)
    res_j = {"p_idx": jnp.asarray(40), "d_idx": jnp.asarray(0), "doppler": jnp.asarray(0.0)}
    fine_j = {"doppler": jnp.asarray(0.0)}
    trk_j = jg.track_ca(acq_j, jnp.asarray(x), res_j, fine_j, code_doppler=drift)
    trk = tg.track_ca(acq, x, {"p_idx": torch.tensor(40)}, {"doppler": torch.tensor(0.0)},
                      code_doppler=drift)
    np.testing.assert_array_equal(trk["bits"].numpy(), np.asarray(trk_j["bits"]))
    assert rel(trk["prompt"], trk_j["prompt"]) <= REL
