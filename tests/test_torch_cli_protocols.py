"""The port's CLI decoder subcommands (``srcdsp_tpu_torch.cli``): adsb, ais,
rds, gps, pocsag, ax25, css, apt, acars, sstv, navtex, rtty, same and cw.

Each capture is made with the port's numpy generators from a seed at the
reference CLI tests' sizes (``tests/e2e/test_*.py``), written to a file and
decoded by the port's CLI with ``--device cpu``; every case decodes what was
sent. Where the reference CLI's own case is cheap (adsb, rds, css, acars,
navtex, rtty, sstv, same, apt, cw), the JAX CLI decodes the same file and
the outputs are compared: JSON records and text equal, the APT image within
one grey level, the SSTV image within one level on every pixel but each
scan's last, which the port repairs (the reference sums it to the end of the
stream). ais, ax25, pocsag and gps are held to the sent content and to the
port's own library call on the same capture, so their reference runs (11-33
s each) are not repeated.
"""

import json

import numpy as np
import pytest
import torch

from srcdsp_tpu.cli import main as jax_cli
from srcdsp_tpu_torch.cli import main as port_cli
from srcdsp_tpu_torch.io.capture import CaptureMeta, write_capture
from tests.torch_threads import one_torch_thread  # noqa: F401


def _noise(rng, n, sigma):
    return (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def _cf32(path, x) -> str:
    write_capture(str(path), np.asarray(x, np.complex64), CaptureMeta(fmt="cf32"))
    return str(path)


def _f32(path, a) -> str:
    np.asarray(a, np.float32).tofile(path)
    return str(path)


def _port(argv):
    port_cli(argv + ["--device", "cpu"])


def _both(tmp_path, argv):
    """The JAX CLI's and the port's outputs of `argv` ("{out}" -> each
    side's path), as bytes."""
    outs = []
    for tag, run in (("j", jax_cli), ("p", _port)):
        path = str(tmp_path / f"{tag}.out")
        run([a.replace("{out}", path) for a in argv])
        outs.append(open(path, "rb").read())
    return outs


def _jsonl(raw: bytes) -> list:
    return [json.loads(line) for line in raw.decode().splitlines()]


def test_adsb(tmp_path):
    from srcdsp_tpu_torch.chains.adsb import build_frame, modulate

    rng = np.random.default_rng(6)
    frames = [build_frame(rng.integers(0, 2, 88).astype(np.int32)) for _ in range(2)]
    cap = _noise(rng, 12000, 0.06)
    for f, off in zip(frames, (1500, 7000)):
        w = modulate(f, sps_half=2)
        cap[off: off + w.size] += w.astype(np.complex64)
    j, p = _both(tmp_path, ["adsb", _cf32(tmp_path / "es.cf32", cap), "{out}", "--sps-half", "2"])
    assert j == p
    recs = _jsonl(p)
    assert [r["start"] for r in recs] == [1500, 7000]
    assert [bytes.fromhex(r["hex"]) for r in recs] == [
        np.packbits(f.reshape(-1, 8)).tobytes() for f in frames]


def test_ais(tmp_path):
    from srcdsp_tpu_torch.chains.ais import build_ais_frame, decode_all_ais_frames
    from srcdsp_tpu_torch.chains.fsk import fsk_capture_bits
    from srcdsp_tpu_torch.testing.signals import gmsk_baseband, tone

    p1, p2 = b"ais-cli-#1", b"ais-cli-#2!!"
    rng = np.random.default_rng(4)
    line = np.concatenate([rng.integers(0, 2, 48), build_ais_frame(p1), rng.integers(0, 2, 200),
                           build_ais_frame(p2), rng.integers(0, 2, 48)]).astype(np.int32)
    x = gmsk_baseband(line, 8, bt=0.4)
    x = (x * tone(x.size, 0.002) + _noise(rng, x.size, 0.04)).astype(np.complex64)
    out = str(tmp_path / "msgs.jsonl")
    _port(["ais", _cf32(tmp_path / "vhf.cf32", x), out, "--decim", "2", "--sps", "4"])
    recs = [json.loads(line) for line in open(out)]
    assert [bytes.fromhex(r["hex"]) for r in recs] == [p1, p2]
    lib = decode_all_ais_frames(fsk_capture_bits(torch.as_tensor(x), 0.0, 64, 0.45 / 2, 4,
                                                 0.25 / 4, decim=2, timing_forget=0.95))
    assert [(r["start_bit"], bytes.fromhex(r["hex"])) for r in recs] == [
        (int(s), pl) for pl, s in lib]


def test_rds(tmp_path):
    from srcdsp_tpu_torch.chains.analog import fm_modulate, fm_stereo_mpx
    from srcdsp_tpu_torch.chains.rds import rds_encode_group, rds_inject_mpx

    fs, sps_half = 228000.0, 96
    f_pilot = 19000.0 / fs
    rng = np.random.default_rng(8)
    words = [rng.integers(0, 1 << 16, 4).tolist() for _ in range(2)]
    bits = np.concatenate([rds_encode_group(w, "A") for w in words]).astype(np.int32)
    t = np.arange(bits.size * 2 * sps_half + 8000)
    mpx = fm_stereo_mpx(0.3 * np.sin(2 * np.pi * 1000 / fs * t),
                        0.3 * np.sin(2 * np.pi * 2500 / fs * t), f_pilot)
    mpx = rds_inject_mpx(mpx, bits, f_pilot, sps_half, level=0.07)
    iq = fm_modulate(mpx.astype(np.float32), 0.3, device="cpu").numpy()
    j, p = _both(tmp_path, ["rds", _cf32(tmp_path / "fm.cf32", iq), "{out}", "--sps-half",
                            str(sps_half), "--pilot", str(f_pilot), "--dev", "0.3"])
    assert j == p
    recs = _jsonl(p)
    assert [[int(w, 16) for w in r["words"]] for r in recs[:2]] == words


def test_gps(tmp_path):
    from srcdsp_tpu_torch.chains.gps import (acquire_ca, ca_code, fine_acquire, make_gps_acq,
                                             sample_ca)

    prn, sps, nb = 9, 2, 6
    n1 = 1023 * sps
    rng = np.random.default_rng(9)
    chips = np.tile(np.roll(sample_ca(ca_code(prn), sps), 404), nb)
    x = chips * np.exp(2j * np.pi * 4.0 / (2 * n1) * np.arange(nb * n1))
    x = (x + np.sqrt(50.0) * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
         ).astype(np.complex64)
    capf = _cf32(tmp_path / "gps.cf32", x)
    out = str(tmp_path / "acq.jsonl")
    _port(["gps", capf, out, "--sps", str(sps), "--prn", str(prn)])
    recs = [json.loads(line) for line in open(out)]
    assert len(recs) == 1 and recs[0]["prn"] == prn
    assert abs(recs[0]["code_phase_samples"] - 404) < 1.0
    acq = make_gps_acq(prn, sps=sps, device="cpu")
    res = acquire_ca(acq, x, np.arange(-10, 11) / (2.0 * acq.n))
    fine = fine_acquire(acq, res)
    assert recs[0]["ratio"] == round(float(res["ratio"]), 2)
    assert recs[0]["doppler_cps"] == float(fine["doppler"])
    out2 = str(tmp_path / "acq2.jsonl")
    _port(["gps", capf, out2, "--sps", str(sps), "--prn", "20"])
    assert open(out2).read() == ""


def test_pocsag(tmp_path):
    from srcdsp_tpu_torch.chains.pocsag import (decode_transmission, encode_numeric,
                                                encode_transmission, pocsag_baseband)

    sps, dev = 8, 0.05
    bits = encode_transmission([(0x2A2A1, 0, encode_numeric("31337"))], preamble_bits=64)
    rng = np.random.default_rng(4)
    x = np.concatenate([np.zeros(500, np.complex64), pocsag_baseband(bits, sps, dev)
                        .astype(np.complex64), np.zeros(1024, np.complex64)])
    x = (x + _noise(rng, x.size, 0.04)).astype(np.complex64)
    out = str(tmp_path / "pages.jsonl")
    _port(["pocsag", _cf32(tmp_path / "pager.cf32", x), out, "--sps", str(sps), "--dev",
           str(dev), "--decim", "1"])
    recs = [json.loads(line) for line in open(out)]
    assert len(recs) == 1 and recs[0]["ric"] == 0x2A2A1 and recs[0]["numeric"] == "31337"
    assert decode_transmission(bits)[0]["data"] == [int(w, 16) for w in recs[0]["data"]]


def test_ax25(tmp_path):
    from srcdsp_tpu_torch.chains.ax25 import afsk_modulate, build_aprs_frame, decode_ax25_audio

    fs, sps = 13200.0, 11
    audio = np.concatenate([np.zeros(500, np.float32),
                            afsk_modulate(build_aprs_frame("N0CALL", "CLI TEST"), sps,
                                          1200 / fs, 2200 / fs),
                            np.zeros(500, np.float32)]).astype(np.float32)
    out = str(tmp_path / "frames.jsonl")
    _port(["ax25", _f32(tmp_path / "audio.f32", audio), out, "--fs", str(fs)])
    recs = [json.loads(line) for line in open(out)]
    assert len(recs) == 1 and recs[0]["src"] == "N0CALL-0" and recs[0]["info"] == "CLI TEST"
    lib = decode_ax25_audio(audio, sps, 1200 / fs, 2200 / fs, device="cpu")
    assert recs[0]["start_bit"] == lib[0]["start_bit"]


def test_css(tmp_path):
    from srcdsp_tpu_torch.chains import css

    rng = np.random.default_rng(5)
    p = css.make_css_params(sf=7, cr=4)
    payload = b"cli css burst 1!"
    x = np.concatenate([np.zeros(300, np.complex64), css.css_transmit(p, payload),
                        np.zeros(300, np.complex64)])
    x = (x + _noise(rng, x.size, 0.05)).astype(np.complex64)
    j, p_ = _both(tmp_path, ["css", _cf32(tmp_path / "css.cf32", x), "{out}", "--css-sf", "7",
                             "--css-cr", "4", "--css-len", str(len(payload))])
    assert j == p_
    recs = _jsonl(p_)
    assert len(recs) == 1 and recs[0]["crc_ok"] and bytes.fromhex(recs[0]["hex"]) == payload


def _apt_image(nl, rng):
    img = rng.standard_normal((nl, 909))
    img = np.apply_along_axis(lambda r: np.convolve(r, np.ones(9) / 9.0, "same"), 1, img)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def test_apt(tmp_path):
    from srcdsp_tpu_torch.chains import apt
    from srcdsp_tpu_torch.chains.analog import fm_modulate

    rng = np.random.default_rng(11)
    p = apt.make_apt_params(device="cpu")
    img = _apt_image(6, rng)
    mpx = apt.apt_modulate(p, apt.apt_build_lines(img))
    iq = fm_modulate((mpx * 0.9).astype(np.float32), 0.25, device="cpu").numpy()
    j, p_ = _both(tmp_path, ["apt", _cf32(tmp_path / "apt.cf32", iq), "{out}",
                             "--dev", str(0.25 * 0.9)])
    head = b"P5\n2080 6\n255\n"
    assert j.startswith(head) and p_.startswith(head)
    pj = np.frombuffer(j[len(head):], np.uint8).astype(int)
    pp = np.frombuffer(p_[len(head):], np.uint8).astype(int)
    assert np.abs(pj - pp).max() <= 1
    a0, aw = apt.apt_line_layout()["video_a"]
    got = pp.reshape(6, 2080)[1:-1, a0: a0 + aw] / 255.0
    assert np.mean((img[1: 1 + got.shape[0]] - got) ** 2) < float(np.var(img)) / 20.0


def test_acars(tmp_path):
    from srcdsp_tpu_torch.chains import acars

    rng = np.random.default_rng(12)
    bits = acars.build_acars_frame(b"CLI BLOCK", address=".CLINE1", label="SA")
    x = np.concatenate([np.zeros(900, np.float32), acars.acars_modulate(bits, 20, 48000.0),
                        np.zeros(900, np.float32)])
    iq = ((1.0 + 0.8 * x) * np.exp(1j * 2 * np.pi * 0.003 * np.arange(x.size))
          ).astype(np.complex64) + _noise(rng, x.size, 0.01)
    j, p = _both(tmp_path, ["acars", _cf32(tmp_path / "acars.cf32", iq), "{out}"])
    assert j == p
    recs = _jsonl(p)
    assert len(recs) == 1 and recs[0]["bcs_ok"] and recs[0]["address"] == ".CLINE1"
    assert recs[0]["text"] == "CLI BLOCK"


def test_sstv(tmp_path):
    from srcdsp_tpu_torch.chains import sstv

    rng = np.random.default_rng(13)
    h = 8
    img = rng.random((h, 40, 3))
    img = np.repeat(img, 8, axis=1).astype(np.float32)           # smooth along a line
    audio = sstv.sstv_modulate(sstv.make_sstv_params(height=h, device="cpu"), img)
    j, p = _both(tmp_path, ["sstv", _f32(tmp_path / "sstv.f32", audio), "{out}", "--mpx",
                            "--lines", str(h)])
    head = b"P6\n320 8\n255\n"
    assert j.startswith(head) and p.startswith(head)
    pj = np.frombuffer(j[len(head):], np.uint8).reshape(h, 320, 3).astype(int)
    pp = np.frombuffer(p[len(head):], np.uint8).reshape(h, 320, 3).astype(int)
    assert np.abs(pj[:, :-1] - pp[:, :-1]).max() <= 1
    err = (pp[:, 2:-2] / 255.0 - img[:, 2:-2]) ** 2
    assert 10 * np.log10(float(np.var(img)) / float(err.mean())) > 14.0


def test_navtex(tmp_path):
    from srcdsp_tpu_torch.chains import navtex

    sps, dev = 20, 0.05
    msg = navtex.navtex_build("K", "B", "12", "NO WARNINGS")
    x = navtex.navtex_modulate(navtex.sitor_b_encode(navtex._text_codes(msg)), sps, dev)
    x = np.concatenate([x, np.zeros(40 * sps, np.complex64)])
    j, p = _both(tmp_path, ["navtex", _cf32(tmp_path / "navtex.cf32", x), "{out}",
                            "--sps", str(sps), "--dev", str(dev)])
    assert j == p
    rec = json.loads(p)
    assert rec["ok"] and rec["station"] == "K" and rec["serial"] == "12"
    assert "NO WARNINGS" in rec["body"]


def test_rtty(tmp_path):
    from srcdsp_tpu_torch.chains import rtty

    text = "RYRYRY DE CLI TEST"
    x = rtty.rtty_modulate(rtty.uart_frame(rtty.ita2_encode(text)), sps_half=10, dev=0.04)
    j, p = _both(tmp_path, ["rtty", _cf32(tmp_path / "rtty.cf32",
                                          np.concatenate([x, np.ones(100, np.complex64)])),
                            "{out}", "--sps", "10", "--dev", "0.04"])
    assert j == p and text in p.decode()


def test_same(tmp_path):
    from srcdsp_tpu_torch.chains import same

    fs = 12500.0
    hdr = same.same_build("EAS", "RWT", "099999", "0015", "2331200", "CLITEST")
    burst = same.same_modulate(same.same_bytes_bits(hdr.encode()), fs)
    audio = np.concatenate([np.zeros(500, np.float32), burst, np.zeros(500, np.float32)])
    j, p = _both(tmp_path, ["same", _f32(tmp_path / "same.f32", audio), "{out}", "--mpx"])
    assert j == p
    recs = _jsonl(p)
    assert len(recs) == 1 and recs[0]["event"] == "RWT" and recs[0]["sender"] == "CLITEST"


def test_cw(tmp_path):
    from srcdsp_tpu_torch.chains import cw

    x = cw.cw_modulate("HELLO CLI", 20.0, 8000.0, 700.0)
    j, p = _both(tmp_path, ["cw", _f32(tmp_path / "cw.f32", np.concatenate(
        [np.zeros(1000, np.float32), x, np.zeros(1000, np.float32)])), "{out}", "--mpx"])
    assert j == p
    rec = json.loads(p)
    assert rec["text"] == "HELLO CLI" and abs(rec["tone_hz"] - 700.0) < 10
