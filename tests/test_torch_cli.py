"""Port vs JAX package: the file -> chain -> file CLI (``srcdsp_tpu_torch.cli``
against ``srcdsp_tpu.cli``), and the seven names this slice adds to ported
modules (``configs.CONFIGS``, ``testing.signals.np_tone``,
``ops.planes.planes_to_int16``, ``ops.fir.np_fir_full``,
``ops.window.gaussian_freq_pulse``, ``ops.halfband.HalfbandCascade``).

Both CLIs read the same small files (numpy-made from seeds, at or below the
sizes of ``tests/e2e/test_cli.py``); the port's runs with ``--device cpu``.
The reference's runs are made once per module, four at a time in threads:
its chains run eagerly and compile each op per shape, which holds the GIL
only in part (19 s of four runs took 9.7 s in four threads). Contracts:

- byte-equal: `gen` (every kind and format), the u8 decisions of fsk, psk,
  qam, dqpsk, the tracking loops (their contract: decisions equal) and
  `channelize --demod psk`, all seven `fecenc` / `fecdec` codes (ldpc
  through the port's plain K14);
- rel L2 <= 1e-5: the cf32 / f32 files of fir, resample, fm, am, mod (psk,
  qam, fsk, gmsk), channelize and mux;
- scan / scf JSON records equal, floats within 1e-5;
- the crash-resume contract of ``tests/e2e/test_cli.py`` (a run killed
  after a checkpoint continues in place and ends equal to the JAX CLI's
  unbroken file; the checkpoint is deleted);
- the reference's argument errors (`--order`, a missing outfile).
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from srcdsp_tpu.cli import main as jax_cli
from srcdsp_tpu_torch.cli import main as port_cli
from srcdsp_tpu_torch.io.capture import CaptureMeta, write_capture
from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
DECIM, SPS, DEV, CENTER = 4, 8, 0.05, 0.11
FSK_BLOCK = 4096                     # 4 blocks of the 512-bit FSK capture


def _cap(path, x):
    write_capture(str(path), np.asarray(x, np.complex64), CaptureMeta(fmt="cf32"))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The captures every case reads: FSK, AM, DQPSK, a wideband, and the
    reference CLI's own `mod` outputs (PSK, QAM, CPFSK, GMSK) as the
    receivers' inputs."""
    from srcdsp_tpu_torch.chains.analog import am_modulate
    from srcdsp_tpu_torch.chains.dqpsk import dqpsk_baseband

    d = tmp_path_factory.mktemp("cli_in")
    rng = np.random.default_rng(20)
    f = {"dir": d}
    bits = random_bits(rng, (512,))
    f["fsk"] = _cap(d / "fsk.cf32", fsk_baseband(bits, DECIM * SPS, DEV / DECIM)
                    * tone(512 * DECIM * SPS, CENTER))
    f["fsk_bits"] = bits
    audio = np.sin(2 * np.pi * 0.003 * np.arange(1 << 14)).astype(np.float32)
    f["am"] = _cap(d / "am.cf32", am_modulate(audio, 0.5, 0.21, device="cpu").numpy())
    bb = dqpsk_baseband(rng.integers(0, 4, 512), DECIM * SPS)
    f["dqpsk"] = _cap(d / "dqpsk.cf32", bb * tone(bb.size, CENTER))
    n = 1 << 13
    wide = (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            + tone(n, 3 / 8) + 0.5 * tone(n, -2 / 8 + 0.01))
    f["wide"] = _cap(d / "wide.cf32", wide)
    syms = {"psk": rng.integers(0, 4, 1024), "qam": rng.integers(0, 16, 1024),
            "fsk": rng.integers(0, 2, 1024), "gmsk": rng.integers(0, 2, 1024)}
    amps = {1: 1.0, 3: 0.5, 6: 0.25}
    for c in range(8):
        _cap(d / f"mux.ch{c:03d}.cf32", amps.get(c, 0.0) * tone(2048, 0.05 + 0.01 * c))
    for mod, s in syms.items():
        s.astype(np.uint8).tofile(d / f"{mod}.u8")
        f[f"{mod}_syms"] = str(d / f"{mod}.u8")
        f[f"mod_{mod}"] = str(d / f"mod_{mod}.cf32")
    _threads([lambda mod=mod: jax_cli(["mod", f[f"{mod}_syms"], f[f"mod_{mod}"]] + MOD_ARGS(mod))
              for mod in syms])
    return f


def MUX(f):
    return ["mux", str(f["dir"] / "mux"), "{out}", "--channels", "8", "--taps-per-phase", "4",
            "--block", "4096"]


def MOD_ARGS(mod):
    return ["--mod", mod, "--order", "16" if mod == "qam" else "4", "--sps", "8",
            "--center", "0.12", "--dev", "0.0625", "--block", "2048"]


def _threads(jobs) -> list:
    with ThreadPoolExecutor(4) as ex:
        return list(ex.map(lambda job: job(), jobs))


def _out(argv, base):
    return [a.replace("{out}", str(base)) for a in argv]


def _rel_l2(a: bytes, b: bytes) -> float:
    x, y = np.frombuffer(a, np.float32), np.frombuffer(b, np.float32)
    assert x.size == y.size > 0
    return float(np.linalg.norm(x.astype(np.float64) - y) / np.linalg.norm(x.astype(np.float64)))


# name -> (argv maker over the inputs, output suffixes, "bytes" | "rel")
CASES = {
    "fsk": (lambda f: ["fsk", f["fsk"], "{out}", "--center", str(CENTER), "--cutoff", "0.03",
                       "--block", str(FSK_BLOCK)], [""], "bytes"),
    "fsk_tracking": (lambda f: ["fsk", f["fsk"], "{out}", "--center", str(CENTER), "--cutoff",
                                "0.03", "--block", str(FSK_BLOCK), "--tracking"], [""], "bytes"),
    "psk": (lambda f: ["psk", f["mod_psk"], "{out}", "--center", "0.12", "--decim", "2",
                       "--sps", "4", "--block", "2048"], [""], "bytes"),
    "psk_tracking": (lambda f: ["psk", f["mod_psk"], "{out}", "--center", "0.12", "--decim", "2",
                                "--sps", "4", "--block", "2048", "--tracking"], [""], "bytes"),
    "qam": (lambda f: ["qam", f["mod_qam"], "{out}", "--center", "0.12", "--decim", "2",
                       "--sps", "4", "--order", "16", "--block", "4096"], [""], "bytes"),
    "dqpsk": (lambda f: ["dqpsk", f["dqpsk"], "{out}", "--center", str(CENTER),
                         "--block", "8192"], [""], "bytes"),
    "channelize_demod": (lambda f: ["channelize", f["wide"], "{out}", "--channels", "8",
                                    "--taps-per-phase", "4", "--demod", "psk", "--sps", "4",
                                    "--block", "2048"],
                         [f".ch{c:03d}.u8" for c in range(8)], "bytes"),
    "fir": (lambda f: ["fir", f["fsk"], "{out}", "--taps", "32", "--cutoff", "0.2",
                       "--decim", "2", "--block", "4096"], ["", ".json"], "rel"),
    "resample": (lambda f: ["resample", f["fsk"], "{out}", "--up", "3", "--down", "4",
                            "--taps", "96", "--block", "4096"], ["", ".json"], "rel"),
    "fm": (lambda f: ["fm", f["fsk"], "{out}", "--center", str(CENTER), "--decim", "4",
                      "--dev", "0.08", "--audio-decim", "2", "--block", "8192"], [""], "rel"),
    "am": (lambda f: ["am", f["am"], "{out}", "--center", "0.21", "--decim", "4",
                      "--block", "8192"], [""], "rel"),
    "channelize": (lambda f: ["channelize", f["wide"], "{out}", "--channels", "8",
                              "--taps-per-phase", "4", "--block", "2048"],
                   [f".ch{c:03d}.cf32" for c in (0, 3, 6)] + [".ch003.cf32.json"], "rel"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_equal_to_reference_cli(inputs, reference, tmp_path, name):
    argv, outs, kind = CASES[name]
    port_cli(_out(argv(inputs), tmp_path / "port") + ["--device", "cpu"])
    for suffix in outs:
        a = open(reference[name] + suffix, "rb").read()
        b = open(str(tmp_path / "port") + suffix, "rb").read()
        if kind == "bytes" or suffix.endswith(".json"):
            assert a == b, (name, suffix)
        else:
            assert _rel_l2(a, b) <= REL, (name, suffix)


@pytest.mark.parametrize("mod", ["psk", "qam", "fsk", "gmsk"])
def test_mod_equal_to_reference_cli(inputs, tmp_path, mod):
    out = str(tmp_path / "port.cf32")
    port_cli(["mod", inputs[f"{mod}_syms"], out] + MOD_ARGS(mod) + ["--device", "cpu"])
    assert _rel_l2(open(inputs[f"mod_{mod}"], "rb").read(), open(out, "rb").read()) <= REL
    assert open(inputs[f"mod_{mod}"] + ".json").read() == open(out + ".json").read()


@pytest.mark.parametrize("argv", [
    ["--gen", "tone", "--center", "0.11", "--num-samples", "8192", "--snr", "20", "--fmt", "cu8"],
    ["--gen", "chirp", "--f0", "-0.1", "--f1", "0.1", "--num-samples", "4096"],
    ["--gen", "noise", "--num-samples", "4096", "--fmt", "ci16", "--seed", "3"],
    ["--gen", "tone", "--center", "-0.3", "--num-samples", "4096", "--snr", "5", "--fmt", "ci8"],
], ids=["tone_cu8", "chirp_cf32", "noise_ci16", "tone_ci8"])
def test_gen_byte_equal(tmp_path, argv):
    jax_cli(["gen", str(tmp_path / "j.iq")] + argv)
    port_cli(["gen", str(tmp_path / "p.iq")] + argv + ["--device", "cpu"])
    assert open(tmp_path / "j.iq", "rb").read() == open(tmp_path / "p.iq", "rb").read()
    assert open(tmp_path / "j.iq.json").read() == open(tmp_path / "p.iq.json").read()


def test_mux_equal_to_reference_cli(inputs, reference, tmp_path):
    port_cli(_out(MUX(inputs), tmp_path / "p.cf32") + ["--device", "cpu"])
    j = reference["mux"]
    assert _rel_l2(open(j, "rb").read(), open(tmp_path / "p.cf32", "rb").read()) <= REL
    assert open(j + ".json").read() == open(tmp_path / "p.cf32.json").read()


# small codes: the reference decoders run eagerly and compile per shape
FEC = {
    "ldpc": (["--fec-n", "120", "--fec-iters", "4"], 600),
    "polar": (["--fec-n", "32", "--fec-k", "16"], 160),
    "turbo": (["--fec-k", "32", "--fec-iters", "2"], 128),
    "conv": (["--fec-k", "64"], 256),
    "bch": ([], 420),
    "golay": ([], 600),
    "rs": (["--fec-n", "63", "--fec-k", "55"], 110),
}


def _fec_files(d, code):
    """The info file, then the reference's coded file, its noisy copy (hard
    bits with an error every 41, or RS bytes with 3 errors in the first
    word) and, for ldpc, noisy LLRs; the reference decodes both."""
    extra, size = FEC[code]
    rng = np.random.default_rng(7)
    f = {k: str(d / f"{code}.{k}") for k in ("u", "c", "noisy", "llr", "d", "s")}
    rng.integers(0, 256 if code == "rs" else 2, size).astype(np.uint8).tofile(f["u"])
    jax_cli(["fecenc", f["u"], f["c"], "--code", code] + extra)
    c = np.fromfile(f["c"], np.uint8)
    noisy = c.copy()
    if code == "rs":
        noisy[5:8] ^= 0x5A                   # 3 byte errors, t = 4
    else:
        noisy[::41] ^= 1
    noisy.tofile(f["noisy"])
    jax_cli(["fecdec", f["noisy"], f["d"], "--code", code] + ([] if code == "rs" else ["--hard"])
            + extra)
    if code == "ldpc":
        ((2.0 * (1.0 - 2.0 * c.astype(np.float32)) + 0.6 * rng.standard_normal(c.size))
         .astype(np.float32).tofile(f["llr"]))
        jax_cli(["fecdec", f["llr"], f["s"], "--code", code] + extra)
    return f


@pytest.mark.parametrize("code", sorted(FEC))
def test_fec_byte_equal(reference, tmp_path, code):
    """fecenc, then fecdec of the coded file with errors (hard bits; RS
    bytes), and for ldpc (K14's plain version) of noisy LLRs too: each file
    byte-equal between the two CLIs, and the info back."""
    extra, size = FEC[code]
    f = reference[f"fec_{code}"]
    port = lambda a: port_cli(a + ["--code", code] + extra + ["--device", "cpu"])  # noqa: E731
    port(["fecenc", f["u"], str(tmp_path / "c")])
    assert open(tmp_path / "c", "rb").read() == open(f["c"], "rb").read()
    port(["fecdec", f["noisy"], str(tmp_path / "d")] + ([] if code == "rs" else ["--hard"]))
    dec = open(f["d"], "rb").read()
    assert open(tmp_path / "d", "rb").read() == dec
    assert dec[:size] == open(f["u"], "rb").read()
    if code == "ldpc":
        port(["fecdec", f["llr"], str(tmp_path / "s")])
        assert open(tmp_path / "s", "rb").read() == open(f["s"], "rb").read()


def _last_digit(v: float) -> float:
    """One unit in the last printed decimal of a rounded JSON float."""
    text = repr(v)
    return 10.0 ** -len(text.split(".")[1]) if "." in text and "e" not in text else 0.0


def _records_equal(a: str, b: str) -> None:
    ra = [json.loads(line) for line in open(a)]
    rb = [json.loads(line) for line in open(b)]
    assert len(ra) == len(rb) > 0
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], float):
                tol = max(REL * max(1.0, abs(x[k])), 1.01 * _last_digit(x[k]))
                assert abs(x[k] - y[k]) <= tol, (k, x[k], y[k])
            else:
                assert x[k] == y[k], (k, x[k], y[k])


SURVEYS = {"scan_analyze": ["scan", "--analyze"], "scf": ["scf", "--scf-thresh", "0.3"],
           "scf_conj": ["scf", "--conj"]}


@pytest.mark.parametrize("name", sorted(SURVEYS))
def test_survey_records_equal(inputs, reference, tmp_path, name):
    argv = SURVEYS[name]
    port_cli([argv[0], inputs["mod_psk"], str(tmp_path / "p.jsonl")] + argv[1:]
             + ["--device", "cpu"])
    _records_equal(reference[name], str(tmp_path / "p.jsonl"))


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """Every reference CLI run the module compares with, made once, four at
    a time: name -> output path (or, for a code, its files)."""
    d = tmp_path_factory.mktemp("cli_ref")
    out = {name: str(d / name) for name in CASES}
    out.update({name: str(d / f"{name}.jsonl") for name in SURVEYS})
    out["mux"] = str(d / "mux.cf32")
    jobs = [lambda n=name: jax_cli(_out(CASES[n][0](inputs), out[n])) for name in CASES]
    jobs += [lambda n=name: jax_cli([SURVEYS[n][0], inputs["mod_psk"], out[n]] + SURVEYS[n][1:])
             for name in SURVEYS]
    jobs.append(lambda: jax_cli(_out(MUX(inputs), out["mux"])))
    fec = _threads(jobs + [lambda c=code: _fec_files(d, c) for code in sorted(FEC)])[len(jobs):]
    out.update({f"fec_{code}": f for code, f in zip(sorted(FEC), fec)})
    return out


def test_crash_resume_equal_to_reference_unbroken(inputs, reference, tmp_path):
    """A run 'killed' after block 3's checkpoint (the library run for three
    blocks, the checkpoint, torn garbage past it) resumes in place and ends
    equal to the JAX CLI's unbroken file; the checkpoint is deleted."""
    from srcdsp_tpu_torch import checkpoint
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.io.capture import read_capture_blocks

    argv = CASES["fsk"][0](inputs)
    params = make_fsk_params(CENTER, 64, 0.03, DECIM, SPS, DEV, device="cpu")
    st = fsk_init(params)
    out = str(tmp_path / "resumed.u8")
    with open(out, "wb") as f:
        for i, xb in enumerate(read_capture_blocks(inputs["fsk"], FSK_BLOCK)):
            if i == 3:
                break
            st, (b, _) = fsk_apply(params, st, torch.as_tensor(xb))
            f.write(b.numpy().astype(np.uint8).tobytes())
    ck = str(tmp_path / "ck")
    checkpoint.save(ck, st, block_index=3)
    with open(out, "ab") as f:
        f.write(b"\xff" * 17)
    port_cli(_out(argv, out) + ["--ckpt", ck, "--ckpt-every", "3", "--device", "cpu"])
    assert open(out, "rb").read() == open(reference["fsk"], "rb").read()
    assert not checkpoint.exists(ck)


def test_order_and_outfile_errors(tmp_path):
    cap = _cap(tmp_path / "x.cf32", np.zeros(1024, np.complex64))
    for order in ("300", "6"):
        with pytest.raises(SystemExit):
            port_cli(["psk", cap, str(tmp_path / "o.u8"), "--order", order, "--device", "cpu"])
    with pytest.raises(SystemExit):
        port_cli(["fsk", cap, "--device", "cpu"])
    with pytest.raises(SystemExit):
        port_cli(["css", cap, str(tmp_path / "o.jsonl"), "--css-len", "0", "--device", "cpu"])


def test_thirty_chains_and_the_reference_flags():
    """Every chain and every option of the reference parser, `--platform`
    replaced by `--device`."""
    import argparse

    import srcdsp_tpu.cli as jcli
    import srcdsp_tpu_torch.cli as tcli

    def options(mod):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            seen.update({a.dest: (a.default, tuple(a.choices or ())) for a in self._actions})
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                mod.main(["fsk", "x"])
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen

    j, t = options(jcli), options(tcli)
    assert len(j["chain"][1]) == 30 and j["chain"] == t["chain"]
    assert {k: v for k, v in j.items() if k != "platform"} == {
        k: v for k, v in t.items() if k != "device"}
    assert t["device"] == (None, ())


# --- the seven names -----------------------------------------------------------------------

def test_configs_registry():
    from srcdsp_tpu import configs as jcfg
    from srcdsp_tpu_torch import configs as tcfg

    assert list(tcfg.CONFIGS) == list(jcfg.CONFIGS)
    for name, spec in tcfg.CONFIGS.items():
        assert isinstance(spec, tcfg.ConfigSpec)
        assert (spec.name, spec.description) == (jcfg.CONFIGS[name].name,
                                                 jcfg.CONFIGS[name].description)
        assert spec.build is getattr(tcfg, f"build_{name}")
    built = tcfg.CONFIGS["config1"].build(1 << 12, device="cpu")
    built.step(*built.example)
    assert built.samples_per_call == 1 << 12 and built.meta["decim"] == 2


def test_np_tone_byte_equal():
    from srcdsp_tpu.testing.signals import np_tone as jtone
    from srcdsp_tpu_torch.testing.signals import np_tone

    for args in ((4097, 0.11), (1000, -0.3, 0.25, 0.5), (64, 0.5)):
        assert np_tone(*args).tobytes() == jtone(*args).tobytes()


def test_planes_to_int16_bit_for_bit():
    """Saturating round-half-even at the edges, against the reference and
    the port's own complex64_to_int16."""
    import jax.numpy as jnp

    from srcdsp_tpu.ops.planes import planes_to_int16 as jp2i
    from srcdsp_tpu_torch.ops.planes import planes_to_int16
    from srcdsp_tpu_torch.types import complex64_to_int16

    s = np.float32(32767.0)
    edge = np.array([32767.5, -32767.5, 32768.0, -32768.0, 32769.0, -32769.0, 1e6, -1e6,
                     0.5, 1.5, 2.5, -0.5, -1.5, 32766.5, -32768.5, 0.0], np.float32) / s
    rng = np.random.default_rng(1)
    xr = np.concatenate([edge, rng.uniform(-1.2, 1.2, 4096).astype(np.float32)])
    xi = np.concatenate([edge[::-1], rng.uniform(-1.2, 1.2, 4096).astype(np.float32)])
    got = planes_to_int16(torch.as_tensor(xr), torch.as_tensor(xi)).numpy()
    ref = np.asarray(jp2i(jnp.asarray(xr), jnp.asarray(xi)))
    assert got.dtype == np.int16 and np.array_equal(got, ref)
    own = complex64_to_int16(torch.complex(torch.as_tensor(xr), torch.as_tensor(xi))).numpy()
    assert np.array_equal(got, own)
    two = planes_to_int16(torch.as_tensor(np.stack([xr, xi])), torch.as_tensor(np.stack([xi, xr])))
    assert tuple(two.shape) == (2, 2 * xr.size) and np.array_equal(two[0].numpy(), got)


def test_np_fir_full_gaussian_pulse_and_np_discriminate_equal():
    from srcdsp_tpu.ops.fir import np_fir_full as jfull
    from srcdsp_tpu.ops.window import gaussian_freq_pulse as jpulse
    from srcdsp_tpu_torch.chains import tx
    from srcdsp_tpu_torch.ops.fir import np_fir_full
    from srcdsp_tpu_torch.ops.window import gaussian_freq_pulse

    rng = np.random.default_rng(2)
    taps = rng.standard_normal(17)
    x = (rng.standard_normal((2, 300)) + 1j * rng.standard_normal((2, 300))).astype(np.complex64)
    for decim in (1, 3):
        assert np_fir_full(taps, x, decim).tobytes() == jfull(taps, x, decim).tobytes()
    assert tx.gaussian_freq_pulse is gaussian_freq_pulse
    from srcdsp_tpu.chains.fsk import np_discriminate as jdisc
    from srcdsp_tpu_torch.chains.fsk import np_discriminate
    assert np_discriminate(x).tobytes() == jdisc(x).tobytes()
    for args in ((8, 0.3), (4, 0.5, 4), (16, 0.25, 3, 1.0)):
        assert np.array_equal(gaussian_freq_pulse(*args), jpulse(*args))


def test_halfband_cascade_equal():
    import jax
    import jax.numpy as jnp

    from srcdsp_tpu.ops import halfband as jhb
    from srcdsp_tpu_torch.ops import halfband as thb

    assert "HalfbandCascade" in thb.__all__
    stages = thb.HalfbandCascade(taps=(thb.design_halfband(11), thb.design_halfband(19)))
    assert stages._fields == jhb.HalfbandCascade._fields
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(np.complex64)
    _, y = thb.cascade_apply(stages.taps, thb.cascade_init(stages.taps, device="cpu"),
                             torch.as_tensor(x))
    jstages = jhb.HalfbandCascade(taps=tuple(jhb.design_halfband(t) for t in (11, 19)))
    ref = np.asarray(jax.jit(lambda v: jhb.cascade_apply(
        jstages.taps, jhb.cascade_init(jstages.taps), v)[1])(jnp.asarray(x)))
    assert np.linalg.norm(y.numpy() - ref) / np.linalg.norm(ref) <= REL
