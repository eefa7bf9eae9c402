"""Port vs JAX package: the distribution tier (``srcdsp_tpu_torch.dist``).

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py, as
tests/dist runs it (Pallas kernels at interpret=True, out_tile 128, b_rows 2,
4-way meshes for the interpret-mode kernels). The port side runs on a mesh of
repeated CPU devices, ``make_mesh(time=P, devices=["cpu"] * P)``. Inputs are
numpy arrays from a seed.

Contracts:

- halo shifts: exact against JAX;
- the sharded FIR and channelizers: rel L2 < 1e-5 against JAX (the port's
  ``ops.fir`` contract, float32 sums in another order), and ``torch.equal``
  to the port's own unsharded run (the reference's bit-exact block joins);
- K1 and K11 on time shards: their port-vs-JAX tolerances (rel L2 < 1e-5 and
  < 1e-4), and ``torch.equal`` to one port kernel call over the unsharded
  stream; carried tails exact;
- ``build_config5(mesh=...)``: indices equal to the port's single-device
  build and soft within 2e-5 (the reference's pipeline gate); against the
  JAX mesh form, the config-5 port-vs-JAX contract (soft rel L2 < 1e-4,
  indices agreeing on 99.9 % of noise symbols);
- bodies with no collective through ``map_shards`` (channel-sharded FSK,
  codeword-sharded LDPC, block-sharded turbo): equal to the unsharded call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from srcdsp_tpu import configs as jconfigs
from srcdsp_tpu import dist as jdist
from srcdsp_tpu.dist import channelize as jdc
from srcdsp_tpu.dist import fused as jdf
from srcdsp_tpu.dist import halo as jdh
from srcdsp_tpu.kernels import mixfir as jmf
from srcdsp_tpu.kernels.fftconv_pallas import make_fftconv_kernel as jmake_fftconv
from srcdsp_tpu_torch import configs
from srcdsp_tpu_torch.chains import channelizer as tch
from srcdsp_tpu_torch.dist import channelize as tdc
from srcdsp_tpu_torch.dist import fused as tdf
from srcdsp_tpu_torch.dist import halo as tdh
from srcdsp_tpu_torch.dist import mesh as tdm
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import fftconv_pallas as tfc
from srcdsp_tpu_torch.kernels import mixfir as tmf
from srcdsp_tpu_torch.ops.fir import fir_full
from srcdsp_tpu_torch.ops.nco import freq_to_word
from srcdsp_tpu_torch.ops.window import lowpass
from tests.torch_threads import one_torch_thread  # noqa: F401

TIME = P(None, "time")


def _mesh(p: int, channel: int = 1):
    return tdm.make_mesh(time=p, channel=channel, devices=["cpu"] * (p * channel))


def _column(mesh, q: int):
    """The time axis at channel index q, as a mesh of its own."""
    return tdm.Mesh(tuple((row[q],) for row in mesh.devices))


def _cnoise(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _jshard(x, mesh, spec=TIME):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


# --- the mesh ------------------------------------------------------------------

def test_make_mesh_shape_and_axes():
    mesh = _mesh(4, 2)
    assert mesh.shape == {"time": 4, "channel": 2}
    assert mesh.axis_names == ("time", "channel")
    assert mesh.axis_devices("time") == (torch.device("cpu"),) * 4
    assert mesh.axis_devices("channel") == (torch.device("cpu"),) * 2
    assert _column(mesh, 1).shape == {"time": 4, "channel": 1}
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        tdm.make_mesh(time=4, channel=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="axis"):
        mesh.axis_devices("space")


def test_per_device_builds_once_for_each_distinct_device():
    made = []

    def make(d):
        made.append(d)
        return object()

    devs = (torch.device("cpu"), torch.device("meta"), torch.device("cpu"))
    got = tdm.per_device(make, devs)
    assert made == [torch.device("cpu"), torch.device("meta")]
    assert got[0] is got[2] and got[1] is not got[0]
    assert len(set(map(id, tdm.per_device(make, _mesh(4).axis_devices())))) == 1


def test_shard_unshard_round_trip_and_own_buffers():
    mesh = _mesh(4)
    x = torch.arange(2 * 64, dtype=torch.float32).reshape(2, 64)
    shards = tdm.shard(x, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 16)] * 4
    assert all(s.is_contiguous() and s.data_ptr() != x.data_ptr() for s in shards)
    assert torch.equal(tdm.unshard(shards, "cpu"), x)
    rows = tdm.shard(x.T.contiguous(), mesh, dim=0)
    assert torch.equal(tdm.unshard(rows, "cpu", dim=0), x.T)
    with pytest.raises(ValueError, match="does not split"):
        tdm.shard(x[:, :63], mesh)
    with pytest.raises(ValueError, match="3 shards for 4 devices"):
        tdm.map_shards(lambda a: a, mesh, shards[:3])


# --- halo shifts and the sharded FIR ----------------------------------------------

@pytest.mark.parametrize("halo", [1, 64, 512])
def test_shift_and_halo_from_left_match_jax(halo):
    x = np.random.default_rng(halo).standard_normal((2, 8 * 512)).astype(np.float32)
    jmesh = jdist.make_mesh(time=8)
    shards = tdm.shard(torch.as_tensor(x), _mesh(8))
    jshift = jax.shard_map(functools.partial(jdh.shift_from_left, axis_name="time"),
                           mesh=jmesh, in_specs=TIME, out_specs=TIME)
    jhalo = jax.shard_map(functools.partial(jdh.halo_from_left, halo=halo, axis_name="time"),
                          mesh=jmesh, in_specs=TIME, out_specs=TIME)
    np.testing.assert_array_equal(tdm.unshard(tdh.shift_from_left(shards), "cpu").numpy(),
                                  np.asarray(jshift(_jshard(x, jmesh))))
    got = tdh.halo_from_left(shards, halo)
    assert [tuple(g.shape) for g in got] == [(2, halo)] * 8
    np.testing.assert_array_equal(tdm.unshard(got, "cpu").numpy(),
                                  np.asarray(jhalo(_jshard(x, jmesh))))


@pytest.mark.parametrize("p,taps,n,decim", [(8, 64, 8 * 1024, 1), (4, 32, 4 * 512, 4)])
def test_fir_time_sharded_matches_jax_and_unsharded(p, taps, n, decim):
    h = lowpass(taps, 0.1)
    x = _cnoise(taps, (n,))
    mesh = _mesh(p)
    got = tdm.unshard(tdh.fir_time_sharded(h, tdm.shard(torch.as_tensor(x), mesh), mesh, decim),
                      "cpu")
    jmesh = jdist.make_mesh(time=p)
    ref = jdist.fir_time_sharded(jnp.asarray(h), _jshard(x, jmesh, P("time")), jmesh, decim)
    assert _rel(got.numpy(), ref) < 1e-5
    assert torch.equal(got, fir_full(h, torch.as_tensor(x), decim))


def test_fir_time_sharded_on_a_time_by_channel_mesh():
    """2 channel shards x 4 time shards: each channel column filters its
    channel block over the time axis (the reference's shard body)."""
    h = lowpass(16, 0.2)
    x = _cnoise(2, (2, 4 * 256))
    mesh = _mesh(4, 2)
    cols = []
    for q, xq in enumerate(torch.as_tensor(x).chunk(2, dim=0)):
        col = _column(mesh, q)
        cols.append(tdm.unshard(tdh.fir_time_sharded(h, tdm.shard(xq, col), col), "cpu"))
    got = torch.cat(cols, dim=0)
    jmesh = jdist.make_mesh(time=4, channel=2)
    spec = P("channel", "time")
    f = jax.shard_map(functools.partial(jdh._fir_shard, jnp.asarray(h), decim=1,
                                        axis_name="time"),
                      mesh=jmesh, in_specs=(spec,), out_specs=spec)
    assert _rel(got.numpy(), f(_jshard(x, jmesh, spec))) < 1e-5
    assert torch.equal(got, fir_full(h, torch.as_tensor(x)))


def test_fir_time_sharded_stream_over_four_buffers():
    h = lowpass(48, 0.12)
    x = _cnoise(9, (4 * 8 * 256,))
    mesh, jmesh = _mesh(8), jdist.make_mesh(time=8)
    n = x.shape[-1] // 4
    tail, jtail = torch.zeros(47, dtype=torch.complex64), jnp.zeros(47, jnp.complex64)
    outs, jouts = [], []
    for b in range(4):
        xb = x[b * n:(b + 1) * n]
        tail, ys = tdh.fir_time_sharded_stream(h, tail, tdm.shard(torch.as_tensor(xb), mesh),
                                               mesh)
        outs.append(tdm.unshard(ys, "cpu"))
        jtail, jy = jdh.fir_time_sharded_stream(jnp.asarray(h), jtail,
                                                _jshard(xb, jmesh, P("time")), jmesh)
        jouts.append(np.asarray(jy))
    got = torch.cat(outs)
    assert _rel(got.numpy(), np.concatenate(jouts)) < 1e-5
    assert torch.equal(got, fir_full(h, torch.as_tensor(x)))
    np.testing.assert_array_equal(tail.numpy(), x[-47:])


# --- the distributed channelizer ---------------------------------------------------

def test_channelize_time_sharded_matches_jax_and_full():
    m, p = 16, 8
    h = tch.design_prototype(m, taps_per_phase=4)
    x = _cnoise(3, (p * m * 32,))
    mesh, jmesh = _mesh(p), jdist.make_mesh(time=p)
    ys = tdc.channelize_time_sharded(h, tdm.shard(torch.as_tensor(x), mesh), m, mesh)
    assert [tuple(y.shape) for y in ys] == [(m // p, p * 32)] * p
    got = tdm.unshard(ys, "cpu", dim=0)
    ref = jdist.channelize_time_sharded(h, _jshard(x, jmesh, P("time")), m, jmesh)
    assert _rel(got.numpy(), ref) < 1e-5
    assert torch.equal(got, tch.channelize_full(h, torch.as_tensor(x), m))


def test_fir_then_channelize_stream_pipeline():
    """The reference's streaming pipeline (tests/dist/test_halo.py:133):
    the sharded FIR stream then the sharded channelizer stream, 2 buffers
    with carried tails, against JAX and the one-shot single-device run."""
    m, p = 16, 8
    pre = lowpass(48, 0.45)
    proto = tch.design_prototype(m, taps_per_phase=4)
    tproto = tch.pad_prototype(proto, m).shape[0]
    x = _cnoise(21, (2 * p * m * 16,))
    mesh, jmesh = _mesh(p), jdist.make_mesh(time=p)
    tail_f, tail_c = torch.zeros(47, dtype=torch.complex64), torch.zeros(tproto - 1,
                                                                          dtype=torch.complex64)
    jtail_f, jtail_c = jnp.zeros(47, jnp.complex64), jnp.zeros(tproto - 1, jnp.complex64)
    outs, jouts = [], []
    n = x.shape[-1] // 2
    for b in range(2):
        xb = x[b * n:(b + 1) * n]
        tail_f, ys = tdh.fir_time_sharded_stream(pre, tail_f,
                                                 tdm.shard(torch.as_tensor(xb), mesh), mesh)
        tail_c, banks = tdc.channelize_time_sharded_stream(proto, tail_c, ys, m, mesh)
        outs.append(tdm.unshard(banks, "cpu", dim=0))
        jtail_f, jy = jdh.fir_time_sharded_stream(jnp.asarray(pre), jtail_f,
                                                  _jshard(xb, jmesh, P("time")), jmesh)
        jtail_c, jb = jdc.channelize_time_sharded_stream(proto, jtail_c, jy, m, jmesh)
        jouts.append(np.asarray(jb))
    got = torch.cat(outs, dim=-1)
    assert _rel(got.numpy(), np.concatenate(jouts, axis=-1)) < 1e-5
    ref = tch.channelize_full(proto, fir_full(pre, torch.as_tensor(x)), m)
    assert torch.equal(got, ref)


def test_channelize_os2_time_sharded_matches_jax_and_full():
    m, p = 16, 8
    h = tch.design_prototype(m, taps_per_phase=4)
    x = _cnoise(12, (p * m * 16,))
    mesh, jmesh = _mesh(p), jdist.make_mesh(time=p)
    got = tdm.unshard(tdc.channelize_os2_time_sharded(h, tdm.shard(torch.as_tensor(x), mesh),
                                                      m, mesh), "cpu", dim=0)
    ref = jdc.channelize_os2_time_sharded(h, _jshard(x, jmesh, P("time")), m, jmesh)
    assert _rel(got.numpy(), ref) < 1e-5
    assert torch.equal(got, tch.channelize_os2_full(h, torch.as_tensor(x), m))


def test_channelize_sharded_raises_like_the_reference():
    h = tch.design_prototype(16, taps_per_phase=4)
    mesh = _mesh(3)
    x = torch.as_tensor(_cnoise(0, (3 * 16 * 4,)))
    with pytest.raises(ValueError, match="not divisible by time-axis size 3"):
        tdc.channelize_time_sharded(h, tdm.shard(x, mesh), 16, mesh)
    with pytest.raises(ValueError, match="not divisible by time-axis size 3"):
        tdc.channelize_os2_time_sharded(h, tdm.shard(x, mesh), 16, mesh)
    mesh4 = _mesh(4)
    odd = tdm.shard(torch.as_tensor(_cnoise(1, (4 * 24,))), mesh4)   # 24 = 1.5 M per shard
    with pytest.raises(ValueError, match="multiple of num_channels 16"):
        tdc.channelize_os2_time_sharded(h, odd, 16, mesh4)


# --- K1 and K11 on time shards ---------------------------------------------------------

def test_mix_fir_time_sharded_two_buffers_matches_jax_and_k1():
    taps, decim, p = lowpass(32, 0.2), 2, 4
    tk = tmf.make_mix_fir_kernel(taps, decim, out_tile=128, b_rows=2, device="cpu")
    jk = jmf.make_mix_fir_kernel(taps, decim, out_tile=128, b_rows=2, interpret=True)
    word = int(freq_to_word(0.31))
    n = p * tk.block_in()
    x = np.random.default_rng(1).standard_normal((2, 2 * n)).astype(np.float32)
    mesh, jmesh = _mesh(p), jdist.make_mesh(time=p)
    tail, jtail = torch.zeros(2, tk.hist), jnp.zeros((2, jk.hist), jnp.float32)
    outs, jouts = [], []
    for b in range(2):
        xb = x[:, b * n:(b + 1) * n]
        w0 = (b * n * word) % (1 << 32)
        tail, ys = tdf.mix_fir_time_sharded(tk, w0, word, tail,
                                            tdm.shard(torch.as_tensor(xb), mesh), mesh)
        outs.append(tdm.unshard(ys, "cpu"))
        jtail, jy = jdf.mix_fir_time_sharded(jk, w0, word, jtail, _jshard(xb, jmesh), jmesh)
        jouts.append(np.asarray(jy))
    got = torch.cat(outs, dim=-1)
    assert _rel(got.numpy(), np.concatenate(jouts, axis=-1)) < 1e-5
    xpad = torch.cat([torch.zeros(2, tk.hist), torch.as_tensor(x)], dim=-1)
    rr, ri = tk.fn((-tk.hist * word) % (1 << 32), word, xpad)
    assert torch.equal(got[0], rr.reshape(-1)) and torch.equal(got[1], ri.reshape(-1))
    np.testing.assert_array_equal(tail.numpy(), x[:, -tk.hist:])
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


def test_shard_word_wraps_like_the_reference():
    """word0 + (p*S - hist)*dword mod 2^32 for shards far past 2^32 samples
    of phase, and a negative offset on shard 0."""
    dword, hist = int(freq_to_word(0.4)), 128
    for p, s in ((0, 1 << 20), (3, 1 << 26), (1023, 1 << 30)):
        want = np.uint32((7 + (p * s - hist) * dword) % (1 << 32))
        assert tdf.shard_word(7, dword, p, s, hist) == int(want)
    with pytest.raises(ValueError, match="unequal"):
        tdf.shard_length([torch.zeros(2, 4), torch.zeros(2, 8)])
    with pytest.raises(ValueError, match="3 kernels for 4 shards"):
        tdf.per_shard([None] * 3, 4)


def test_fftconv_time_sharded_two_buffers_matches_jax_and_k11():
    taps, cch, p = lowpass(200, 0.1), 2, 4
    tk = tfc.make_fftconv_kernel(taps, 2048, num_channels=cch, b_frames=2, device="cpu")
    jk = jmake_fftconv(taps, 2048, num_channels=cch, b_frames=2, interpret=True)
    n = p * tk.block_in()
    x = np.random.default_rng(2).standard_normal((cch, 2, 2 * n)).astype(np.float32)
    mesh, jmesh = _mesh(p), jdist.make_mesh(time=p)
    spec = P(None, None, "time")
    tail = torch.zeros((cch, 2, tk.overlap))
    jtail = jnp.zeros((cch, 2, jk.overlap), jnp.float32)
    rs, is_, jrs, jis = [], [], [], []
    for b in range(2):
        xb = x[..., b * n:(b + 1) * n]
        tail, yr, yi = tdf.fftconv_time_sharded(tk, tail, tdm.shard(torch.as_tensor(xb), mesh),
                                                mesh)
        rs.append(tdm.unshard(yr, "cpu"))
        is_.append(tdm.unshard(yi, "cpu"))
        jtail, jr, ji = jdf.fftconv_time_sharded(jk, jtail, _jshard(xb, jmesh, spec), jmesh)
        jrs.append(np.asarray(jr))
        jis.append(np.asarray(ji))
    got = torch.complex(torch.cat(rs, dim=-1), torch.cat(is_, dim=-1))
    ref = np.concatenate(jrs, axis=-1) + 1j * np.concatenate(jis, axis=-1)
    assert _rel(got.numpy(), ref) < 1e-4
    xpad = torch.cat([torch.zeros((cch, 2, tk.overlap)), torch.as_tensor(x)], dim=-1)
    one = tfc.fftconv_pallas(tk, xpad)
    assert torch.equal(got.real, one[0]) and torch.equal(got.imag, one[1])
    np.testing.assert_array_equal(tail.numpy(), x[..., -tk.overlap:])


# --- config 5's mesh form ------------------------------------------------------------

def test_build_config5_mesh_matches_single_device_and_jax():
    mesh = _mesh(4)
    b = configs.build_config5(frames=512, num_channels=8, mesh=mesh)
    assert b.meta["distributed"] and len(b.example[0]) == 4
    idx, soft = b.step(*b.example)
    one = configs.build_config5(frames=512, num_channels=8, device="cpu")
    idx1, soft1 = one.step(*one.example)
    assert torch.equal(idx, idx1)
    assert float((soft - soft1).abs().max()) <= 2e-5
    jb = jconfigs.build_config5(frames=512, num_channels=8, mesh=jdist.make_mesh(time=4))
    jidx, jsoft = (np.asarray(a) for a in jb.step(*jb.example))
    assert tuple(idx.shape) == jidx.shape == (8, 128)
    assert _rel(soft.numpy(), jsoft) < 1e-4
    assert np.mean(idx.numpy() == jidx) >= 0.999


# --- bodies with no collective ---------------------------------------------------------

def test_channel_sharded_fsk_demod_equals_unsharded():
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone

    nch, nsym, decim, sps, dev = 8, 64, 4, 8, 0.05
    bits = random_bits(np.random.default_rng(4), (nch, nsym))
    x = torch.as_tensor(fsk_baseband(bits, decim * sps, dev / decim)
                        * tone(nsym * decim * sps, 0.11))
    params = make_fsk_params(0.11, 64, 0.03, decim, sps, dev, device="cpu")
    mesh = tdm.make_mesh(channel=8, devices=["cpu"] * 8)
    outs = tdm.map_shards(lambda xs: fsk_apply(params, fsk_init(params, (xs.shape[0],)), xs)[1],
                          mesh, tdm.shard(x, mesh, "channel", dim=0), axis="channel")
    rx, soft = fsk_apply(params, fsk_init(params, (nch,)), x)[1]
    assert torch.equal(torch.cat([o[0] for o in outs]), rx)
    assert torch.equal(torch.cat([o[1] for o in outs]), soft)
    assert tuple(rx.shape) == (nch, nsym)


def test_codeword_sharded_ldpc_decode_equals_unsharded():
    from srcdsp_tpu_torch.kernels.ldpc_pallas import ldpc_decode_pallas, plan_edges
    from srcdsp_tpu_torch.ldpc import ldpc_encode, make_ldpc_code, make_regular_ldpc

    h = make_regular_ldpc(204, 3, 6, seed=0)
    code, plan = make_ldpc_code(h, device="cpu"), plan_edges(h)
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.integers(0, 2, (8, code.k)))
    y = 1.0 - 2.0 * ldpc_encode(code, u).numpy() + 0.5 * rng.standard_normal((8, code.n))
    llr = torch.as_tensor(8.0 * y, dtype=torch.float32)
    mesh = _mesh(8)
    outs = tdm.map_shards(lambda l: ldpc_decode_pallas(code, plan, l, iters=25), mesh,
                          tdm.shard(llr, mesh, dim=0))
    bits, info, ok = ldpc_decode_pallas(code, plan, llr, iters=25)
    for j, ref in enumerate((bits, info, ok)):
        assert torch.equal(torch.cat([o[j] for o in outs]), ref)
    assert bool(ok.all()) and torch.equal(info, u.to(info.dtype))


def test_block_sharded_turbo_decode_equals_unsharded():
    from srcdsp_tpu_torch.kernels.bcjr_pallas import turbo_decode_pallas
    from srcdsp_tpu_torch.turbo import make_turbo, turbo_encode

    tc = make_turbo(96, seed=0)
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2, (8, 96))
    sigma = 0.6
    llrs = [torch.as_tensor((2 / sigma ** 2 * ((1.0 - 2.0 * s.numpy())
                                                + sigma * rng.standard_normal(s.shape))
                             ).astype(np.float32)) for s in turbo_encode(tc, u)]
    mesh = _mesh(4)
    outs = tdm.map_shards(lambda a, b, c: turbo_decode_pallas(tc, a, b, c, iters=4, b_tile=2),
                          mesh, *(tdm.shard(v, mesh, dim=0) for v in llrs))
    bits, post = turbo_decode_pallas(tc, *llrs, iters=4, b_tile=8)
    assert torch.equal(torch.cat([o[0] for o in outs]), bits)
    assert torch.equal(torch.cat([o[1] for o in outs]), post)


def test_cpu_shards_launch_nothing():
    mesh = _mesh(4)
    before = dict(_build.LAUNCHES)
    tdh.fir_time_sharded(lowpass(16, 0.2), tdm.shard(torch.as_tensor(_cnoise(0, (1024,))),
                                                     mesh), mesh)
    assert _build.LAUNCHES == before
