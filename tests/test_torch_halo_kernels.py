"""Port vs JAX package: the halo kernels K19 (``kernels.halo_dma``) and K20
(``kernels.halo_fused``), through their plain versions on CPU shards.

The JAX kernels run in Pallas interpret mode on the virtual CPU devices of
tests/conftest.py, as tests/dist runs them (remote DMAs simulated by the
interpreter): K19 at 8 shards, K20 at 4 shards with out_tile 128, b_rows 2.
The port runs on ``make_mesh(time=P, devices=["cpu"] * P)``.

Contracts: K19 exact (a copy). K20 within K1's port-vs-JAX tolerance (rel L2
< 1e-5, float32 sums in another order), ``torch.equal`` to the port's K1
over the unsharded stream and to ``dist.fused.mix_fir_time_sharded``; the
carried tail exact. K19's launch plan (`halo_plan`: one group, so one
launch, per device; each entry's left neighbour, column offset and row
stride; the per-launch cap) is checked on torch.device objects, no card
needed. The card's forms are in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from srcdsp_tpu import dist as jdist
from srcdsp_tpu.kernels.halo_dma import halo_from_left_pallas as j_halo
from srcdsp_tpu.kernels.halo_fused import make_halo_fused_kernel as j_make_k20
from srcdsp_tpu.kernels.halo_fused import mix_fir_halo_sharded as j_k20_sharded
from srcdsp_tpu_torch.dist import fused as tdf
from srcdsp_tpu_torch.dist import halo as tdh
from srcdsp_tpu_torch.dist import mesh as tdm
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import halo_dma as k19
from srcdsp_tpu_torch.kernels import halo_fused as k20
from srcdsp_tpu_torch.kernels.mixfir import make_mix_fir_kernel
from srcdsp_tpu_torch.ops.nco import freq_to_word
from srcdsp_tpu_torch.ops.window import lowpass
from tests.torch_threads import one_torch_thread  # noqa: F401

TIME = P(None, "time")


def _mesh(p: int):
    return tdm.make_mesh(time=p, devices=["cpu"] * p)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# --- K19 ----------------------------------------------------------------------

@pytest.mark.parametrize("rows,halo", [(2, 64), (32, 128)])
def test_k19_plain_matches_jax_interpret(rows, halo):
    per = 512
    x = np.random.default_rng(rows).standard_normal((rows, 8 * per)).astype(np.float32)
    jmesh = jdist.make_mesh(time=8)
    ref = np.asarray(j_halo(jax.device_put(jnp.asarray(x), NamedSharding(jmesh, TIME)), halo,
                            jmesh, interpret=True))
    before = dict(_build.LAUNCHES)
    got = k19.halo_from_left_pallas(tdm.shard(torch.as_tensor(x), _mesh(8)), halo)
    assert _build.LAUNCHES == before
    assert [tuple(g.shape) for g in got] == [(rows, halo)] * 8
    np.testing.assert_array_equal(tdm.unshard(got, "cpu").numpy(), ref)
    np.testing.assert_array_equal(got[0].numpy(), np.zeros((rows, halo), np.float32))
    for p in range(1, 8):
        np.testing.assert_array_equal(got[p].numpy(), x[:, p * per - halo:p * per])


def test_k19_takes_slices_of_a_wider_array():
    """Shards that are column slices of one [R, S] array (row stride S) serve
    as they are, as config 3's planes do."""
    x = torch.arange(4 * 32 * 3, dtype=torch.float32).reshape(4 * 3, 32)
    shards = tuple(x[:, i * 8:(i + 1) * 8] for i in range(4))
    got = k19.halo_from_left_pallas(shards, 3)
    for p in range(1, 4):
        assert torch.equal(got[p], x[:, p * 8 - 3:p * 8])
    assert torch.equal(torch.cat(got, dim=-1),
                       torch.cat(tdh.halo_from_left(shards, 3), dim=-1))


def test_k19_refuses_bad_shards():
    good = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="float32"):
        k19.halo_from_left_pallas((good, good.double()), 4)
    with pytest.raises(ValueError, match="float32"):
        k19.halo_from_left_pallas((good, torch.zeros(2, 16, 2)[..., 0]), 4)
    with pytest.raises(ValueError, match="halo 17"):
        k19.halo_from_left_pallas((good, good), 17)
    with pytest.raises(ValueError, match="unequal rows"):
        k19.halo_from_left_pallas((good, torch.zeros(3, 16)), 4)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        k19.halo_from_left_pallas((good, good.to("meta")), 4)


# --- K19's launch plan: one group (one launch) per device --------------------

CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)


def test_k19_plan_one_card_is_one_group():
    plan = k19.halo_plan((CUDA0,) * 4, ((2, 4096),) * 4, (4096,) * 4, 128)
    assert len(plan) == 1
    g = plan[0]
    assert (g.device, g.shards, g.lefts, g.producers) == (CUDA0, (0, 1, 2, 3), (None, 0, 1, 2),
                                                         ())
    assert g.offsets == (0,) + ((4096 - 128) * 4,) * 3
    assert g.strides == (0, 4096, 4096, 4096)


def test_k19_plan_alternating_cards_reads_the_left_neighbours():
    devs = (CUDA0, CUDA1) * 3
    plan = k19.halo_plan(devs, ((2, 512),) * 6, (512,) * 6, 64)
    assert [g.device for g in plan] == [CUDA0, CUDA1]
    g0, g1 = plan
    assert (g0.shards, g0.lefts, g0.producers) == ((0, 2, 4), (None, 1, 3), (CUDA1,))
    assert (g1.shards, g1.lefts, g1.producers) == ((1, 3, 5), (0, 2, 4), (CUDA0,))
    for g in plan:
        for p, q in zip(g.shards, g.lefts):
            assert devs[p] == g.device and q == (p - 1 if p else None)


def test_k19_plan_keeps_the_row_stride_of_a_column_slice():
    """Four column slices [32, 1000] of one [32, 4000] array: each left reads
    from column 1000 - halo of its slice with row stride 4000."""
    plan = k19.halo_plan((CUDA0,) * 4, ((32, 1000),) * 4, (4000,) * 4, 100)
    (g,) = plan
    assert g.strides == (0, 4000, 4000, 4000)
    assert g.offsets == (0, 900 * 4, 900 * 4, 900 * 4)


def test_k19_plan_refuses_more_entries_than_one_launch_takes():
    n = k19.HALO_MAX_ENTRIES
    assert len(k19.halo_plan((CUDA0,) * n, ((2, 8),) * n, (8,) * n, 4)[0].shards) == n
    with pytest.raises(ValueError, match=f"at most {n}"):
        k19.halo_plan((CUDA0,) * (n + 1), ((2, 8),) * (n + 1), (8,) * (n + 1), 4)
    assert len(k19.halo_plan((CUDA0, CUDA1) * n, ((2, 8),) * 2 * n, (8,) * 2 * n, 4)) == 2


# --- K20 ----------------------------------------------------------------------

def _k20_pair(taps, decim):
    kf = k20.make_halo_fused_kernel(taps, decim, out_tile=128, b_rows=2, device="cpu")
    jkf = j_make_k20(taps, decim, out_tile=128, b_rows=2, interpret=True)
    assert kf.hist == jkf.hist
    return kf, jkf


def test_k20_one_buffer_matches_jax_interpret_and_k1():
    taps, decim, p = lowpass(64, 0.2), 2, 4
    kf, jkf = _k20_pair(taps, decim)
    k1 = make_mix_fir_kernel(taps, decim, out_tile=128, b_rows=2, device="cpu")
    word = int(freq_to_word(0.123))
    n = p * 2 * 2 * 128 * decim                  # 2 blocks of b_rows*OT*decim per shard
    x = np.random.default_rng(0).standard_normal((2, n)).astype(np.float32)
    jmesh = jdist.make_mesh(time=p)
    jtail, jy = j_k20_sharded(jkf, 0, word, jnp.zeros((2, jkf.hist), jnp.float32),
                              jax.device_put(jnp.asarray(x), NamedSharding(jmesh, TIME)), jmesh)
    mesh = _mesh(p)
    before = dict(_build.LAUNCHES)
    tail, ys = k20.mix_fir_halo_sharded(kf, 0, word, torch.zeros(2, kf.hist),
                                        tdm.shard(torch.as_tensor(x), mesh), mesh)
    assert _build.LAUNCHES == before
    got = tdm.unshard(ys, "cpu")
    assert _rel(got.numpy(), np.asarray(jy)) < 1e-5
    xpad = torch.cat([torch.zeros(2, k1.hist), torch.as_tensor(x)], dim=-1)
    rr, ri = k1.fn((-k1.hist * word) % (1 << 32), word, xpad)
    assert torch.equal(got[0], rr.reshape(-1)) and torch.equal(got[1], ri.reshape(-1))
    np.testing.assert_array_equal(tail.numpy(), x[:, n - kf.hist:])
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


def test_k20_two_buffers_match_jax_and_the_copy_path():
    taps, decim, p = lowpass(32, 0.25), 2, 4
    kf, jkf = _k20_pair(taps, decim)
    k1 = make_mix_fir_kernel(taps, decim, out_tile=128, b_rows=2, device="cpu")
    word = int(freq_to_word(0.31))
    n = p * 2 * 128 * decim
    x = np.random.default_rng(1).standard_normal((2, 2 * n)).astype(np.float32)
    mesh, jmesh = _mesh(p), jdist.make_mesh(time=p)
    tail_a = tail_b = torch.zeros(2, kf.hist)
    jtail = jnp.zeros((2, jkf.hist), jnp.float32)
    got_a, got_b, jgot = [], [], []
    for b in range(2):
        xb = x[:, b * n:(b + 1) * n]
        w0 = (b * n * word) % (1 << 32)
        shards = tdm.shard(torch.as_tensor(xb), mesh)
        tail_a, ya = k20.mix_fir_halo_sharded(kf, w0, word, tail_a, shards, mesh)
        tail_b, yb = tdf.mix_fir_time_sharded(k1, w0, word, tail_b, shards, mesh)
        jtail, jy = j_k20_sharded(jkf, w0, word, jtail,
                                  jax.device_put(jnp.asarray(xb), NamedSharding(jmesh, TIME)),
                                  jmesh)
        got_a.append(tdm.unshard(ya, "cpu"))
        got_b.append(tdm.unshard(yb, "cpu"))
        jgot.append(np.asarray(jy))
    a, b_ = torch.cat(got_a, dim=-1), torch.cat(got_b, dim=-1)
    assert torch.equal(a, b_) and torch.equal(tail_a, tail_b)
    assert _rel(a.numpy(), np.concatenate(jgot, axis=-1)) < 1e-5
    np.testing.assert_array_equal(tail_a.numpy(), np.asarray(jtail))


def test_k20_per_shard_fn_is_k1_on_the_concatenation():
    taps, decim = lowpass(64, 0.2), 2
    kf = k20.make_halo_fused_kernel(taps, decim, out_tile=128, b_rows=2, device="cpu")
    k1 = make_mix_fir_kernel(taps, decim, out_tile=128, b_rows=2, device="cpu")
    rng = np.random.default_rng(3)
    hist = torch.as_tensor(rng.standard_normal((2, kf.hist)).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((2, 2 * k1.block_in())).astype(np.float32))
    w0, dw = 0xDEADBEEF, int(freq_to_word(0.07))
    yr, yi = kf.fn(w0, dw, hist, x)
    rr, ri = k1.fn(w0, dw, torch.cat([hist, x], dim=-1))
    assert torch.equal(yr, rr) and torch.equal(yi, ri)
    assert tuple(yr.shape) == (2 * 2, 128)


def test_k20_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="block_cols"):
        k20.make_halo_fused_kernel(lowpass(64, 0.2), 2, out_tile=128, block_cols=96,
                                   device="cpu")
    kf = k20.make_halo_fused_kernel(lowpass(64, 0.2), 2, out_tile=128, b_rows=2, device="cpu")
    hist = torch.zeros(2, kf.hist)
    with pytest.raises(ValueError, match="not a multiple of 512"):
        kf.fn(0, 1, hist, torch.zeros(2, 768))
    with pytest.raises(ValueError, match=r"x_hist must be \[2, 128\]"):
        kf.fn(0, 1, torch.zeros(2, 64), torch.zeros(2, 512))
    with pytest.raises(ValueError, match="float32"):
        kf.fn(0, 1, hist, torch.zeros(2, 512, dtype=torch.float64))
    with pytest.raises(ValueError, match="kernel built for cpu"):
        kf.fn(0, 1, hist, torch.zeros(2, 512, device="meta"))
    mesh = _mesh(2)
    with pytest.raises(ValueError, match="unequal"):
        k20.mix_fir_halo_sharded(kf, 0, 1, hist, (torch.zeros(2, 512), torch.zeros(2, 1024)),
                                 mesh)
    with pytest.raises(ValueError, match="3 kernels for 2 shards"):
        k20.mix_fir_halo_sharded([kf] * 3, 0, 1, hist, (torch.zeros(2, 512),) * 2, mesh)
