"""Port vs JAX package: the multi-process tier (``srcdsp_tpu_torch.dist``
across processes, ``checkpoint.save_orbax`` / ``restore_orbax``).

The workers start once for the module, all at once: 2 ranks x 4 CPU shards
(the pipeline, K1, K11, K19, K20, the capture stream, config 5 and the orbax
case), 3 ranks x 4 shards
(the pipeline: 12 shards, the non-power-of-two case) and the fault
injection's 2 ranks. Each is a fresh interpreter joined over gloo at a
``file://`` rendezvous under the test's tmp path, on one torch thread, at the
reference's small shapes (4 shards a rank, M = 4P, out_tile 128, b_rows 2).
Rank 0 of each run holds its results against the port's one-process forms
(``dist.multihost_check``); here they are held against the JAX package on the
same numpy inputs, as ``tests/dist`` and ``bench/multihost_check.py`` hold
the reference:

- the pipeline (pre-FIR -> channelizer -> QPSK): indices equal to JAX's
  single-process ``channelize_full`` + ``psk_apply``, soft within the
  config-5 port-vs-JAX contract (rel L2 < 1e-4, ``tests/test_torch_dist.py``),
  and ``torch.equal`` to the port's one-process mesh form computed here;
- K1 (plain) across 2 ranks: rel L2 < 1e-5 against JAX
  ``mix_fir_decim_pallas(interpret=True)``, ``torch.equal`` to one port K1
  call over the unsharded stream, the carried tail exact;
- K19 (plain) across 2 ranks with the mesh, at two shapes: equal to JAX
  ``halo_from_left_pallas(interpret=True)`` on conftest's 8 virtual devices;
- K20 (plain) across 2 ranks with the mesh: rel L2 < 1e-5 against JAX K1 on
  the unsharded stream, ``torch.equal`` to the port's one-process
  ``mix_fir_halo_sharded`` on 8 shards, the carried tail exact;
- a ci16 capture streamed onto the 2 ranks' shards (``io.capture.
  device_blocks`` with a time sharding, each rank decoding only its shards)
  through K20, 3 blocks: ``torch.equal`` to the one-process stream, to one
  port K1 call over the whole capture, rel L2 < 1e-5 against JAX K1;
- the fault injection, 2 ranks -> 1 process: the stitched stream equal to
  the port's uninterrupted run, within rel L2 < 1e-5 of JAX
  ``channelize_full(fir_full(...))``;
- ``save_orbax`` / ``restore_orbax``: the reference's round trip
  (``tests/unit/test_checkpoint.py``), a 2-rank save restored in one
  process, and a one-process save restored on 2 ranks.

The pure tests lay meshes for 2 and 3 ranks x 4 devices without processes:
the shardings, and the routes of ``dist.ipc`` (which boundary is read in
place, by CUDA IPC or by message, on one host and on two), with K19 and K20
run on one rank's shards against a stand-in for the peers' messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from srcdsp_tpu.chains.channelizer import channelize_full as jchannelize_full
from srcdsp_tpu.chains.channelizer import design_prototype as jdesign_prototype
from srcdsp_tpu.chains.psk import make_psk_params as jmake_psk
from srcdsp_tpu.chains.psk import psk_apply as jpsk_apply
from srcdsp_tpu.chains.psk import psk_init as jpsk_init
from srcdsp_tpu.dist import make_mesh as jmake_mesh
from srcdsp_tpu.kernels.halo_dma import halo_from_left_pallas as jhalo
from srcdsp_tpu.kernels.mixfir import make_mix_fir_kernel as jmake_k1
from srcdsp_tpu.kernels.mixfir import mix_fir_decim_pallas
from srcdsp_tpu.ops.fir import fir_full as jfir_full
from srcdsp_tpu.ops.window import lowpass as jlowpass
from srcdsp_tpu_torch import checkpoint, tree
from srcdsp_tpu_torch.chains.channelizer import design_prototype
from srcdsp_tpu_torch.chains.fsk import fsk_init, make_fsk_params
from srcdsp_tpu_torch.chains.psk import make_psk_params, psk_apply, psk_init
from srcdsp_tpu_torch.dist import comm
from srcdsp_tpu_torch.dist import fault_injection_multihost as fim
from srcdsp_tpu_torch.dist import ipc
from srcdsp_tpu_torch.dist import mesh as tdm
from srcdsp_tpu_torch.dist import multihost_check as mhc
from srcdsp_tpu_torch.dist.channelize import channelize_time_sharded
from srcdsp_tpu_torch.dist.halo import fir_time_sharded
from srcdsp_tpu_torch.io import capture as tcapture
from srcdsp_tpu_torch.kernels import halo_dma as k19
from srcdsp_tpu_torch.kernels import halo_fused as k20
from srcdsp_tpu_torch.kernels import mixfir as tmf
from srcdsp_tpu_torch.ops.window import lowpass
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TIMEOUT = 150.0


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run of the module, started together."""
    base = tmp_path_factory.mktemp("multihost")
    work2, work3, workf = base / "r2", base / "r3", base / "fault"
    work2.mkdir()
    # the one-process save that the 2 ranks restore (1 -> 2)
    mesh8 = tdm.make_mesh(time=8, devices=["cpu"] * 8)
    checkpoint.save_orbax(str(work2 / "orbax_one"),
                          tuple(mhc.shard_state(g, CPU) for g in range(8)), 9,
                          sharding=tdm.time_sharding(mesh8))
    r2 = mhc.start(2, cases=("pipeline", "k1", "k11", "k19", "k20", "capture", "config5",
                             "orbax"), work=work2, timeout=TIMEOUT)
    r3 = mhc.start(3, cases=("pipeline",), work=work3, timeout=TIMEOUT)
    rf = fim.start("cpu", workf, TIMEOUT)
    return {2: mhc.collect(r2), 3: mhc.collect(r3), "fault": fim.resume(rf, "cpu")}


def _rank0(res, case):
    assert res["error"] is None, res["error"]
    return res["reports"][0]["cases"][case]


@pytest.mark.parametrize("nproc", [2, 3])
def test_config5_pipeline_across_ranks_matches_jax_and_one_process(runs, nproc):
    res = runs[nproc]
    c = _rank0(res, "pipeline")
    assert c["ok"] and c["equal_one_process"] and c["idx_equal_single"]
    assert all(r["cases"]["pipeline"]["ok"] for r in res["reports"])
    d = np.load(res["work"] / "pipeline.npz")
    x, m = d["x"], int(d["channels"])
    assert m == 4 * 4 * nproc
    # JAX, one process, on the same numpy input
    y = jfir_full(jnp.asarray(jlowpass(16, 0.45)), jnp.asarray(x))
    bank = jchannelize_full(jdesign_prototype(m, taps_per_phase=4), y, m)
    jpsk = jmake_psk(0.0, decim=1, sps=4, order=4, rrc_span=2)
    _, (jidx, jsoft) = jpsk_apply(jpsk, jpsk_init(jpsk, channel_shape=(m,)), bank)
    np.testing.assert_array_equal(d["idx"], np.asarray(jidx))
    assert _rel(d["soft"], jsoft) < 1e-4
    # the port's one-process mesh form with the same shard shapes, here
    mesh1 = mhc.one_process_mesh(4 * nproc, CPU)
    xt = torch.as_tensor(x)
    ys = fir_time_sharded(torch.as_tensor(lowpass(16, 0.45)), tdm.shard(xt, mesh1), mesh1)
    banks = channelize_time_sharded(design_prototype(m, taps_per_phase=4), ys, m, mesh1)
    psk = make_psk_params(0.0, decim=1, sps=4, order=4, rrc_span=2, device="cpu")
    outs = [psk_apply(psk, psk_init(psk, (b.shape[0],)), b)[1] for b in banks]
    assert torch.equal(torch.as_tensor(d["idx"]), torch.cat([o[0] for o in outs]))
    assert torch.equal(torch.as_tensor(d["soft"]), torch.cat([o[1] for o in outs]))


def _k1_matches_jax_and_one_call(d) -> None:
    """A 2-rank K1-contract result (x, y, tail, word, taps) == one port K1
    call over [zeros | x], the tail exact, within rel L2 1e-5 of JAX K1."""
    x, y, word = d["x"], d["y"], int(d["word"])
    taps = lowpass(int(d["taps"]), float(d["cutoff"]))
    k = tmf.make_mix_fir_kernel(taps, 2, out_tile=128, b_rows=2, device="cpu")
    hist = k.hist
    xpad = np.concatenate([np.zeros((2, hist), np.float32), x], axis=1)
    w0 = (-hist * word) % (1 << 32)
    yr, yi = k.fn(w0, word, torch.as_tensor(xpad))
    assert torch.equal(torch.as_tensor(y), torch.stack([yr.reshape(-1), yi.reshape(-1)]))
    np.testing.assert_array_equal(d["tail"], x[:, -hist:])
    jk = jmake_k1(jnp.asarray(jlowpass(int(d["taps"]), float(d["cutoff"]))), 2, out_tile=128,
                  b_rows=2, interpret=True)
    jr, ji = mix_fir_decim_pallas(jk, w0, word, jnp.asarray(xpad))
    jy = np.stack([np.asarray(jr).reshape(-1), np.asarray(ji).reshape(-1)])
    assert _rel(y, jy) < 1e-5


def test_k1_across_two_ranks_matches_jax_and_one_call(runs):
    c = _rank0(runs[2], "k1")
    assert c["ok"] and c["equal_one_call"]
    _k1_matches_jax_and_one_call(np.load(runs[2]["work"] / "k1.npz"))


def test_k19_across_two_ranks_matches_jax(runs):
    """K19 with the mesh: 2 ranks x 4 shards, each shape equal to the JAX
    kernel on 8 virtual devices and to the one-process port on rank 0."""
    c = _rank0(runs[2], "k19")
    assert c["ok"] and all(r["equal_one_process"] and r["equal_slices"] for r in c["shapes"])
    assert all(r["cases"]["k19"]["ok"] for r in runs[2]["reports"])
    d = np.load(runs[2]["work"] / "k19.npz")
    jmesh = jmake_mesh(time=8)
    for i in range(len(c["shapes"])):
        x, got, halo = d[f"x{i}"], d[f"got{i}"], int(d[f"halo{i}"])
        ref = np.asarray(jhalo(jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P(None, "time"))),
                               halo, jmesh, interpret=True))
        np.testing.assert_array_equal(got, ref.reshape(x.shape[0], 8, halo).transpose(1, 0, 2))


def test_k20_across_two_ranks_matches_jax_one_process_and_one_call(runs):
    """K20 with the mesh: 2 ranks x 4 shards within rel L2 1e-5 of JAX K1 on
    the unsharded stream, equal to one port K1 call and to the port's
    one-process K20 on 8 shards, the carried tail exact."""
    c = _rank0(runs[2], "k20")
    assert c["ok"] and c["equal_one_call"] and c["equal_one_process"]
    assert all(r["cases"]["k20"]["ok"] for r in runs[2]["reports"])
    d = np.load(runs[2]["work"] / "k20.npz")
    _k1_matches_jax_and_one_call(d)
    kf = k20.make_halo_fused_kernel(lowpass(int(d["taps"]), float(d["cutoff"])), 2, out_tile=128,
                                    b_rows=2, device="cpu")
    mesh8 = tdm.make_mesh(time=8, devices=["cpu"] * 8)
    tail, ys = k20.mix_fir_halo_sharded(kf, 0, int(d["word"]), torch.zeros((2, kf.hist)),
                                        tdm.shard(torch.as_tensor(d["x"]), mesh8), mesh8)
    assert torch.equal(torch.as_tensor(d["y"]), torch.cat(ys, dim=-1))
    assert torch.equal(torch.as_tensor(d["tail"]), tail)


def test_capture_streamed_across_two_ranks_matches_jax_and_one_process(runs):
    """A ci16 capture streamed by 2 ranks x 4 shards through K20 (3 blocks, the
    tail and word carried): equal to the one-process stream on rank 0, each
    rank one host copy a shard a block, the outputs equal to the port's K1
    over the whole capture from rest and within rel L2 1e-5 of JAX K1."""
    c = _rank0(runs[2], "capture")
    assert c["ok"] and c["equal_one_process"]
    for rep in runs[2]["reports"]:
        cap = rep["cases"]["capture"]
        assert cap["ok"] and cap["h2d"]["cpu"]["copies"] == cap["blocks"] * 4
    d = np.load(runs[2]["work"] / "capture.npz")
    blocks = c["blocks"]
    x, _ = tcapture.read_capture(str(runs[2]["work"] / "capture.ci16"))
    xp = np.stack([x.real, x.imag]).astype(np.float32)
    assert xp.shape[1] == blocks * int(d["block"])
    y = np.concatenate(list(d["y"]), axis=-1)             # [blocks, 2, L] -> [2, blocks*L]
    _k1_matches_jax_and_one_call(dict(x=xp, y=y, tail=d["tail"], word=d["word"],
                                      taps=d["taps"], cutoff=d["cutoff"]))


def test_k11_across_two_ranks_equals_one_call(runs):
    c = _rank0(runs[2], "k11")
    assert c["ok"] and c["equal_one_call"]
    assert all(r["cases"]["k11"]["ok"] for r in runs[2]["reports"])


def test_config5_mesh_form_across_two_ranks_equals_one_process(runs):
    c = _rank0(runs[2], "config5")
    assert c["ok"] and c["equal_one_process"] and c["idx_equal_single"]
    assert c["soft_max_diff_single"] <= 2e-5


def test_fault_injection_two_ranks_to_one_process(runs):
    res = runs["fault"]
    assert res["error"] is None, res["error"]
    assert res["ok"] and res["start"] == fim.STOP_AFTER
    assert torch.equal(res["stitched"], res["reference"])
    x = fim.pieces(CPU)[3]
    ref = jchannelize_full(jdesign_prototype(fim.M, taps_per_phase=4),
                           jfir_full(jnp.asarray(jlowpass(fim.PRE_TAPS, 0.45)),
                                     jnp.asarray(x.numpy())), fim.M)
    assert _rel(res["stitched"].numpy(), ref) < 1e-5


def test_save_orbax_of_two_ranks_restores_in_one_process(runs):
    mesh8 = tdm.make_mesh(time=8, devices=["cpu"] * 8)
    ex = tuple(tuple(torch.zeros_like(t) for t in mhc.shard_state(g, CPU)) for g in range(8))
    got, blk = checkpoint.restore_orbax(str(runs[2]["work"] / "orbax_ranks"), ex,
                                        sharding=tdm.time_sharding(mesh8))
    assert blk == 5
    for g, st in enumerate(got):
        assert all(torch.equal(a, b) for a, b in zip(st, mhc.shard_state(g, CPU)))


def test_save_orbax_of_one_process_restores_on_two_ranks(runs):
    for rep in runs[2]["reports"]:
        assert rep["cases"]["orbax"]["restored"] and rep["cases"]["orbax"]["ok"]


def test_orbax_backend_roundtrip(tmp_path):
    """The reference's ``test_orbax_backend_roundtrip`` on the port."""
    params = make_fsk_params(0.1, 32, 0.05, 2, 4, 0.05, device="cpu")
    st = fsk_init(params)
    st = st._replace(disc_last=st.disc_last + (0.5 + 0.25j))
    p = str(tmp_path / "ck")
    checkpoint.save_orbax(p, st, block_index=7)
    checkpoint.save_orbax(p, st, block_index=7)          # replaces the directory
    st2, blk = checkpoint.restore_orbax(p, fsk_init(params))
    assert blk == 7 and type(st2) is type(st)
    for a, b in zip(tree.flatten(st)[0], tree.flatten(st2)[0]):
        assert torch.equal(a, b)


# --- pure: meshes and shardings of several ranks, no process -----------------------

@pytest.mark.parametrize("ranks", [2, 3])
def test_time_and_channel_sharding_per_rank(ranks):
    devs = [["cpu"] * 4] * ranks
    for r in range(ranks):
        mesh = tdm.layout(4 * ranks, 1, devs, r)
        assert mesh.multiprocess() and mesh.rank == r
        ts = tdm.time_sharding(mesh)
        assert ts.axis == "time" and ts.dim == 0 and ts.num_shards == 4 * ranks
        assert ts.indices == tuple(range(4 * r, 4 * r + 4))
        assert ts.owners == tuple(q for q in range(ranks) for _ in range(4))
        assert tdm.time_sharding(mesh, ndim=3).dim == 2
        assert mesh.local_devices() == (CPU,) * 4
        row = tdm.layout(1, 4 * ranks, devs, r)
        cs = tdm.channel_sharding(row, ndim=2, axis=0)
        assert cs.axis == "channel" and cs.dim == 0 and cs.indices == ts.indices
        assert tdm.channel_sharding(row, ndim=3, axis=-1).dim == 2
        # a [ranks, 4] grid: rank r holds time row r, channel row 0 is rank 0's
        grid = tdm.layout(ranks, 4, devs, r)
        assert tdm.time_sharding(grid).indices == (r,)
        assert tdm.channel_sharding(grid).indices == ((0, 1, 2, 3) if r == 0 else ())
    with pytest.raises(ValueError, match="need"):
        tdm.layout(4 * ranks + 1, 1, devs, 0)


def test_one_process_mesh_is_every_shard():
    mesh = tdm.make_mesh(time=4, devices=["cpu"] * 4)
    assert not mesh.multiprocess() and mesh.local_indices() == (0, 1, 2, 3)
    spec = tdm.time_sharding(mesh, 2)
    x = torch.arange(32.0).reshape(2, 16)
    shards = tdm.local_shards(x, mesh, spec)
    assert all(torch.equal(a, b) for a, b in zip(shards, tdm.shard(x, mesh)))
    assert torch.equal(tdm.process_allgather(shards, spec), x)
    assert torch.equal(tdm.process_allgather(shards, spec, tiled=False), x.reshape(2, 4, 4)
                       .permute(1, 0, 2))
    assert comm.world() == 1 and comm.rank() == 0


@pytest.mark.parametrize("missing", ["coordinator", "num_processes", "process_id", "backend"])
def test_init_multihost_raises_on_a_missing_argument(missing, tmp_path):
    args = dict(coordinator=f"file://{tmp_path}/rdv", num_processes=2, process_id=0,
                backend="gloo")
    args[missing] = None
    with pytest.raises(ValueError, match=missing):
        tdm.init_multihost(**args)
    assert not comm.active()


def test_init_multihost_refuses_what_it_cannot_run(tmp_path):
    rdv = f"file://{tmp_path}/rdv"
    with pytest.raises(ValueError, match="backend"):
        tdm.init_multihost(rdv, 2, 0, "mpi")
    with pytest.raises(ValueError, match="process_id"):
        tdm.init_multihost(rdv, 2, 2, "gloo")
    with pytest.raises(ValueError, match="timeout"):
        tdm.init_multihost(rdv, 2, 0, "gloo", timeout=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):      # no card: no fallback
            tdm.init_multihost(rdv, 2, 0, "nccl")
    assert not comm.active()


def _boundaries(mesh) -> tuple[str, ...]:
    """How each boundary p = 1..P-1 moves: "local" (read in place on one
    rank), "ipc" or "message"."""
    by_shard = {r.to: r for r in ipc.routes(mesh)}
    return tuple("local" if p not in by_shard else "ipc" if by_shard[p].ipc else "message"
                 for p in range(1, mesh.shape["time"]))


@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("hosts", ["one", "two"])
def test_boundary_routes_by_topology(ranks, hosts):
    """Which boundaries of a time axis are read in place, moved by CUDA IPC
    or by message: IPC between ranks of one host on cards, a message across
    hosts or on the CPU; the carried tail's routes likewise."""
    cards = [[f"cuda:{r % 2}"] * 4 for r in range(ranks)]
    names = (["node0"] * ranks if hosts == "one"
             else [f"node{0 if r < ranks - 1 else 1}" for r in range(ranks)])
    for r in range(ranks):
        mesh = tdm.layout(4 * ranks, 1, cards, r, names)
        assert mesh.hosts == tuple(names)
        want = []
        for p in range(1, 4 * ranks):
            if p % 4:
                want.append("local")
            else:
                want.append("ipc" if names[p // 4 - 1] == names[p // 4] else "message")
        assert _boundaries(mesh) == tuple(want)
        rs = ipc.routes(mesh, tail=True)
        edges = [x for x in rs if x.to is not None]
        assert [(x.src, x.dst, x.shard, x.to) for x in edges] == [
            (q, q + 1, 4 * q + 3, 4 * q + 4) for q in range(ranks - 1)]
        tails = [x for x in rs if x.to is None]
        assert [(x.src, x.dst, x.shard) for x in tails] == [
            (ranks - 1, q, 4 * ranks - 1) for q in range(ranks - 1)]
        assert [x.ipc for x in tails] == [names[q] == names[-1] for q in range(ranks - 1)]
        cpu = tdm.layout(4 * ranks, 1, [["cpu"] * 4] * ranks, r, names)
        assert set(_boundaries(cpu)) == {"local", "message"}
        assert not any(x.ipc for x in ipc.routes(cpu, tail=True))
    one = tdm.make_mesh(time=4, devices=["cpu"] * 4)
    assert _boundaries(one) == ("local",) * 3 and ipc.routes(one, tail=True) == ()


@pytest.mark.parametrize("ranks", [2, 3])
def test_halo_kernels_on_one_rank_of_a_multiprocess_mesh(ranks, monkeypatch):
    """K19 and K20 on each rank's shards of a CPU mesh of 2 or 3 ranks (no
    longer refused as multi-process), the peers' messages stood in for by
    the slices of the whole stream: equal to the one-process forms; each
    rank sends exactly its routes' columns."""
    per, hist = 512, 128
    n = 4 * ranks * per
    x = torch.as_tensor(np.random.default_rng(ranks).standard_normal((2, n)).astype(np.float32))
    kf = k20.make_halo_fused_kernel(lowpass(32, 0.2), 2, out_tile=128, b_rows=2, device="cpu")
    one = tdm.make_mesh(time=4 * ranks, devices=["cpu"] * (4 * ranks))
    h1 = k19.halo_from_left_pallas(tdm.shard(x, one), hist)
    t1, y1 = k20.mix_fir_halo_sharded(kf, 7, 12345, torch.ones((2, hist)), tdm.shard(x, one), one)
    for r in range(ranks):
        mesh = tdm.layout(4 * ranks, 1, [["cpu"] * 4] * ranks, r)
        sent = []

        def exchange(sends, recvs):
            sent.extend((dst, t.clone()) for t, dst, _ in sends)
            out = []
            for shape, dtype, src, tag, device in recvs:
                route = next(q for q in ipc.routes(mesh, tail=True) if q.src == src
                             and q.dst == r)
                got = x[:, (route.shard + 1) * per - hist:(route.shard + 1) * per]
                out.append(got.clone().to(device, dtype).reshape(shape))
            return out

        monkeypatch.setattr(ipc.comm, "exchange", exchange)
        mine = tdm.shard(x, mesh)
        assert len(mine) == 4
        got = k19.halo_from_left_pallas(mine, hist, mesh)
        assert all(torch.equal(a, b) for a, b in zip(got, h1[4 * r:4 * r + 4]))
        t, ys = k20.mix_fir_halo_sharded(kf, 7, 12345, torch.ones((2, hist)), mine, mesh)
        assert all(torch.equal(a, b) for a, b in zip(ys, y1[4 * r:4 * r + 4]))
        assert torch.equal(t, t1)
        tail = x[:, (4 * r + 4) * per - hist:(4 * r + 4) * per]
        if r < ranks - 1:   # the boundary, twice (K19, then K20)
            assert [d for d, _ in sent] == [r + 1, r + 1]
        else:               # K20's carried tail to every other rank
            assert [d for d, _ in sent] == list(range(ranks - 1))
        assert all(torch.equal(t, tail) for _, t in sent)
