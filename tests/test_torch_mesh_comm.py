"""The port's mesh and collective facade (deepspeed_tpu_torch.parallel.mesh,
deepspeed_tpu_torch.comm) against deepspeed_tpu's (tests/test_mesh_comm.py).

At dp 2 and 4 the port runs as that many gloo ranks on the CPU
(tests/torch_dp.py: a ``file://`` store, one torch thread a rank), each
holding its block of the same numpy arrays; the JAX side runs its
collectives in ``shard_map`` over a mesh of as many CPU devices, each
device holding the same block. Tolerances: integer sums bitwise, fp32
results within 1e-6 (gloo and XLA sum in different orders); the gathers,
scatters of single values, permutations and the comms logger's records
exactly.
"""

import importlib

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import deepspeed_tpu.comm as jdist
from deepspeed_tpu.comm import coalesced as jcoal
from deepspeed_tpu.config import DeepSpeedTPUConfig
from deepspeed_tpu.parallel import mesh as jmesh

from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.parallel import mesh as tmesh
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the modules (each package's comm/__init__ exports the logger object
# under the module's name)
jlog_mod = importlib.import_module("deepspeed_tpu.comm.comms_logger")
tlog_mod = importlib.import_module("deepspeed_tpu_torch.comm.comms_logger")


def _arrays(n):
    rng = np.random.default_rng(n)
    return {"f": rng.standard_normal((2 * n, 8)).astype(np.float32),
            "i": rng.integers(-1000, 1000, (2 * n, 8)).astype(np.int32),
            "g": rng.standard_normal((2 * n * n, 8)).astype(np.float32),
            "h": rng.standard_normal((2 * n, 4 * n)).astype(np.float32),
            "c0": rng.standard_normal((3 * n, 5)).astype(np.float32),
            "c1": rng.standard_normal((2 * n,)).astype(np.float32)}


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def ranks(request):
    n = request.param
    arrays = _arrays(n)
    return n, arrays, spawn("collectives", n, arrays=arrays)


@pytest.fixture(scope="module")
def restore_mesh():
    saved, tsaved = jmesh._CURRENT_MESH, tmesh._CURRENT_MESH
    yield
    jmesh._CURRENT_MESH, tmesh._CURRENT_MESH = saved, tsaved


def _jax_mesh(n):
    return jmesh.build_mesh(data=n, devices=jax.devices()[:n],
                            set_current=False)


def _per_rank(n, fn, *arrays, out=P("data")):
    """fn over the blocks of ``arrays`` in shard_map on n devices; each
    output split back into the n devices' blocks."""
    res = jax.shard_map(fn, mesh=_jax_mesh(n),
                        in_specs=tuple(P("data") for _ in arrays),
                        out_specs=out)(*arrays)
    if isinstance(res, (tuple, list)):
        return [np.split(np.asarray(r), n) for r in res]
    return np.split(np.asarray(res), n)


def test_mesh_shapes_and_raises_match_jax(ranks, restore_mesh):
    """tests/test_mesh_comm.py:16-42 at the ranks' world: the inferred
    data axis, an explicit one, a bad product (the same message) and
    mesh_from_config; the seq, pipe and data_inner axes in the JAX device
    order."""
    n, _, res = ranks
    jm = jmesh.build_mesh(devices=jax.devices()[:n], set_current=False)
    for r in res:
        assert r["data"] == jm.shape["data"] == n
        assert r["dp"] == jmesh.get_data_parallel_world_size(jm) == n
        assert r["world"] == n
    with pytest.raises(ValueError) as e:
        jmesh.build_mesh(data=n + 1, devices=jax.devices()[:n],
                         set_current=False)
    assert res[0]["raises"]["product"] == str(e.value)
    # build_mesh(data_inner=2) in the JAX rank order: data, data_inner
    jmi = jmesh.build_mesh(data=n // 2, data_inner=2,
                           devices=jax.devices()[:n], set_current=False)
    order = np.asarray(jmi.devices).reshape(n // 2, 2)
    for r, rr in enumerate(res):
        im = rr["inner_mesh"]
        d, i = im["coords"]
        assert order[d, i].id == jax.devices()[r].id
        assert im["inner_index"] == i and im["dp"] == n
        assert im["inner_sum"] == sum(d * 2 + j for j in range(2))
        assert im["data_sum"] == sum(j * 2 + i for j in range(n // 2))
    # build_mesh(pipe=2) in the JAX rank order: 'pipe' the slowest axis
    jmp = jmesh.build_mesh(data=n // 2, pipe=2, devices=jax.devices()[:n],
                           set_current=False)
    order = np.asarray(jmp.devices).reshape(2, n // 2)
    for r, rr in enumerate(res):
        pm = rr["pipe_mesh"]
        p, d = pm["coords"]
        assert order[p, d].id == jax.devices()[r].id
        assert pm["pipe_index"] == p and (pm["pp"], pm["dp"]) == (2, n // 2)
        assert pm["pipe_sum"] == sum(j * (n // 2) + d for j in range(2))
        assert pm["data_sum"] == sum(p * (n // 2) + i for i in range(n // 2))
        # stage 0's block to stage 1 of its data row; stage 0 gets zeros
        assert pm["next"] == [float(r - n // 2) if p else 0.0]
    # build_mesh(seq=2) in the JAX rank order: data, seq
    jms = jmesh.build_mesh(data=n // 2, seq=2, devices=jax.devices()[:n],
                           set_current=False)
    order = np.asarray(jms.devices).reshape(n // 2, 2)
    for r, rr in enumerate(res):
        sm = rr["seq_mesh"]
        d, s = sm["coords"]
        assert order[d, s].id == jax.devices()[r].id
        assert sm["seq_index"] == s and (sm["sp"], sm["dp"]) == (2, n // 2)
        assert sm["seq_sum"] == sum(d * 2 + j for j in range(2))
        assert sm["data_sum"] == sum(i * 2 + s for i in range(n // 2))
    # build_mesh(expert=2) in the JAX rank order: data, expert, model
    jme = jmesh.build_mesh(data=n // 2, expert=2, devices=jax.devices()[:n],
                           set_current=False)
    order = np.asarray(jme.devices).reshape(n // 2, 2)
    for r, rr in enumerate(res):
        em = rr["expert_mesh"]
        d, e = em["coords"]
        assert order[d, e].id == jax.devices()[r].id
        assert (em["family_index"], em["expert_index"]) == (r, e)
        assert em["expert_sum"] == sum(d * 2 + j for j in range(2))
        assert em["data_sum"] == sum(i * 2 + e for i in range(n // 2))
        assert em["family_sum"] == n * (n - 1) / 2
        assert (em["ep"], em["dp"]) == (2, n)
        # block j of dim 0 went to expert rank j: [mine, peer's] halves
        peer = d * 2 + (1 - e)
        blocks = {r: [10 * r + 2 * e, 10 * r + 2 * e + 1],
                  peer: [10 * peer + 2 * e, 10 * peer + 2 * e + 1]}
        assert em["exchange"] == blocks[d * 2] + blocks[d * 2 + 1]
        # the sum over the row, block e to expert rank e, then gathered;
        # backward: the row's cotangents (rank + 1) summed, then gathered
        row = [2 * i + 10 * (4 * d + 1) for i in range(4)]
        assert em["scatter"] == row[2 * e:2 * e + 2]
        assert em["gather"] == row
        assert em["pair_grad"] == [4 * d + 3] * 4
    # build_mesh(model=2) in the JAX rank order: 'model' the fastest axis
    jm2 = jmesh.build_mesh(data=n // 2, model=2, devices=jax.devices()[:n],
                           set_current=False)
    order = np.asarray(jm2.devices).reshape(n // 2, 2)
    for r, rr in enumerate(res):
        mm = rr["model_mesh"]
        d, m = mm["coords"]
        assert order[d, m].id == jax.devices()[r].id
        assert (mm["data_index"], mm["model_index"]) == (d, m)
        assert mm["model_sum"] == sum(d * 2 + j for j in range(2))
        assert mm["data_sum"] == sum(i * 2 + m for i in range(n // 2))
        assert mm["world_sum"] == n * (n - 1) / 2
    assert jmesh.mesh_from_config(DeepSpeedTPUConfig.from_any({}),
                                  devices=jax.devices()[:n]
                                  ).shape["data"] == n


def test_mesh_in_one_process(restore_mesh):
    """Without torch.distributed the mesh is one rank: data inferred as 1,
    a product other than 1 refused as the JAX mesh refuses it, and
    mesh_from_config gives the same mesh."""
    m = tmesh.build_mesh()
    jm = jmesh.build_mesh(devices=jax.devices()[:1], set_current=False)
    assert m.shape == dict(jm.shape) and tmesh.get_mesh() is m
    assert not m.distributed and m.group("data") is None
    assert tmesh.get_data_parallel_world_size(m) == 1
    with pytest.raises(ValueError) as te:
        tmesh.build_mesh(data=3, model=3)
    with pytest.raises(ValueError) as je:
        jmesh.build_mesh(data=3, model=3, devices=jax.devices()[:1],
                         set_current=False)
    assert str(te.value) == str(je.value)
    assert tmesh.mesh_from_config(DeepSpeedConfig()).shape == m.shape
    # a mesh's ranks must be ranks of the world (a subset of them builds:
    # tests/test_torch_mics.py)
    with pytest.raises(ValueError, match="not distinct ranks"):
        tmesh.build_mesh(devices=[0, 1])


def test_all_reduce_matches_jax(ranks):
    n, a, res = ranks
    for op in ("sum", "mean", "max", "min"):
        want = _per_rank(n, lambda x, op=op: jdist.all_reduce(x, "data", op),
                         a["f"])
        for r in range(n):
            np.testing.assert_allclose(res[r][op], want[r], rtol=1e-6,
                                       atol=1e-6, err_msg=op)
    want = _per_rank(n, lambda x: jdist.all_reduce(x, "data"), a["i"])
    for r in range(n):
        assert res[r]["isum"].dtype == np.int32
        np.testing.assert_array_equal(res[r]["isum"], want[r])


def test_gathers_scatters_and_all_to_all_match_jax(ranks):
    n, a, res = ranks
    cases = {
        "gather0": (lambda x: jdist.all_gather(x, "data", axis=0), "f"),
        "gather1": (lambda x: jdist.all_gather(x, "data", axis=1), "f"),
        "gather_untiled": (lambda x: jdist.all_gather(
            x, "data", axis=0, tiled=False), "f"),
        "gather_async": (lambda x: jdist.all_gather(x, "data"), "f"),
        "rs0": (lambda x: jdist.reduce_scatter(x, "data", axis=0), "g"),
        "rs1": (lambda x: jdist.reduce_scatter(x, "data", axis=1), "h"),
        "a2a": (lambda x: jdist.all_to_all(x, "data", split_axis=0,
                                           concat_axis=1), "g"),
    }
    for key, (fn, src) in cases.items():
        want = _per_rank(n, fn, a[src])
        for r in range(n):
            assert res[r][key].shape == want[r].shape, key
            tol = 1e-6 if key.startswith("rs") else 0
            np.testing.assert_allclose(res[r][key], want[r], rtol=tol,
                                       atol=tol, err_msg=key)


def test_point_to_point_matches_jax(ranks):
    n, a, res = ranks
    cases = {
        "ring": lambda x: jdist.ppermute(x, "data", [(j, (j + 1) % n)
                                                     for j in range(n)]),
        "partial": lambda x: jdist.ppermute(x, "data", [(0, 1)]),
        "next": lambda x: jdist.send_recv_next(x, "data", n),
        "prev": lambda x: jdist.send_recv_prev(x, "data", n),
    }
    for key, fn in cases.items():
        want = _per_rank(n, fn, a["f"])
        for r in range(n):
            np.testing.assert_array_equal(res[r][key], want[r], key)
    assert [r["index"] for r in res] == list(range(n))


def test_coalesced_round_trips_match_jax(ranks):
    n, a, res = ranks
    rs = _per_rank(n, lambda x, y: jcoal.reduce_scatter_coalesced(
        [x, y], "data"), a["c0"], a["c1"])
    ar = _per_rank(n, lambda x, y: tuple(jcoal.all_reduce_coalesced(
        [x, y], "data")), a["c0"], a["c1"], out=(P("data"), P("data")))
    ag = _per_rank(n, lambda x, y: tuple(jcoal.all_gather_coalesced(
        [x, y], "data")), a["c0"], a["c1"], out=(P("data"), P("data")))
    for r in range(n):
        np.testing.assert_allclose(res[r]["rs_coalesced"], rs[r],
                                   rtol=1e-6, atol=1e-6)
        for k in range(2):
            np.testing.assert_allclose(res[r]["ar_coalesced"][k], ar[k][r],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(res[r]["ag_coalesced"][k],
                                          ag[k][r])
        assert res[r]["round_trip_err"] <= 1e-6
        assert res[r]["int_refused"]


def test_comms_logger_records_match_jax(ranks):
    """The same calls give the JAX logger's records (op → message bytes →
    count) — the JAX one records at trace time, the port's as it calls."""
    n, a, res = ranks
    jl = jlog_mod.comms_logger
    saved = (jl.enabled, jl.prof_all)
    jl.enabled, jl.prof_all = True, True
    jl.reset()
    try:
        def fn(f, g, c0, c1):
            jdist.all_reduce(f, "data")
            jdist.all_reduce(f, "data")
            jdist.all_gather(g, "data")
            jcoal.all_reduce_coalesced([c0, c1], "data")
            return f
        _per_rank(n, fn, a["f"], a["g"], a["c0"], a["c1"])
        want = {op: {s: v[0] for s, v in sizes.items()}
                for op, sizes in jl.comms_dict.items()}
    finally:
        jl.reset()
        jl.enabled, jl.prof_all = saved
    for r in range(n):
        got = {op: {s: v[0] for s, v in sizes.items()}
               for op, sizes in res[r]["records"].items()}
        assert got == want
        assert res[r]["bytes_by_op"]["all_reduce"] == 2 * a["f"].nbytes // n


def test_convert_size_and_msg_size_match_jax():
    for b in (0, 1, 1023, 1024, 123456789, 2 ** 50, -4096):
        assert tlog_mod.convert_size(b) == jlog_mod.convert_size(b)
    for op in ("all_reduce", "psum", "all_gather", "reduce_scatter",
               "all_to_all", "ppermute", "send", "custom_op"):
        for world in (1, 2, 8):
            assert tlog_mod.get_msg_size(op, 10 ** 6, world) == \
                jlog_mod.get_msg_size(op, 10 ** 6, world), (op, world)
    with pytest.raises(ValueError):
        tlog_mod.get_msg_size("all_reduce", -1, 2)
    rows = [{"all_reduce": {64: [1, 0.002]}},
            {"all_reduce": {64: [1, 0.005]}, "all_gather": {8: [2, 0.1]}}]
    assert tlog_mod.straggler_rows(rows, 1) == jlog_mod.straggler_rows(rows,
                                                                      1)
