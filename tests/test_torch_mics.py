"""MiCS (the 'data_inner' axis: stage-3 param shards within the
('data_inner', 'expert') sub-group, replicated over 'data') and the
multi-slice rank layouts of the port, against the JAX package on the
same numpy inputs: tests/test_mics.py's layout, its parity with plain
stage 3 and its checkpoint reshape, and tests/test_multislice.py's
layouts, validation errors, collectives and hybrid-mesh training.

The layout of data 4 × data_inner 2 comes from the ZeRO plan alone (no
processes). Everything else runs on four gloo ranks (tests/torch_dp.py)
against the JAX engine on ``build_mesh`` of the same shape over four CPU
devices: llama3-tiny (T 32, vocabulary 128) fp32, AdamW 1e-3 (eps 1e-6:
at 1e-8 an entry whose gradient is rounding noise moves by ±lr on the
noise's sign), stage 3, one global batch of 8 rows at every step, 4
steps. A two-slice layout puts rank r in slice r % 2, so the positions
on 'data' ([0, 2 | 1, 3]) are not the ranks' order.

Tolerances: losses within 1e-5 relative and parameters within 1e-4
absolute of the JAX engine (fp32; gloo and XLA sum in other orders);
the hybrid layout's run equals the plain layout's bitwise (it permutes
ranks, not arithmetic); checkpoints load bitwise; rank arrays, positions,
collectives' results and error messages exactly.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.models.llama import llama3_config as j_llama
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.models.transformer import partition_specs as j_specs
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.zero.sharding import \
    ZeroShardingPlan as JPlan

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.transformer import \
    partition_specs as t_specs
from deepspeed_tpu_torch.parallel.mesh import Mesh, hybrid_rank_array
from deepspeed_tpu_torch.runtime.zero.sharding import ZeroShardingPlan
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ, GB, STEPS = 128, 32, 8, 4
KW = {"max_seq_len": SEQ, "vocab_size": VOCAB}
LLAMA = ("llama3_config", KW)
SLICE_IDS = [0, 1, 0, 1]
MICS = {"data": 2, "data_inner": 2}


def _config(world, mics=True):
    zero = {"stage": 3}
    if mics:
        zero["mics_shard_size"] = 2
    return {"train_micro_batch_size_per_gpu": GB // world,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3,
                                                      "eps": 1e-6}},
            "zero_optimization": zero}


def _steps():
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, VOCAB, size=(GB, SEQ),
                                       dtype=np.int32)}
    return [[batch] for _ in range(STEPS)]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _spec_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _jax_engine(shape, config, init, out, name, save=None):
    jmesh.build_mesh(devices=jax.devices()[:4], **shape)
    je, *_ = deepspeed_tpu.initialize(model=j_llama("tiny", **KW),
                                      config=config, params=init)
    out[name] = {"losses": [float(je.train_batch(iter(s)))
                            for s in _steps()],
                 "params": _np_tree(je.params)}
    if save:
        je.save_checkpoint(save)
    return je


@pytest.fixture(scope="module")
def init():
    return _np_tree(j_init(j_llama("tiny", **KW), jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def runs(init, tmp_path_factory):
    """The JAX MiCS and plain stage-3 engines (the MiCS one saves for the
    port), the port's four ranks, then the JAX plain engine loading the
    port's MiCS save."""
    root = str(tmp_path_factory.mktemp("mics"))
    saved = jmesh._CURRENT_MESH
    jax_out = {}
    try:
        _jax_engine(MICS, _config(4), init, jax_out, "mics",
                    save=root + "/jax")
        _jax_engine({"data": 4}, _config(4, mics=False), init, jax_out,
                    "plain")
        runs_ = [
            {"name": "mics", "mesh": MICS, "model": LLAMA, "params": init,
             "config": _config(4), "steps": _steps(), "mode": "save",
             "dir": root + "/port"},
            {"name": "mics_hybrid", "mesh": dict(MICS, slice_ids=True,
                                                 dcn={"data": 2}),
             "model": LLAMA, "params": init, "config": _config(4),
             "steps": _steps()},
            {"name": "plain", "mesh": {"data": 4}, "model": LLAMA,
             "params": init, "config": _config(4, mics=False),
             "steps": _steps()},
            {"name": "load_plain", "mesh": {"data": 4}, "model": LLAMA,
             "params": init, "config": _config(4, mics=False), "steps": [],
             "mode": "load", "dir": root + "/port"},
            {"name": "load_jax", "mesh": MICS, "model": LLAMA,
             "params": init, "config": _config(4), "steps": [],
             "mode": "load", "dir": root + "/jax"}]
        port = spawn("mics_runs", 4, timeout=300.0, runs=runs_,
                     slice_ids=SLICE_IDS)
        jmesh.build_mesh(data=4, devices=jax.devices()[:4])
        je, *_ = deepspeed_tpu.initialize(model=j_llama("tiny", **KW),
                                          config=_config(4, mics=False),
                                          params=init)
        jax_out["load_port"] = {"tag": je.load_checkpoint(root + "/port")[0],
                                "params": _np_tree(je.params),
                                "opt": _np_tree(je.opt_state)}
    finally:
        jmesh._CURRENT_MESH = saved
    return {"jax": jax_out, "port": port}


def test_mics_layout_from_the_plan():
    """tests/test_mics.py's data 4 × data_inner 2 at stage 3: the param,
    gradient and state specs of the port's plan are the JAX plan's; a
    param shard lives on the ('data_inner', 'expert') sub-group only, and
    each state chunk nests 'data' inside it."""
    jcfg, tcfg = j_llama("tiny", **KW), dt.llama3_config("tiny", **KW)
    jm = jmesh.build_mesh(data=4, data_inner=2, devices=jax.devices()[:8],
                          set_current=False)
    tm = Mesh({"data": 4, "data_inner": 2})
    abstract = jax.eval_shape(lambda r: j_init(jcfg, r),
                              jax.random.PRNGKey(0))
    jp = JPlan(jm, 3, j_specs(jcfg, 3, mics=True), abstract)
    tabs = jax.tree.map(lambda x: torch.empty(x.shape, device="meta"),
                        abstract)
    tp = ZeroShardingPlan(tm, 3, t_specs(tcfg, 3, mics=True), tabs)
    nested = 0
    for attr in ("param_specs", "grad_specs", "state_specs"):
        want = {k: _spec_tuple(v) for k, v in _leaves_specs(
            getattr(jp, attr)).items()}
        got = {k: _spec_tuple(v) for k, v in _leaves_specs(
            getattr(tp, attr)).items()}
        assert got == want, attr
    for k, ps in _leaves_specs(tp.param_specs).items():
        flat = [a for e in ps if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        assert "data" not in flat, (k, ps)
        ss = _leaves_specs(tp.state_specs)[k]
        for pe, se in zip(_spec_tuple(ps), _spec_tuple(ss)):
            if isinstance(pe, tuple) and "data_inner" in pe:
                assert se == pe + ("data",), k
                nested += 1
    assert nested >= 6


def _leaves_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves_specs(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


def _held(got, want, name):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               err_msg=name)
    jp, tp = _leaves(want["params"]), _leaves(got["params"])
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-4,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["mics", "mics_hybrid", "plain"])
def test_mics_trains_like_the_jax_engine_and_plain_stage3(runs, name):
    """MiCS at data 2 × data_inner 2 against the JAX MiCS engine and the
    JAX plain stage 3 at data 4 (tests/test_mics.py's parity); the
    two-slice layout's run equals the plain layout's bitwise; every rank
    reports the same losses."""
    port = runs["port"]
    for r in range(4):
        got = port[r][name]
        assert got["losses"] == port[0][name]["losses"]
        _held(got, runs["jax"]["mics" if name != "plain" else "plain"],
              name)
        _held(got, runs["jax"]["plain"], name)
        if name == "mics_hybrid":
            assert got["losses"] == port[r]["mics"]["losses"]
            for k, v in _leaves(got["params"]).items():
                np.testing.assert_array_equal(
                    v, _leaves(port[r]["mics"]["params"])[k])


def test_mics_shards_and_gather_bytes(runs, init):
    """A MiCS rank holds 1/2 of each stage-3 weight (the sub-group's
    share) where plain stage 3 holds 1/4; a step's param gathers stay in
    the sub-group and move the sub-group formula's bytes: each gather a
    rank sends its 1/2 share, each layer gathered twice (forward and the
    backward's re-gather) and every other stage-3 leaf once."""
    port = runs["port"]
    leaves = _leaves(init)
    jm = jmesh.build_mesh(data=2, data_inner=2, devices=jax.devices()[:4],
                          set_current=False)
    specs = _leaves_specs(j_specs(j_llama("tiny", **KW), 3, mics=True))
    want = 0
    n_sharded = 0
    for k, ps in specs.items():
        if any(e is not None for e in ps):
            n_sharded += 1
            want += leaves[k].size // 2 * 4 * (2 if k.startswith("layers")
                                                else 1)
    assert jm.shape["data_inner"] == 2 and n_sharded >= 6
    for r in range(4):
        mics, plain = port[r]["mics"], port[r]["plain"]
        for lm, lp, (k, x) in zip(mics["local"], plain["local"],
                                  sorted_items_like(init)):
            if any(e is not None for e in specs[k]):
                assert np.prod(lm) * 2 == x.size, k
                assert np.prod(lp) * 4 == x.size, k
        assert mics["gather_bytes"]["data_inner"] == want
        # the outer 'data' gathers rebuild each param shard from the
        # finer state shards, once a step: a quarter of each weight
        assert mics["gather_bytes"]["data"] == sum(
            leaves[k].size // 4 * 4 for k, ps in specs.items()
            if any(e is not None for e in ps))


def sorted_items_like(tree, prefix=""):
    """(path, leaf) in the tree's own key order (the port's leaf order)."""
    out = []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out += sorted_items_like(v, p)
        else:
            out.append((p, np.asarray(v)))
    return out


def test_mics_checkpoints_cross_packages_and_modes(runs):
    """The port's MiCS save (each rank its param shard once per data row,
    its state shard) loads into a plain stage-3 engine of the port and
    into the JAX plain stage-3 engine bitwise; the JAX MiCS save loads
    into the port's MiCS engine bitwise."""
    port, jx = runs["port"], runs["jax"]
    for r in range(4):
        saved, got = port[r]["mics"], port[r]["load_plain"]
        assert got["tag"] is not None
        for k, v in _leaves(saved["params"]).items():
            np.testing.assert_array_equal(_leaves(got["loaded"])[k], v,
                                          err_msg=k)
        for k, v in _leaves(saved["opt"]).items():
            np.testing.assert_array_equal(_leaves(got["loaded_opt"])[k],
                                          v, err_msg=k)
        lj = port[r]["load_jax"]
        for k, v in _leaves(jx["mics"]["params"]).items():
            np.testing.assert_array_equal(_leaves(lj["loaded"])[k], v,
                                          err_msg=k)
    assert jx["load_port"]["tag"] is not None
    for k, v in _leaves(port[0]["mics"]["params"]).items():
        np.testing.assert_array_equal(_leaves(jx["load_port"]["params"])[k],
                                      v, err_msg=k)
    jo = _leaves(jx["load_port"]["opt"])
    for k, v in _leaves(port[0]["mics"]["opt"]).items():
        if k in jo:
            np.testing.assert_array_equal(jo[k], v, err_msg=k)


LAYOUTS = {"data_x_inner": dict(data=2, data_inner=2, dcn={"data": 2}),
           "auto_pipe": dict(pipe=2, data=2),
           "auto_data": dict(data=4),
           "inner_dcn": dict(data=2, data_inner=2, dcn={"data_inner": 2})}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_rank_arrays_match_jax_device_arrays(runs, name):
    """tests/test_multislice.py's layouts: the rank array is the JAX
    device-id array for the same slice_ids and dcn (auto-assigned: pipe
    first, then data), only the named axes cross slices, and each rank
    sits where its id sits."""
    jm = jmesh.build_mesh(devices=jax.devices()[:4], slice_ids=SLICE_IDS,
                          set_current=False, **LAYOUTS[name])
    want = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    for r, rr in enumerate(runs["port"]):
        got = rr["layouts"][name]
        np.testing.assert_array_equal(got["devices"], want)
        where = tuple(int(c) for c in np.argwhere(want == r)[0])
        assert tuple(got["coords"][a] for a in jmesh.MESH_AXES) == where
    shape = dict(zip(jmesh.MESH_AXES, want.shape))
    if "dcn" in LAYOUTS[name]:
        np.testing.assert_array_equal(
            hybrid_rank_array(range(4), shape, LAYOUTS[name]["dcn"],
                              SLICE_IDS), want)


def test_dcn_validation_errors_match_jax(runs):
    """build_mesh's errors (tests/test_multislice.py:96-110) carry the
    JAX messages."""
    cases = {"multiply": dict(data=4, dcn={"data": 4},
                              slice_ids=SLICE_IDS),
             "divisible": dict(data=1, model=4, dcn={"data": 2},
                               slice_ids=SLICE_IDS),
             "uneven": dict(data=4, dcn={"data": 2},
                            slice_ids=[0, 0, 0, 1]),
             "one_slice": dict(data=4, dcn={"data": 2}, slice_ids=[0] * 4),
             "pass_dcn": dict(data=1, model=4, slice_ids=[0, 0, 1, 1])}
    for name, kw in cases.items():
        with pytest.raises(ValueError) as e:
            jmesh.build_mesh(devices=jax.devices()[:4], set_current=False,
                             **kw)
        for rr in runs["port"]:
            assert rr["errors"][name] == str(e.value), name


def test_hybrid_collectives_and_sub_mesh(runs):
    """On the two-slice layout (positions [0, 2 | 1, 3] on 'data') each
    collective gives JAX's result by position — psum, the tiled gather,
    reduce-scatter, all-to-all, the shift to the next position, the
    expert-parallel exchange, sum-scatter and gather with their
    backwards, and the psum over ('data', 'data_inner') of
    tests/test_multislice.py:79 — and
    a mesh over ranks 0 and 1 runs on those two while 2 and 3 are not in
    it."""
    xs = [np.arange(8, dtype=np.float32) + 10 * p for p in range(4)]
    total = np.sum(xs, axis=0)
    for r, rr in enumerate(runs["port"]):
        h = rr["hybrid"]
        p = h["pos"]
        assert p == [0, 2, 1, 3][r] and h["index"] == p
        np.testing.assert_array_equal(h["sum"], total)
        np.testing.assert_array_equal(
            h["gather"], np.concatenate([x[:2] for x in xs]))
        np.testing.assert_array_equal(h["rs"], total[2 * p:2 * p + 2])
        np.testing.assert_array_equal(
            h["a2a"], np.concatenate([x[2 * p:2 * p + 2] for x in xs]))
        np.testing.assert_array_equal(h["next"], xs[(p - 1) % 4][:1])
        # the expert-parallel exchanges by position, forward and backward
        # (the rank at position q weighs block j it got by 10q + j + 1)
        np.testing.assert_array_equal(
            h["ep_exchange"], np.stack([x[2 * p:2 * p + 2] for x in xs]))
        np.testing.assert_array_equal(
            h["ep_exchange_grad"],
            np.repeat(10.0 * np.arange(4)[:, None] + p + 1, 2, axis=1))
        np.testing.assert_array_equal(h["ep_scatter"],
                                      total[None, 2 * p:2 * p + 2])
        np.testing.assert_array_equal(
            h["ep_scatter_grad"],
            np.repeat(10.0 * np.arange(4)[:, None] + 1, 2, axis=1))
        np.testing.assert_array_equal(h["ep_gather"],
                                      np.stack([x[:2] for x in xs]))
        np.testing.assert_array_equal(
            h["ep_gather_grad"], np.full((1, 2), 60.0 + 4 * (p + 1)))
        np.testing.assert_array_equal(h["psum_pair"], [6.0])
        sub = rr["sub"]
        assert sub["member"] == (r < 2)
        if r < 2:
            assert sub["sum"] == 3.0
    # the JAX psum over ('data', 'data_inner') of the hybrid mesh
    jm = jmesh.build_mesh(data=2, data_inner=2, devices=jax.devices()[:4],
                          dcn={"data": 2}, slice_ids=SLICE_IDS,
                          set_current=False)
    out = jax.jit(jax.shard_map(
        lambda x: jax.lax.psum(x, ("data", "data_inner")), mesh=jm,
        in_specs=P(("data", "data_inner")),
        out_specs=P(("data", "data_inner"))))(
        np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(out), [6.0] * 4)


def test_mesh_from_config_reads_mics_shard_size():
    """mesh_from_config takes data_inner from mics_shard_size as the JAX
    one does: on one rank a sub-group of 2 is refused with the JAX
    message, a size of 1 is plain ZeRO."""
    from deepspeed_tpu.config import DeepSpeedTPUConfig
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    from deepspeed_tpu_torch.parallel.mesh import mesh_from_config
    for size in (0, 1):
        m = mesh_from_config(DeepSpeedConfig.from_any({"zero_optimization": {
            "stage": 3, "mics_shard_size": size}}))
        assert m.shape["data_inner"] == 1
    conf = {"zero_optimization": {"stage": 3, "mics_shard_size": 2}}
    with pytest.raises(ValueError) as want:
        jmesh.mesh_from_config(DeepSpeedTPUConfig.from_any(conf),
                               devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        mesh_from_config(DeepSpeedConfig.from_any(conf))
    assert str(got.value) == str(want.value)
