"""Expert parallelism in the port's training engine: the mesh's 'expert'
axis, the capacity MoE over data × expert with its global slots, MoE
under tensor parallelism, ZeRO stages 0-3 and per-rank checkpoints at
ep > 1 — gloo ranks on the CPU (tests/torch_dp.py) against
``deepspeed_tpu.initialize`` on ``build_mesh`` of the same shape over the
8-device CPU mesh, from one numpy parameter tree.

mixtral-tiny (4 experts, top-2) and qwen2-moe-tiny (its shared expert)
fp32, Adam, clip 1.0, a global batch of 8 x 32 tokens a step, 4 steps.
The capacity layer runs at ``capacity_factor`` 1.0 with ``drop_tokens``,
so some experts overflow: the ranks must claim the slots the global
token order gives their tokens (each run asserts that tokens were
dropped). Random token selection hands both packages one permutation of
the global tokens (ROADMAP C4). Meshes: expert 2 (stages 0-3, stage 3
with overlap_comm, which falls back as the JAX plan does, the shared
expert, RTS), data 2 × expert 2 (stages 0-3, the shared expert, the
checkpoints both ways, elastic resume to data 4), data 2 × model 2 (the
capacity and the dropless MoE with the experts' f cut over 'model', the
shared expert). Dropless at ep > 1 and ZeRO++ over an expert axis raise
the JAX ``ValueError``s.

Tolerances: losses and the aux loss within 1e-5 relative over 4 steps,
parameters within 1e-4 absolute (fp32 on both sides; the ranks' sums and
gloo's reductions run in other orders than XLA's), checkpoints bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.qwen2_moe import qwen2_moe_config as j_qwen
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel import moe as jm

from deepspeed_tpu_torch.parallel import moe as tm
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ, GB, STEPS = 512, 32, 8, 4
KW = {"max_seq_len": SEQ, "vocab_size": VOCAB}
MIX = ("mixtral_config", KW)
QWEN = ("qwen2_moe_config", KW)
DROPS = {"impl": "capacity", "capacity_factor": 1.0, "drop_tokens": True,
         "use_rts": False}
RTS = dict(DROPS, capacity_factor=0.5, use_rts=True)
DROPLESS = {"impl": "dropless"}


def _data(seed):
    rng = np.random.default_rng(seed)
    return [[{"input_ids": rng.integers(0, VOCAB, size=(GB, SEQ),
                                        dtype=np.int32)}]
            for _ in range(STEPS)]


def _config(stage, data, ep, tp=1, moe=DROPS, zero=None):
    return {"train_micro_batch_size_per_gpu": GB // (data * ep),
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
            "zero_optimization": dict({"stage": stage}, **(zero or {})),
            "gradient_clipping": 1.0,
            "tensor_parallel": {"tp_size": tp},
            "moe": dict({"enabled": True, "ep_size": ep}, **moe)}


def _jcfg(spec):
    return {"mixtral_config": j_mixtral, "qwen2_moe_config": j_qwen}[
        spec[0]]("tiny", **spec[1])


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


PERM = np.random.default_rng(9).permutation(GB * SEQ)

#: the JAX references: name → (model, moe, mesh shape, data seed)
JAX = {
    "mix_e2": (MIX, DROPS, (1, 2, 1), 1),
    "qwen_e2": (QWEN, DROPS, (1, 2, 1), 2),
    "rts_e2": (MIX, RTS, (1, 2, 1), 3),
    "mix_d2e2": (MIX, DROPS, (2, 2, 1), 1),
    "qwen_d2e2": (QWEN, DROPS, (2, 2, 1), 2),
    "mix_d2m2": (MIX, DROPS, (2, 1, 2), 4),
    "dropless_d2m2": (MIX, DROPLESS, (2, 1, 2), 5),
    "qwen_d2m2": (QWEN, DROPS, (2, 1, 2), 6),
}
#: port runs: name → (JAX reference, stage, zero extras)
RUNS = {
    "e2": {"s0": ("mix_e2", 0, None), "s1": ("mix_e2", 1, None),
           "s2": ("mix_e2", 2, None), "s3": ("mix_e2", 3, None),
           "s3_overlap": ("mix_e2", 3, {"overlap_comm": True,
                                        "overlap_prefetch": 2}),
           "shared_s2": ("qwen_e2", 2, None), "rts_s1": ("rts_e2", 1, None)},
    "d2e2": {"s0": ("mix_d2e2", 0, None), "s1": ("mix_d2e2", 1, None),
             "s2": ("mix_d2e2", 2, None), "s3": ("mix_d2e2", 3, None),
             "shared_s3": ("qwen_d2e2", 3, None)},
    "e2_swapped": {"swapped_s1": ("mix_e2", 1, None)},
    "d2e2_hybrid": {"hybrid_s2": ("mix_d2e2", 2, None)},
    "d2m2": {"capacity_s0": ("mix_d2m2", 0, None),
             "capacity_s3": ("mix_d2m2", 3, None),
             "dropless_s1": ("dropless_d2m2", 1, None),
             "shared_s2": ("qwen_d2m2", 2, None)},
}
SHAPES = {"e2": (1, 2, 1), "e2_swapped": (1, 2, 1), "d2e2": (2, 2, 1),
          "d2e2_hybrid": (2, 2, 1), "d2m2": (2, 1, 2)}
#: meshes whose groups order their ranks otherwise than their positions:
#: the build_mesh keywords beyond the shape (JAX device ids where the
#: port takes ranks)
LAYOUTS = {"e2_swapped": {"devices": [1, 0]},
           "d2e2_hybrid": {"dcn": {"expert": 2}, "slice_ids": [1, 0, 1, 0]}}
CKPT = (MIX, 1, 7)          # model, stage, data seed of the checkpoints


@pytest.fixture(scope="module")
def init():
    return {spec[0]: _np_tree(j_init(_jcfg(spec), jax.random.PRNGKey(0)))
            for spec in (MIX, QWEN)}


def _mesh(shape):
    d, e, m = shape
    return jmesh.build_mesh(data=d, expert=e, model=m,
                            devices=jax.devices()[:d * e * m])


@pytest.fixture(scope="module")
def jax_runs(init, tmp_path_factory):
    """Every JAX reference, and the JAX side of the checkpoints: a save
    at data 2 × expert 2 for the port to load."""
    saved = jmesh._CURRENT_MESH
    out = {"dir": str(tmp_path_factory.mktemp("ep_ckpt"))}

    def j_perm(key, s):
        assert s == PERM.size
        return jnp.asarray(PERM, jnp.int32)
    real_perm = jax.random.permutation
    try:
        for name, (spec, moe, shape, seed) in JAX.items():
            _mesh(shape)
            jax.random.permutation = j_perm if moe is RTS else real_perm
            je, *_ = deepspeed_tpu.initialize(
                model=_jcfg(spec), params=init[spec[0]],
                config=_config(0, shape[0], shape[1], shape[2], moe))
            losses, aux = [], []
            for step in _data(seed):
                losses.append(float(je.train_batch(iter(step))))
                aux.append(float(je._last_metrics["aux_loss"]))
            out[name] = {"losses": losses, "aux": aux,
                         "params": _np_tree(je.params)}
        jax.random.permutation = real_perm
        spec, stage, seed = CKPT
        _mesh((2, 2, 1))
        je, *_ = deepspeed_tpu.initialize(
            model=_jcfg(spec), params=init[spec[0]],
            config=_config(stage, 2, 2))
        for step in _data(seed)[:2]:
            je.train_batch(iter(step))
        je.save_checkpoint(out["dir"] + "/jax")
        out["jax_saved"] = {"params": _np_tree(je.params),
                            "opt": _np_tree(je.opt_state)}
    finally:
        jax.random.permutation = real_perm
        jmesh._CURRENT_MESH = saved
    return out


def _runs(key, init):
    d, e, m = SHAPES[key]
    out = []
    for name, (ref, stage, zero) in RUNS[key].items():
        spec, moe, _, seed = JAX[ref]
        run = {"name": name, "model": spec, "params": init[spec[0]],
               "config": _config(stage, d, e, m, moe, zero),
               "steps": _data(seed)}
        if moe is RTS:
            run["perm"] = PERM
        out.append(run)
    return out


@pytest.fixture(scope="module")
def port(init, jax_runs):
    """Two spawns: expert 2 (world 2), and world 4 over data 2 × expert 2
    (its runs, the checkpoints), data 2 × model 2, then data 4 (elastic
    resume from the data × expert save)."""
    e2 = _runs("e2", init) + [
        {"name": "dropless_raises", "model": MIX, "mode": "raises",
         "config": _config(0, 1, 2, moe=DROPLESS)},
        {"name": "zeropp_raises", "model": MIX, "mode": "raises",
         "config": _config(2, 1, 2, zero={"zero_quantized_weights": True})}]
    spec, stage, seed = CKPT
    pdir = jax_runs["dir"] + "/port"
    ckpt = [{"name": "save", "model": spec, "params": init[spec[0]],
             "config": _config(stage, 2, 2), "steps": _data(seed)[:2],
             "mode": "save", "dir": pdir},
            {"name": "load", "model": spec, "params": init[spec[0]],
             "config": _config(stage, 2, 2), "mode": "load",
             "dir": jax_runs["dir"] + "/jax"}]
    elastic = {"name": "elastic", "model": spec, "mode": "elastic",
               "dir": pdir, "steps": _data(seed)[2:],
               "config": dict(_config(stage, 4, 1), elasticity={
                   "enabled": True, "micro_batch_sizes": [2],
                   "max_train_batch_size": GB, "max_gpus": 4})}
    world4 = [{"shape": {"data": 2, "expert": 2},
               "runs": _runs("d2e2", init) + ckpt},
              {"shape": dict(data=2, expert=2, **LAYOUTS["d2e2_hybrid"]),
               "runs": _runs("d2e2_hybrid", init)},
              {"shape": {"data": 2, "model": 2}, "runs": _runs("d2m2", init)},
              {"shape": {"data": 4}, "runs": [elastic]}]
    return {"e2": spawn("ep_runs", 2, meshes=[
        {"shape": {"expert": 2}, "runs": e2},
        {"shape": dict(expert=2, **LAYOUTS["e2_swapped"]),
         "runs": _runs("e2_swapped", init)}]),
        "w4": spawn("ep_runs", 4, meshes=world4, timeout=240.0),
        "pdir": pdir}


def _hold(got, want, name):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5,
                               err_msg=name)
    jp, tp = _leaves(want["params"]), _leaves(got["params"])
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-4,
                                   err_msg=f"{name} {k}")


CASES = [(key, name) for key in RUNS for name in RUNS[key]]


@pytest.mark.parametrize("key,name", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_ep_training_matches_jax_engine(port, jax_runs, key, name):
    d, e, m = SHAPES[key]
    res = port["e2"] if d * e * m == 2 else port["w4"]
    want = jax_runs[RUNS[key][name][0]]
    # each rank's coordinates: where its id stands in the JAX device array
    # of the same layout
    ids = jmesh.build_mesh(data=d, expert=e, model=m,
                           devices=jax.devices()[:d * e * m],
                           set_current=False, **{
                               k: v for k, v in LAYOUTS.get(key, {}).items()
                               if k != "devices"})
    ids = np.vectorize(lambda x: x.id)(ids.devices).reshape(d, e, m)
    if "devices" in LAYOUTS.get(key, {}):
        ids = np.asarray(LAYOUTS[key]["devices"])[ids]
    for r, rr in enumerate(res):
        got = rr[name]
        _hold(got, want, f"{key}/{name} rank {r}")
        assert got["losses"] == res[0][name]["losses"]
        pos = [int(i[0]) for i in np.nonzero(ids == r)]
        assert got["coords"] == dict(zip(("data", "expert", "model"), pos))
        if e > 1:
            # the expert leaves hold this rank's E/ep experts
            n_exp = sum(x is not None for x in got["edim"])
            assert n_exp >= 3
            moe = got["params"]["layers"]["moe"]["wg"]
            assert moe.shape[1] == 4
    if JAX[RUNS[key][name][0]][1] is not DROPLESS:
        # slots go in the global token order: the later blocks' tokens
        # are the ones past an expert's capacity
        seen = [x for rr in res for x in rr[name]["drops"]]
        kept = sum(k for k, _ in seen)
        assert 0 < kept < sum(n for _, n in seen), "no token was dropped"


def test_unported_and_refused_at_ep2(port):
    for rr in port["e2"]:
        assert rr["dropless_raises"].startswith("ValueError") and \
            "requires ep_size=1" in rr["dropless_raises"]
        assert rr["zeropp_raises"].startswith("ValueError") and \
            "mesh axis 'expert' has size 2" in rr["zeropp_raises"]


def test_jax_save_loads_into_the_port_at_data2_expert2(port, jax_runs):
    want = jax_runs["jax_saved"]
    for r, rr in enumerate(port["w4"]):
        got = rr["load"]
        assert got["tag"] == "global_step2"
        gl = _leaves(got["params"])
        for k, v in _leaves(want["params"]).items():
            np.testing.assert_array_equal(gl[k], v, err_msg=f"{k} {r}")
        for key in ("exp_avg", "exp_avg_sq"):
            gl = _leaves(got["opt"][key])
            for k, v in _leaves(want["opt"][key]).items():
                np.testing.assert_array_equal(gl[k], v, err_msg=k)


def test_port_save_loads_into_jax_and_resumes_at_data4(port, init):
    """The data × expert save (each expert leaf's box along E in the JAX
    layout) loads bitwise into the JAX engine on the same mesh, and
    ``elastic_resume`` at data 4 reads the same tree and trains on."""
    spec, stage, seed = CKPT
    saved = jmesh._CURRENT_MESH
    try:
        _mesh((2, 2, 1))
        jl, *_ = deepspeed_tpu.initialize(
            model=_jcfg(spec), config=_config(stage, 2, 2),
            params=jax.tree.map(np.zeros_like, init[spec[0]]))
        tag, _ = jl.load_checkpoint(port["pdir"])
        loaded = {"params": _np_tree(jl.params),
                  "opt": _np_tree(jl.opt_state)}
    finally:
        jmesh._CURRENT_MESH = saved
    assert tag == "global_step2"
    want = port["w4"][0]["save"]
    for k, v in _leaves(want["params"]).items():
        np.testing.assert_array_equal(_leaves(loaded["params"])[k], v,
                                      err_msg=k)
    for key in ("exp_avg", "exp_avg_sq"):
        for k, v in _leaves(want["opt"][key]).items():
            np.testing.assert_array_equal(_leaves(loaded["opt"][key])[k], v,
                                          err_msg=k)
    for rr in port["w4"]:
        el = rr["elastic"]
        assert el["tag"] == "global_step2"
        for k, v in _leaves(want["params"]).items():
            np.testing.assert_array_equal(_leaves(el["loaded"])[k], v,
                                          err_msg=k)
        assert np.all(np.isfinite(el["losses"])) and len(el["losses"]) == 2


def test_global_dispatch_matches_topk_gating():
    """The split batch's gating: each block's rows of the dispatch and
    combine computed from the gathered logits equal ``topk_gating`` (the
    port's and the JAX one) over every token, drops and a random token
    order included, and the blocks' aux losses average to the global
    one."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((64, 4)).astype(np.float32) * 2
    t = torch.from_numpy(logits)
    jd, jc, ja = jm.topk_gating(jnp.asarray(logits), 2, 20)
    for perm in (None, rng.permutation(64)):
        tp = None if perm is None else torch.from_numpy(perm)
        d, c, a = tm.topk_gating(t, 2, 20, rts_perm=tp)
        if perm is None:
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
            np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
        assert int(d.sum()) < 64 * 2            # tokens were dropped
        auxs = []
        for r in range(4):
            lo = r * 16
            dr, cr, ar = tm.topk_gating_rows(t, t[lo:lo + 16], lo, 2, 20,
                                             rts_perm=tp)
            assert torch.equal(dr, d[lo:lo + 16])
            torch.testing.assert_close(cr, c[lo:lo + 16], rtol=0, atol=1e-7)
            auxs.append(ar)
        torch.testing.assert_close(torch.stack(auxs).mean(), a, rtol=1e-6,
                                   atol=0)


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
        return
    assert a.shape == b.shape and torch.equal(a, b), path


@pytest.mark.parametrize("weight_quant,tp", [(None, 1), ("int8", 1),
                                             (None, 2)],
                         ids=["float", "int8", "float_tp2"])
def test_init_params_ep_blocks_equal_full_draw(weight_quant, tp):
    """``init_params(ep=(2, r))`` keeps rank r's experts of the full draw,
    bit for bit, for a float and a quantized tree and composed with
    ``tp=`` (experts cut on f), with slices that hold several experts
    and slices of one expert each."""
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config
    cfg = qwen2_moe_config("tiny", hidden_size=128, intermediate_size=256,
                           num_experts=8, vocab_size=256)
    saved = ttf.INIT_SLICE_VALUES
    try:
        for step in (saved, 128 * 256):
            ttf.INIT_SLICE_VALUES = step
            full = ttf.init_params(cfg, torch.Generator().manual_seed(3),
                                   weight_quant=weight_quant)
            for m in range(tp):
                want = full if tp == 1 else ttf.shard_model_axis(
                    full, ttf.tp_specs(cfg, full, tp), tp, m)
                for r in range(2):
                    got = ttf.init_params(
                        cfg, torch.Generator().manual_seed(3),
                        weight_quant=weight_quant, ep=(2, r),
                        tp=(tp, m) if tp > 1 else None)
                    _equal_trees(got, ttf.shard_expert_axis(want, 2, r))
                    assert got["layers"]["moe"]["wg"].shape[1] == 4
    finally:
        ttf.INIT_SLICE_VALUES = saved
