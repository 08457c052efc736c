"""The port's engine data parallel at dp 2 and 4 (gloo ranks on the CPU,
tests/torch_dp.py) against deepspeed_tpu.initialize on build_mesh(data=8)
(tests/test_engine.py:84's gpt2-tiny fp32 config and data: Adam, clip
1.0, a global batch of 16 x 32 tokens), from one numpy parameter tree.

LAMB and Muon at stages 1-3 (their trust ratios taken over each whole
leaf, their Newton–Schulz over each whole matrix: a rank's pieces are
summed or gathered over its ZeRO group) against the JAX engine's LAMB and
Muon at stage 0 on the same mesh (GSPMD runs them unchanged at every
stage), within the same tolerances.

Runs: ZeRO stages 0-3, and stage 3 with overlap_comm at three bucket
sizes (one layer a chunk; two layers with prefetch 2; the whole stack
without re-gather); gas 2 at stages 1 and 3; a batch whose ranks ignore
different numbers of labels (stage 2); an fp16 overflow that only the
last rank sees (stage 2, every rank must skip); eval_batch after two
stage-3 runs (the loop without autograd); dropless MoE at stage 3
and the capacity MoE over the global slots (the gradients of one batch);
the mesh's unported axes raise.

Tolerances: losses within 1e-5 relative over 4 steps and parameters
within 1e-4 absolute (both sides fp32; they differ in summation order:
gloo's ring against XLA's reductions, dp 2/4 blocks against 8); MoE
gradients within 2e-4 (tests/test_moe.py:523's). The skipped step is
bitwise: no parameter moves on any rank. Muon's parameters within 5e-4
(``MUON_ATOL``: its Newton–Schulz is bf16 on both sides).
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models.gpt import gpt2_config as j_gpt2
from deepspeed_tpu.models.llama import llama3_config as j_llama
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel import mesh as jmesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.parallel.mesh import Mesh
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ, GB, STEPS = 512, 32, 16, 4
GPT2 = ("gpt2_config", {"max_seq_len": SEQ, "vocab_size": VOCAB})
#: Muon's runs: no attention biases (a key bias's gradient is rounding
#: noise — softmax ignores it — which Newton–Schulz scales to a full step)
LLAMA = ("llama3_config", {"max_seq_len": SEQ, "vocab_size": VOCAB})
MOE_KW = {"hidden_size": 128, "intermediate_size": 256, "vocab_size": 256}
MOE = ("mixtral_config", MOE_KW)
CAPACITY = {"impl": "capacity", "use_rts": False, "capacity_factor": 1.0}


def _data(steps, seed=0, gas=1):
    rng = np.random.default_rng(seed)
    return [[{"input_ids": rng.integers(0, VOCAB, size=(GB, SEQ),
                                        dtype=np.int32)}
             for _ in range(gas)] for _ in range(steps)]


def _uneven(steps, seed=3):
    """Labels: the first half of the rows ignore all but 8 positions, the
    second half only the last one."""
    out = []
    for step in _data(steps, seed):
        tok = step[0]["input_ids"]
        lab = np.concatenate([tok[:, 1:], np.full((GB, 1), -100)], 1)
        lab[:GB // 2, 8:] = -100
        out.append([{"input_ids": tok, "labels": lab.astype(np.int32)}])
    return out


#: the optimizers of the runs: Adam, and the two whose update is not
#: elementwise
OPTS = {"adam": {"type": "adam",
                 "params": {"lr": 1e-3, "betas": [0.9, 0.999]}},
        "lamb": {"type": "lamb", "params": {"lr": 1e-3,
                                            "weight_decay": 0.01}},
        "muon": {"type": "muon", "params": {"lr": 1e-3,
                                            "weight_decay": 0.01,
                                            "adam_eps": 1e-6}}}


def _config(stage, world, gas=1, zero=None, opt="adam", **extra):
    cfg = {"train_micro_batch_size_per_gpu": GB // world,
           "gradient_accumulation_steps": gas,
           "optimizer": OPTS[opt],
           "zero_optimization": dict({"stage": stage}, **(zero or {})),
           "gradient_clipping": 1.0}
    cfg.update(extra)
    return cfg


def _moe_config(world):
    return {"train_micro_batch_size_per_gpu": 8 // world,
            "optimizer": {"type": "adamw", "params": {"lr": 2e-3}},
            "zero_optimization": {"stage": 3},
            "moe": {"impl": "dropless", "aux_loss_coef": 0.01}}


def _moe_batch():
    rng = np.random.default_rng(11)
    return [[{"input_ids": rng.integers(0, 256, size=(8, 64),
                                        dtype=np.int32)}]]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


@pytest.fixture(scope="module")
def init():
    return (_np_tree(j_init(j_gpt2("tiny", max_seq_len=SEQ,
                                   vocab_size=VOCAB), jax.random.PRNGKey(0))),
            _np_tree(j_init(j_mixtral("tiny", **MOE_KW),
                            jax.random.PRNGKey(1))),
            _np_tree(j_init(j_llama("tiny", max_seq_len=SEQ,
                                    vocab_size=VOCAB),
                            jax.random.PRNGKey(2))))


#: name → (stage, gas, zero extras, data[, optimizer])
RUNS = {
    "s0": (0, 1, None, _data(STEPS)),
    "s1": (1, 1, None, _data(STEPS)),
    "s2": (2, 1, None, _data(STEPS)),
    "s3": (3, 1, None, _data(STEPS)),
    "s3_overlap_layer": (3, 1, {"overlap_comm": True}, _data(STEPS)),
    "s3_overlap_two": (3, 1, {"overlap_comm": True, "overlap_prefetch": 2,
                              "overlap_bucket_bytes": 2 * 50_000},
                       _data(STEPS)),
    "s3_overlap_all": (3, 1, {"overlap_comm": True,
                              "overlap_bucket_bytes": 10 ** 9,
                              "overlap_regather": False}, _data(STEPS)),
    "gas2_s1": (1, 2, None, _data(STEPS, seed=5, gas=2)),
    "gas2_s3": (3, 2, None, _data(STEPS, seed=5, gas=2)),
    "uneven_s2": (2, 1, None, _uneven(STEPS)),
}
for _opt in ("lamb", "muon"):
    for _stage in (1, 2, 3):
        RUNS[f"{_opt}_s{_stage}"] = (_stage, 1, None, _data(STEPS, seed=7),
                                     _opt)
#: Muon's parameters: its Newton–Schulz runs in bf16 on both sides, and
#: XLA's bf16 products round otherwise than torch's (the single-device
#: port differs from the JAX engine by as much: up to 1e-4 here), so the
#: runs are held to half of one step (lr 1e-3); a rank that
#: orthogonalized its shard alone would be off by whole steps. Its Adam
#: leaves take ``adam_eps`` 1e-6: at 1e-8 an embedding entry whose
#: gradient is rounding noise moves by ±lr on the noise's sign
MUON_ATOL = 5e-4
#: which JAX run each port run is held to (its stage, gas and data)
JAX_OF = {"s0": "s0", "s1": "s1", "s2": "s2", "s3": "s3",
          "s3_overlap_layer": "s3_overlap", "s3_overlap_two": "s3_overlap",
          "s3_overlap_all": "s3_overlap", "gas2_s1": "gas2",
          "gas2_s3": "gas2", "uneven_s2": "uneven",
          **{f"{o}_s{k}": o for o in ("lamb", "muon") for k in (1, 2, 3)}}
#: stage-3 runs that also take eval_batch on EVAL after training
EVAL_RUNS = ("s3", "s3_overlap_two")
EVAL = _data(1, seed=13)[0]


@pytest.fixture(scope="module")
def jax_runs(init):
    """The JAX engine on the 8-device CPU mesh: losses and params after
    STEPS steps of each reference run; the MoE gradients of one batch."""
    saved = jmesh._CURRENT_MESH
    out = {}
    try:
        jmesh.build_mesh(data=8)
        ref = {"s0": (0, 1, None, RUNS["s0"][3]),
               "s1": (1, 1, None, RUNS["s1"][3]),
               "s2": (2, 1, None, RUNS["s2"][3]),
               "s3": (3, 1, None, RUNS["s3"][3]),
               "s3_overlap": (3, 1, {"overlap_comm": True}, RUNS["s3"][3]),
               "gas2": (0, 2, None, RUNS["gas2_s1"][3]),
               "uneven": (0, 1, None, RUNS["uneven_s2"][3]),
               "lamb": (0, 1, None, RUNS["lamb_s1"][3], "lamb"),
               "muon": (0, 1, None, RUNS["muon_s1"][3], "muon")}
        for name, (stage, gas, zero, data, *opt) in ref.items():
            muon = opt == ["muon"]
            je, *_ = deepspeed_tpu.initialize(
                model=(j_llama if muon else j_gpt2)(
                    "tiny", max_seq_len=SEQ, vocab_size=VOCAB),
                config=_config(stage, 8, gas, zero, *opt),
                params=init[2 if muon else 0])
            losses = [float(je.train_batch(iter(step))) for step in data]
            out[name] = {"losses": losses, "params": _np_tree(je.params)}
            if name in {JAX_OF[n] for n in EVAL_RUNS}:
                out[name]["eval"] = float(je.eval_batch(iter(EVAL)))
        je, *_ = deepspeed_tpu.initialize(model=j_mixtral("tiny", **MOE_KW),
                                          config=_moe_config(8),
                                          params=init[1])
        batch = _moe_batch()[0][0]
        loss = je.forward(batch)
        out["moe"] = {"loss": float(loss),
                      "grads": _np_tree(je._pending_grads)}
        je, *_ = deepspeed_tpu.initialize(
            model=j_mixtral("tiny", **MOE_KW),
            config=dict(_moe_config(8), moe=CAPACITY), params=init[1])
        out["capacity"] = {"loss": float(je.forward(batch)),
                           "grads": _np_tree(je._pending_grads)}
    finally:
        jmesh._CURRENT_MESH = saved
    return out


def _port_runs(world, init):
    runs = [{"name": name, "model": LLAMA if opt == ["muon"] else GPT2,
             "params": init[2 if opt == ["muon"] else 0],
             "config": _config(stage, world, gas, zero, *opt),
             "steps": data, "layout": name == "s3",
             "eval": EVAL if name in EVAL_RUNS else None}
            for name, (stage, gas, zero, data, *opt) in RUNS.items()]
    runs.append({"name": "fp16_skip", "model": GPT2, "params": init[0],
                 "config": _config(2, world, fp16={
                     "enabled": True, "initial_scale_power": 8,
                     "hysteresis": 1}),
                 "steps": _data(2, seed=9), "mode": "poison"})
    runs.append({"name": "capacity", "model": MOE, "params": init[1],
                 "config": dict(_moe_config(world), moe=CAPACITY),
                 "steps": _moe_batch(), "mode": "grads"})
    runs.append({"name": "moe", "model": MOE, "params": init[1],
                 "config": _moe_config(world), "steps": _moe_batch(),
                 "mode": "grads"})
    return runs


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def port(request, init):
    world = request.param
    return world, spawn("engine_runs", world,
                        runs=_port_runs(world, init))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_stage_matches_jax_engine(port, jax_runs, name):
    world, res = port
    want = jax_runs[JAX_OF[name]]
    for r in range(world):
        got = res[r][name]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5, err_msg=f"{name} rank {r}")
        assert got["losses"] == res[0][name]["losses"]
        jp, tp = _leaves(want["params"]), _leaves(got["params"])
        assert sorted(jp) == sorted(tp)
        atol = MUON_ATOL if name.startswith("muon") else 1e-4
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=atol,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", EVAL_RUNS)
def test_stage3_eval_matches_jax_without_graph(port, jax_runs, name):
    """eval_batch at stage 3 runs the layer loop without autograd: every
    chunk computes with gradients off and keeps no graph (training's loop
    keeps each chunk's activations for its backward), and the loss is the
    JAX engine's."""
    world, res = port
    want = jax_runs[JAX_OF[name]]["eval"]
    for r in range(world):
        got = res[r][name]
        np.testing.assert_allclose(got["eval"], want, rtol=1e-5,
                                   err_msg=f"{name} rank {r}")
        assert len(got["eval_chunks"]) > 0
        assert not any(got["eval_chunks"]), got["eval_chunks"]


def test_stage3_holds_shards(port):
    """At stage 3 the params live as 1/dp blocks along their
    partition_specs dim; norms and biases stay whole."""
    world, res = port
    lay = res[0]["s3"]["layout"]
    full = _leaves(res[0]["s3"]["params"])
    sharded = 0
    for (path, x), local, pd in zip(full.items(), lay["local"],
                                    lay["pdim"]):
        shape = list(x.shape)
        if pd is not None:
            shape[pd] //= world
            sharded += 1
        assert tuple(shape) == tuple(local), path
    assert sharded >= 6
    assert all(s is not None for p, s in zip(lay["pdim"], lay["sdim"])
               if p is not None)


def test_fp16_overflow_skipped_on_every_rank(port):
    """Only the last rank's reduced gradient holds the inf: the all-reduced
    flag makes every rank skip the step (no parameter moves, bitwise) and
    halve the loss scale; the next step trains."""
    world, res = port
    for r in range(world):
        got = res[r]["fp16_skip"]
        assert got["skipped"] == [1, 1], r
        assert got["scales"] == [128.0, 128.0], r
        for k, v in _leaves(got["before"]).items():
            np.testing.assert_array_equal(_leaves(got["after_skip"])[k], v)
        moved = max(float(np.abs(_leaves(got["params"])[k] - v).max())
                    for k, v in _leaves(got["before"]).items())
        assert moved > 0
        assert got["params"].keys() == res[0]["fp16_skip"]["params"].keys()


def test_moe_dropless_grads_match_jax(port, jax_runs):
    world, res = port
    want = jax_runs["moe"]
    for r in range(world):
        got = res[r]["moe"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        jg = _leaves(want["grads"])
        assert sorted(jg) == sorted(got["names"])
        for name, g in zip(got["names"], got["grads"]):
            np.testing.assert_allclose(g, jg[name], rtol=2e-4, atol=2e-4,
                                       err_msg=name)


def test_capacity_moe_and_other_axes_raise(port, jax_runs):
    """The capacity MoE at dp > 1 claims its slots in the global token
    order (its gradients equal the JAX engine's on the 8-device mesh);
    the mesh's unported axes raise."""
    world, res = port
    want = jax_runs["capacity"]
    for r in range(world):
        got = res[r]["capacity"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        jg = _leaves(want["grads"])
        for name, g in zip(got["names"], got["grads"]):
            np.testing.assert_allclose(g, jg[name], rtol=2e-4, atol=2e-4,
                                       err_msg=name)
    cfg = dt.gpt2_config("tiny", max_seq_len=SEQ, vocab_size=VOCAB)
    # expert and sequence parallelism together are not ported
    with pytest.raises(NotImplementedError, match="Parallelism breadth"):
        dt.initialize(cfg, dict(_config(0, 1), sequence_parallel={
            "size": 2}), device="cpu",
            mesh=Mesh({"data": 1, "expert": 2, "seq": 2}))
    # the model, expert, seq, pipe and data_inner axes run
    # (test_torch_tensor_parallel.py, test_torch_expert_parallel.py,
    # test_torch_sequence_parallel.py, test_torch_pipeline.py,
    # test_torch_mics.py), over as many ranks as the mesh holds
    for shape in ({"data": 2}, {"data": 1, "model": 2},
                  {"data": 1, "expert": 2}, {"data": 1, "seq": 2},
                  {"data": 1, "pipe": 2}, {"data": 1, "data_inner": 2}):
        extra = {"sequence_parallel": {"size": shape["seq"]}} \
            if "seq" in shape else {}
        if "pipe" in shape:
            extra = {"pipeline": {"stages": shape["pipe"]}}
        with pytest.raises(ValueError, match="torch.distributed"):
            dt.initialize(cfg, dict(_config(0, shape["data"]), **extra),
                          device="cpu", mesh=Mesh(shape))
