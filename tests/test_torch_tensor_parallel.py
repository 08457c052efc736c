"""Tensor parallelism in the port: the mesh's 'model' axis, AutoTP's
specs, ``partition_specs(tp=True)`` and the engine on data × model (gloo
ranks on the CPU, tests/torch_dp.py) against ``deepspeed_tpu.initialize``
on ``build_mesh(data=d, model=m)`` of the same shape, from one numpy
parameter tree.

Training runs on tests/test_engine.py's gpt2-tiny fp32 setup (Adam, clip
1.0) at model 2 and at data 2 × model 2: ZeRO stages 0-3 and stage 3
with overlap_comm, gas 2, a batch whose rows ignore different numbers of
labels; and a Llama tree with one kv head (kv_heads % tp !=
0: k and v are gathered over 'model' after their projection) and one
whose MLP width does not divide by tp (replicated, one warning; the JAX
engine cannot place such a dim, ROADMAP C4, so its reference runs the
same mesh without the 'model' specs).

Tolerances: losses within 1e-5 relative over 4 steps, parameters within
1e-4 absolute (both sides fp32; a row-parallel all-reduce sums tp
partial products in another order than one GEMM, and gloo's ring sums in
another order than XLA).
"""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.gemma import gemma_config as j_gemma
from deepspeed_tpu.models.gpt import gpt2_config as j_gpt2
from deepspeed_tpu.models.llama import llama3_config as j_llama
from deepspeed_tpu.module_inject import autotp_specs as j_autotp
from deepspeed_tpu.parallel import mesh as jmesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.module_inject import autotp_specs
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ, GB, STEPS = 512, 32, 8, 4
GPT2 = ("gpt2_config", {"max_seq_len": SEQ, "vocab_size": VOCAB})
GQA_KW = {"max_seq_len": SEQ, "vocab_size": VOCAB, "num_kv_heads": 1}
ODD_KW = {"max_seq_len": SEQ, "vocab_size": VOCAB, "intermediate_size": 93}
GQA = ("llama3_config", GQA_KW)
ODD = ("llama3_config", ODD_KW)
SHAPES = [(1, 2), (2, 2)]


def _data(steps, seed=0, gas=1):
    rng = np.random.default_rng(seed)
    return [[{"input_ids": rng.integers(0, VOCAB, size=(GB, SEQ),
                                        dtype=np.int32)}
             for _ in range(gas)] for _ in range(steps)]


def _uneven(steps, seed=3):
    out = []
    for step in _data(steps, seed):
        tok = step[0]["input_ids"]
        lab = np.concatenate([tok[:, 1:], np.full((GB, 1), -100)], 1)
        lab[:GB // 2, 8:] = -100
        out.append([{"input_ids": tok, "labels": lab.astype(np.int32)}])
    return out


def _config(stage, data, model, gas=1, zero=None, remat="none", tp=None):
    return {"activation_checkpointing": {"policy": remat},
            "train_micro_batch_size_per_gpu": GB // data,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adam",
                          "params": {"lr": 1e-3, "betas": [0.9, 0.999]}},
            "zero_optimization": dict({"stage": stage}, **(zero or {})),
            "gradient_clipping": 1.0,
            "tensor_parallel": {"tp_size": model if tp is None else tp}}


#: name → (model, stage, gas, zero extras, data, JAX reference run)
RUNS = {
    "s0": (GPT2, 0, 1, None, _data(STEPS), "s0"),
    "s1": (GPT2, 1, 1, None, _data(STEPS), "s0"),
    "s2": (GPT2, 2, 1, None, _data(STEPS), "s0"),
    "s3": (GPT2, 3, 1, None, _data(STEPS), "s3"),
    "s3_overlap": (GPT2, 3, 1, {"overlap_comm": True, "overlap_prefetch": 2},
                   _data(STEPS), "s3"),
    "gas2_s3": (GPT2, 3, 2, None, _data(STEPS, seed=5, gas=2), "gas2"),
    "uneven_s2": (GPT2, 2, 1, None, _uneven(STEPS), "uneven"),
    # the stage-3 loop saves activations and re-gathers only weights;
    # under remat 'full' a block's forward runs twice, as in JAX
    "s3_remat_full": (GPT2, 3, 1, {"overlap_comm": True}, _data(STEPS),
                      "remat"),
}
#: Llama runs: (model, stage, data)
LLAMA = {"gqa_s0": (GQA, 0, _data(STEPS, seed=7)),
            "odd_mlp_s0": (ODD, 0, _data(STEPS, seed=8))}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _jcfg(spec):
    preset, kw = spec
    return {"gpt2_config": j_gpt2, "llama3_config": j_llama}[preset](
        "tiny", **kw)


@pytest.fixture(scope="module")
def init():
    return {spec[0] + str(sorted(spec[1].items())): _np_tree(jtf.init_params(
        _jcfg(spec), jax.random.PRNGKey(0))) for spec in (GPT2, GQA, ODD)}


def _key(spec):
    return spec[0] + str(sorted(spec[1].items()))


@pytest.fixture(scope="module")
def jax_runs(init):
    """The JAX engine on build_mesh(data=d, model=m) of each shape."""
    saved = jmesh._CURRENT_MESH
    out = {}
    try:
        for d, m in SHAPES:
            jmesh.build_mesh(data=d, model=m, devices=jax.devices()[:d * m])
            refs = {"s0": (GPT2, 0, 1, RUNS["s0"][4]),
                    "s3": (GPT2, 3, 1, RUNS["s3"][4]),
                    "gas2": (GPT2, 0, 2, RUNS["gas2_s3"][4]),
                    "uneven": (GPT2, 0, 1, RUNS["uneven_s2"][4]),
                    "remat": (GPT2, 0, 1, RUNS["s0"][4])}
            refs.update({k: (spec, st, 1, data)
                         for k, (spec, st, data) in LLAMA.items()})
            for name, (spec, stage, gas, data) in refs.items():
                je, *_ = deepspeed_tpu.initialize(
                    model=_jcfg(spec), config=_config(
                        stage, d, m, gas,
                        remat="full" if name == "remat" else "none",
                        # the JAX engine cannot place an indivisible
                        # 'model' dim (C4): its reference replicates
                        tp=1 if name == "odd_mlp_s0" else None),
                    params=init[_key(spec)])
                losses = [float(je.train_batch(iter(s))) for s in data]
                out[(d, m, name)] = {"losses": losses,
                                     "params": _np_tree(je.params)}
    finally:
        jmesh._CURRENT_MESH = saved
    return out


@pytest.fixture(scope="module", params=SHAPES, ids=["tp2", "dp2xtp2"])
def port(request, init):
    d, m = request.param
    runs = [{"name": name, "model": spec, "params": init[_key(spec)],
             "config": _config(stage, d, m, gas, zero, remat="full"
                               if "remat" in name else "none"),
             "steps": data}
            for name, (spec, stage, gas, zero, data, _) in RUNS.items()]
    runs += [{"name": name, "model": spec, "params": init[_key(spec)],
              "config": _config(stage, d, m), "steps": data}
             for name, (spec, stage, data) in LLAMA.items()]
    # the same math with the sequence split over 'seq' (seq 2 × model
    # d·m/2: Ulysses under TP on four ranks), held against the s0 run
    runs.append({"name": "seq", "model": GPT2, "params": init[_key(GPT2)],
                 "config": dict(_config(0, 1, d * m // 2),
                                sequence_parallel={"size": 2}),
                 "steps": RUNS["s0"][4],
                 "mesh": {"seq": 2, "model": d * m // 2}})
    return d, m, spawn("tp_engine_runs", d * m, data=d, model=m, runs=runs)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _check(got, want, name):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               err_msg=name)
    jp, tp = _leaves(want["params"]), _leaves(got["params"])
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-4,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tp_training_matches_jax_engine(port, jax_runs, name):
    d, m, res = port
    want = jax_runs[(d, m, RUNS[name][5])]
    for r, rr in enumerate(res):
        _check(rr[name], want, f"{name} rank {r}")
        assert rr[name]["losses"] == res[0][name]["losses"]
        assert rr[name]["coords"] == (r // m, r % m)


@pytest.mark.parametrize("name", sorted(LLAMA))
def test_tp_indivisible_heads_and_widths(port, jax_runs, name):
    d, m, res = port
    for r in res:
        _check(r[name], jax_runs[(d, m, name)], name)


def test_tp_ranks_hold_model_shards(port, jax_runs):
    """Column leaves hold 1/tp of their output dim, row leaves of their
    input dim, the vocabulary 1/tp of its rows; norms stay whole."""
    d, m, res = port
    r0 = res[0]["s0"]
    full = _leaves(r0["params"])
    n_sharded = 0
    for (path, x), local, md in zip(full.items(), r0["local"], r0["mdim"]):
        shape = list(x.shape)
        if md is not None:
            shape[md] //= m
            n_sharded += 1
        assert tuple(shape) == tuple(local), path
        if path.endswith("scale") or path.endswith("bias") and \
                "attn/b" not in path and "mlp/bi" not in path:
            assert md is None, path
    assert n_sharded >= 7
    for r, rr in enumerate(res):
        _check(rr["seq"], jax_runs[(d, m, "s0")], f"seq rank {r}")
        assert rr["seq"]["coords"] == (0, r % (d * m // 2))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _as_tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("stage", [0, 3])
@pytest.mark.parametrize("preset", ["llama3_config", "gpt2_config",
                                    "gemma_config"])
def test_partition_specs_tp_equal_jax(preset, stage):
    jfn = {"llama3_config": j_llama, "gpt2_config": j_gpt2,
           "gemma_config": j_gemma}[preset]
    want = jtf.partition_specs(jfn("tiny"), zero_stage=stage, tp=True)
    got = ttf.partition_specs(getattr(dt, preset)("tiny"),
                              zero_stage=stage, tp=True)
    jl = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda s: isinstance(s, P))[0]
    flat = {"/".join(str(k.key) for k in path): _as_tuple(s)
            for path, s in jl}
    got_flat = {k: tuple(v) for k, v in _leaves_spec(got).items()}
    assert sorted(flat) == sorted(got_flat)
    for k in flat:
        jt = flat[k] + (None,) * (len(got_flat[k]) - len(flat[k]))
        assert jt == got_flat[k], k
    assert any("model" in s for s in got_flat.values())


def _leaves_spec(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves_spec(v, p))
        else:
            out[p] = v
    return out


def _hf_like(mk):
    """tests/test_autotp_launcher.py's HF-like tree."""
    return {
        "model": {
            "embed_tokens": {"weight": mk(128, 32)},
            "layers": {
                "0": {
                    "self_attn": {"q_proj": {"weight": mk(32, 32)},
                                  "o_proj": {"weight": mk(32, 32)}},
                    "mlp": {"gate_proj": {"weight": mk(32, 64)},
                            "down_proj": {"weight": mk(64, 32)}},
                    "input_layernorm": {"weight": mk(32)},
                },
            },
        },
        "lm_head": {"weight": mk(128, 32)},
    }


@pytest.mark.parametrize("fsdp", [None, ("data", "data_inner", "expert")])
def test_autotp_classification_equals_jax(fsdp):
    """tests/test_autotp_launcher.py:50-70: the same specs for the same
    tree, at tp 2 with and without FSDP axes."""
    import jax.numpy as jnp
    want = j_autotp(_hf_like(lambda *s: jnp.zeros(s)), tp_size=2,
                    fsdp_axes=fsdp)
    got = autotp_specs(_hf_like(lambda *s: np.zeros(s, np.float32)),
                       tp_size=2, fsdp_axes=fsdp)
    jl = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda s: isinstance(s, P))[0]
    flat = {"/".join(str(k.key) for k in path): tuple(s) for path, s in jl}
    got_flat = _leaves_spec(got)
    assert sorted(flat) == sorted(got_flat)
    for k in flat:
        assert flat[k] == tuple(got_flat[k]), k
    l0 = got["model"]["layers"]["0"]
    if fsdp is None:
        assert l0["self_attn"]["q_proj"]["weight"] == (None, "model")
        assert l0["self_attn"]["o_proj"]["weight"] == ("model", None)
        assert got["model"]["embed_tokens"]["weight"] == ("model", None)
        assert l0["input_layernorm"]["weight"] == ()


def test_autotp_indivisible_replicates_with_warning(monkeypatch):
    import jax.numpy as jnp
    from deepspeed_tpu_torch.module_inject import auto_tp
    want = j_autotp({"q_proj": {"weight": jnp.zeros((32, 30))}}, tp_size=4)
    said = []
    monkeypatch.setattr(auto_tp.logger, "warning", said.append)
    got = autotp_specs({"q_proj": {"weight": np.zeros((32, 30),
                                                      np.float32)}},
                       tp_size=4)
    assert tuple(want["q_proj"]["weight"]) == got["q_proj"]["weight"] == ()
    assert len(said) == 1 and "not divisible by tp=4" in said[0]


INIT_MODEL = ("llama3_config", {"max_seq_len": SEQ, "vocab_size": VOCAB})


@pytest.fixture(scope="module")
def tp_init():
    return spawn("tp_model_init_ranks", 2, model=INIT_MODEL,
                 config=_config(0, 1, 2), steps=_data(STEPS, seed=9))


def test_tp_model_init(tp_init):
    """tests/test_config.py:131 at model 2: params born as this rank's
    'model' blocks of the full draw (wq column, wo row, the vocabulary
    rows of the embedding), in the asked dtype; a conflicting live mesh
    is refused and stays."""
    for r, rr in enumerate(tp_init):
        assert rr["model_axis"] == rr["still"] == 2
        assert "live mesh" in rr["refused"]
        assert rr["wq_dtype"] == "torch.bfloat16"
        assert rr["p16_dtype"] == "torch.float16"
        full, got = rr["full"]["layers"]["attn"], rr["params"]["layers"][
            "attn"]
        n = full["wq"].shape[-1] // 2
        np.testing.assert_array_equal(got["wq"],
                                      full["wq"][..., r * n:(r + 1) * n])
        k = full["wo"].shape[1] // 2
        np.testing.assert_array_equal(got["wo"],
                                      full["wo"][:, r * k:(r + 1) * k])
        np.testing.assert_array_equal(rr["params"]["layers"]["ln1"]["scale"],
                                      rr["full"]["layers"]["ln1"]["scale"])
        v = rr["full"]["embed"]["tokens"].shape[0] // 2
        np.testing.assert_array_equal(rr["params"]["embed"]["tokens"],
                                      rr["full"]["embed"]["tokens"][
                                          r * v:(r + 1) * v])


def test_tp_model_init_trains_like_jax_engine(tp_init):
    """``initialize`` takes tp_model_init's shards as they are: 4 steps
    at model 2 match the JAX engine on build_mesh(model=2) started from
    the same full fp32 tree (the port's draw, seed 0)."""
    import torch
    cfg = dt.llama3_config("tiny", **INIT_MODEL[1])
    full = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    init = jax.tree.map(lambda t: t.numpy(), full)
    saved = jmesh._CURRENT_MESH
    try:
        jmesh.build_mesh(model=2, devices=jax.devices()[:2])
        je, *_ = deepspeed_tpu.initialize(
            model=_jcfg(INIT_MODEL), config=_config(0, 1, 2), params=init)
        want = {"losses": [float(je.train_batch(iter(s)))
                           for s in _data(STEPS, seed=9)],
                "params": _np_tree(je.params)}
    finally:
        jmesh._CURRENT_MESH = saved
    for r, rr in enumerate(tp_init):
        _check(rr["trained"], want, f"tp_model_init rank {r}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("preset", ["gpt2_config", "llama3_config"])
def test_init_params_tp_blocks_equal_full_draw(monkeypatch, preset, tp):
    """init_params(tp=(tp, rank)) keeps each rank's block of every leaf of
    the full draw, bit for bit, with draw slices that cross the blocks
    (a few rows a slice)."""
    import torch
    monkeypatch.setattr(ttf, "INIT_SLICE_VALUES", 3 * 64)
    cfg = getattr(dt, preset)("tiny", max_seq_len=SEQ, vocab_size=VOCAB)
    full = ttf.init_params(cfg, torch.Generator().manual_seed(3),
                           torch.bfloat16, "cpu")
    specs = ttf.tp_specs(cfg, full, tp)
    for rank in range(tp):
        got = ttf.init_params(cfg, torch.Generator().manual_seed(3),
                              torch.bfloat16, "cpu", tp=(tp, rank))
        want = ttf.shard_model_axis(full, specs, tp, rank)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree.leaves(want)):
            assert torch.equal(g, w), (path, rank)
