"""Pipeline parallelism in the port: the mesh's 'pipe' axis, the GPipe and
1F1B schedules, and the engine over pipe 2, data 2 × pipe 2 and pipe 2 ×
model 2 — gloo ranks on the CPU (tests/torch_dp.py) against the JAX
package on ``build_mesh`` of the same shape over the 8-device CPU mesh,
from the same numpy inputs (every case of tests/test_pipeline.py, plus
the capacity MoE at pipe 2, the refusals and checkpoints).

Engine: gpt2-tiny (T 32, vocabulary 256) fp32, Adam 2e-3, clip 1.0, a
global batch of 8 rows a microbatch, 4 microbatches a step (gas 4), 2
steps: losses within 1e-5 relative and parameters within 2e-4 absolute
of the JAX engine on the same mesh (both fp32; gloo and XLA sum in other
orders, and Adam scales a gradient's rounding near zero up to its step,
lr 2e-3, so the bound is a tenth of the step). The schedules as functions: loss within 1e-5 and
every gradient within 2e-4 of ``jax.value_and_grad`` of the JAX GPipe
loss and of the JAX 1F1B. LAMB and Muon at pipe 2 under both schedules
(Muon on Llama, three layers: the padded row stays zero) against the JAX
engine's, Muon's parameters within 1e-3 (``MUON_ATOL``: its
Newton–Schulz is bf16 on both sides). Checkpoints at data 2 × pipe 2 (stage 3, three
layers: the padded four-row stack) cross the packages bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.config import DeepSpeedTPUConfig
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.bloom import bloom_config as j_bloom
from deepspeed_tpu.models.gemma import gemma_config as j_gemma
from deepspeed_tpu.models.gpt import gpt2_config as j_gpt2
from deepspeed_tpu.models.llama import llama3_config as j_llama
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.phi import phi_config as j_phi
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime import model_factory as jmf
from deepspeed_tpu.runtime.pipe import pipeline as jpipe

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.mixtral import mixtral_config
from deepspeed_tpu_torch.parallel.mesh import Mesh
from deepspeed_tpu_torch.runtime import model_factory as tmf
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ, GB, GAS, STEPS = 256, 32, 8, 4, 2
KW = {"max_seq_len": SEQ, "vocab_size": VOCAB}
MOE_KW = {"hidden_size": 128, "intermediate_size": 256, "vocab_size": VOCAB,
          "max_seq_len": SEQ}
#: model name → (the port's preset for the workers, its kwargs)
MODELS = {"gpt2": ("gpt2_config", dict(KW, tie_embeddings=False)),
          "gpt2_l3": ("gpt2_config", dict(KW, num_layers=3)),
          "gpt2_tied": ("gpt2_config", dict(KW, tie_embeddings=True)),
          "bloom": ("bloom_config", KW), "gemma": ("gemma_config", KW),
          "phi": ("phi_config", KW), "mixtral": ("mixtral_config", MOE_KW),
          "llama_l3": ("llama3_config", dict(KW, num_layers=3))}
_JAX_PRESETS = {"gpt2_config": j_gpt2, "bloom_config": j_bloom,
                "gemma_config": j_gemma, "phi_config": j_phi,
                "mixtral_config": j_mixtral, "llama3_config": j_llama}
#: the optimizers whose update is not elementwise: LAMB's trust ratio over
#: each whole leaf (a stage's sums of squares summed over 'pipe'), Muon's
#: Newton–Schulz over each whole matrix (a stage's rows are whole layers)
LAMB = {"type": "lamb", "params": {"lr": 2e-3, "weight_decay": 0.01}}
MUON = {"type": "muon", "params": {"lr": 2e-3, "weight_decay": 0.01,
                                   "adam_eps": 1e-6}}
#: Muon's parameters against the JAX engine: its Newton–Schulz is bf16 on
#: both sides and XLA's products round otherwise than torch's, so half of
#: one step (tests/test_torch_zero_dp.py's MUON_ATOL at this lr)
MUON_ATOL = 1e-3


def _jcfg(name):
    preset, kw = MODELS[name]
    return _JAX_PRESETS[preset]("tiny", **kw)


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jmesh.build_mesh(devices=jax.devices()[:n], **shape)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _padded(params, stages, num_layers):
    """The JAX factory's balanced-partition stack: S·ceil(L/S) rows."""
    rows = -(-num_layers // stages) * stages
    pad = rows - num_layers
    if not pad:
        return params
    out = dict(params)
    out["layers"] = jax.tree.map(
        lambda a: np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                              a.dtype)]), params["layers"])
    return out


def _config(stages, data=1, stage=1, schedule="1f1b", model=1, **extra):
    cfg = {"train_micro_batch_size_per_gpu": GB // data,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "adam", "params": {"lr": 2e-3}},
           "zero_optimization": {"stage": stage},
           "gradient_clipping": 1.0,
           "pipeline": {"stages": stages, "schedule": schedule}}
    if model > 1:
        cfg["tensor_parallel"] = {"enabled": True, "tp_size": model}
    cfg.update(extra)
    return cfg


def _data(seed):
    rng = np.random.default_rng(seed)
    return [[{"input_ids": rng.integers(0, VOCAB, size=(GB, SEQ),
                                        dtype=np.int32)}
             for _ in range(GAS)] for _ in range(STEPS)]


#: the engine cases: name → (model, mesh, config kwargs, data seed); the
#: JAX engine runs each on the same mesh
CASES = {
    "p2_1f1b": ("gpt2", {"pipe": 2}, {}, 0),
    "p2_gpipe": ("gpt2", {"pipe": 2}, {"schedule": "gpipe"}, 0),
    "l3_gpipe": ("gpt2_l3", {"pipe": 2}, {"schedule": "gpipe"}, 11),
    "l3_1f1b": ("gpt2_l3", {"pipe": 2}, {}, 11),
    "tied": ("gpt2_tied", {"pipe": 2}, {}, 13),
    "offload_full": ("gpt2", {"pipe": 2}, {"activation_checkpointing": {
        "policy": "offload_full"}}, 0),
    "bloom": ("bloom", {"pipe": 2}, {}, 1),
    "gemma": ("gemma", {"pipe": 2}, {}, 1),
    "capacity": ("mixtral", {"pipe": 2}, {"moe": {
        "impl": "capacity", "use_rts": False, "capacity_factor": 1.0}}, 4),
    "d2p2_s1": ("gpt2", {"pipe": 2, "data": 2}, {"schedule": "gpipe"}, 6),
    "d2p2_s3": ("gpt2_l3", {"pipe": 2, "data": 2}, {"stage": 3}, 2),
    "p2m2": ("gpt2", {"pipe": 2, "model": 2}, {}, 5),
    "lamb_1f1b": ("gpt2", {"pipe": 2}, {"optimizer": LAMB}, 3),
    "lamb_gpipe": ("gpt2", {"pipe": 2}, {"optimizer": LAMB,
                                         "schedule": "gpipe"}, 3),
    "muon_1f1b": ("llama_l3", {"pipe": 2}, {"optimizer": MUON}, 3),
    "muon_gpipe": ("llama_l3", {"pipe": 2}, {"optimizer": MUON,
                                             "schedule": "gpipe"}, 3),
}
#: the engine cases whose JAX reference is another case's: GPipe's
#: against the JAX 1F1B run of the same model (the two JAX schedules agree
#: to float rounding; the JAX GPipe loss is held below, as a function)
SAME_AS = {"offload_full": "p2_1f1b", "p2_gpipe": "p2_1f1b",
           "l3_gpipe": "l3_1f1b", "lamb_gpipe": "lamb_1f1b",
           "muon_gpipe": "muon_1f1b"}


def _case_config(name):
    model, mesh, kw, _ = CASES[name]
    return _config(mesh["pipe"], mesh.get("data", 1),
                   model=mesh.get("model", 1), **kw)


@pytest.fixture(scope="module")
def inits():
    out = {}
    for name in MODELS:
        cfg = _jcfg(name)
        out[name] = _padded(_np_tree(jtf.init_params(
            cfg, jax.random.PRNGKey(7))), 2, cfg.num_layers)
    # Phi's head bias nonzero, so that a dropped bias changes the loss
    out["phi"]["lm_head_bias"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), out["phi"]["lm_head_bias"].shape))
    return out


def _jax_engine(name, inits, out):
    model, mesh, _, seed = CASES[name]
    _jmesh(mesh)
    je, *_ = deepspeed_tpu.initialize(model=_jcfg(model),
                                      params=inits[model],
                                      config=_case_config(name))
    out[name] = {"losses": [float(je.train_batch(iter(s)))
                            for s in _data(seed)],
                 "params": _np_tree(je.params)}
    return je


def _jax_grads(inits):
    """The JAX GPipe loss under ``jax.value_and_grad`` and the JAX 1F1B,
    on pipe 2, for each gradient case."""
    out = {}
    mesh = _jmesh({"pipe": 2})
    for case in _grad_cases(inits):
        cfg = _jcfg(case["name"])
        p = jax.tree.map(jnp.asarray, case["params"])
        tok, lab = jnp.asarray(case["tokens"]), jnp.asarray(case["labels"])
        lg, gg = jax.jit(lambda q: jax.value_and_grad(
            lambda r: jpipe.pipelined_loss(
                cfg, r, tok, lab, remat_policy="full", mesh=mesh,
                num_stages=2))(q))(p)
        l1, g1 = jax.jit(lambda q: jpipe.pipelined_loss_and_grads_1f1b(
            cfg, q, tok, lab, remat_policy="full", mesh=mesh,
            num_stages=2))(p)
        out[case["name"]] = {"gpipe": (float(lg), _np_tree(gg)),
                             "1f1b": (float(l1), _np_tree(g1))}
    return out


def _run(case, inits, **extra):
    model, _, _, seed = CASES[case]
    return dict({"name": case, "model": MODELS[model],
                 "params": inits[model], "config": _case_config(case),
                 "steps": _data(seed)}, **extra)


def _grad_cases(inits):
    """tests/test_pipeline.py's three gradient cases: gpt2 with its tied
    embedding (M 4, B 8, shifted labels), BLOOM and Phi (M 4, B 2, random
    labels)."""
    out = []
    for name, b, shifted in (("gpt2_tied", 8, True), ("bloom", 2, False),
                             ("phi", 2, False)):
        rng = np.random.default_rng(1)
        tok = rng.integers(0, VOCAB, size=(4, b, SEQ), dtype=np.int32)
        lab = np.concatenate([tok[:, :, 1:], np.full((4, b, 1), -100,
                                                     np.int32)], 2) \
            if shifted else rng.integers(0, VOCAB, size=(4, b, SEQ),
                                         dtype=np.int32)
        out.append({"name": name, "model": MODELS[name],
                    "params": inits[name], "tokens": tok, "labels": lab})
    return out


@pytest.fixture(scope="module")
def runs(inits, tmp_path_factory):
    """The JAX data 2 × pipe 2 run first (its checkpoint is the port's to
    load), then the port's ranks in the background — world 2 over pipe 2
    (the engine cases, forward()'s raise, the schedules as functions),
    world 4 over data 2 × pipe 2 (GPipe at stage 1, 1F1B at stage 3 with
    the checkpoints both ways) and pipe 2 × model 2 — while the other JAX
    references run here."""
    import threading
    root = str(tmp_path_factory.mktemp("pp_ckpt"))
    jax_out = {"dir": root}
    port = {"pdir": root + "/port"}
    saved = jmesh._CURRENT_MESH
    threads = []
    try:
        je = _jax_engine("d2p2_s3", inits, jax_out)
        je.save_checkpoint(root + "/jax")
        jax_out["jax_saved"] = {"params": jax_out["d2p2_s3"]["params"],
                                "opt": _np_tree(je.opt_state)}
        del je
        w2 = [_run(n, inits) for n, (_, mesh, _, _) in CASES.items()
              if mesh == {"pipe": 2}]
        w2.append(_run("p2_1f1b", inits, name="forward_raises",
                       mode="forward_raises"))
        d2p2 = [_run("d2p2_s1", inits),
                _run("d2p2_s3", inits, name="save", mode="save",
                     dir=port["pdir"]),
                _run("d2p2_s3", inits, name="load", mode="load",
                     dir=root + "/jax")]
        w4 = [{"shape": {"pipe": 2, "data": 2}, "runs": d2p2},
              {"shape": {"pipe": 2, "model": 2},
               "runs": [_run("p2m2", inits)]}]
        jobs = {2: ("pp_runs", 2, {"meshes": [{"shape": {"pipe": 2},
                                               "runs": w2}]}),
                "grads": ("pp_grads", 2, {"cases": _grad_cases(inits)}),
                4: ("pp_runs", 4, {"meshes": w4})}

        def job(key, fn, world, kw):
            try:
                port[key] = spawn(fn, world, timeout=300.0, **kw)
            except BaseException as e:          # noqa: BLE001 — re-raised
                port[key] = e
        threads = [threading.Thread(target=job, args=(k,) + v)
                   for k, v in jobs.items()]
        for t in threads:
            t.start()
        for name in CASES:
            if name not in SAME_AS and name != "d2p2_s3":
                _jax_engine(name, inits, jax_out)
        jax_out["grads"] = _jax_grads(inits)
    finally:
        for t in threads:
            t.join()
        jmesh._CURRENT_MESH = saved
    for key in jobs:
        if isinstance(port[key], BaseException):
            raise port[key]
    return {"jax": jax_out, "port": port}


@pytest.fixture(scope="module")
def port(runs):
    return runs["port"]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


@pytest.fixture(scope="module")
def jax_grads(runs):
    return runs["jax"]["grads"]


ENGINE = [n for n in CASES]


@pytest.mark.parametrize("name", ENGINE)
def test_pp_training_matches_jax_engine(port, jax_runs, name):
    """Losses and parameters against the JAX engine on the same mesh;
    every rank reports the same loss; a rank holds its stage's rows of
    each layer leaf."""
    model, mesh, _, _ = CASES[name]
    want = jax_runs[SAME_AS.get(name, name)]
    world = int(np.prod(list(mesh.values())))
    dp, tp = mesh.get("data", 1), mesh.get("model", 1)
    n_rows = _jcfg(model).num_layers + (_jcfg(model).num_layers % 2)
    for r, rr in enumerate(port[world]):
        key = "save" if name == "d2p2_s3" else name
        got = rr[key]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                                   err_msg=f"{name} rank {r}")
        assert got["losses"] == port[world][0][key]["losses"]
        jp, tp_ = _leaves(want["params"]), _leaves(got["params"])
        assert sorted(jp) == sorted(tp_)
        atol = MUON_ATOL if name.startswith("muon") else 2e-4
        for k in jp:
            np.testing.assert_allclose(tp_[k], jp[k], rtol=0, atol=atol,
                                       err_msg=f"{name} {k} rank {r}")
        assert got["coords"] == {"pipe": r // (dp * tp),
                                 "data": (r // tp) % dp, "model": r % tp}
        assert {s[0] for s in got["local_layers"]} == {n_rows // 2}
        assert np.isfinite(got["eval"])
        assert got["eval"] == port[world][0][key]["eval"]


def test_pp_padded_stack_and_offload_full(port, inits):
    """Three layers over two stages hold four rows (the last a zero row
    that stays zero: its gradients are exactly zero); offload_full
    reproduces the plain pipeline's losses (the host round trip changes
    residency, never math)."""
    for rr in port[2]:
        # LAMB and Muon too: a zero row's moments and momentum stay zero,
        # so does its update (Newton–Schulz of zeros is zero)
        for name in ("l3_gpipe", "l3_1f1b", "muon_1f1b", "muon_gpipe"):
            p = rr[name]["params"]["layers"]
            for k, v in _leaves(p).items():
                assert v.shape[0] == 4, k
                assert not v[3].any(), (name, k)
        np.testing.assert_allclose(rr["offload_full"]["losses"],
                                   rr["p2_1f1b"]["losses"], rtol=1e-5)
    # the JAX tree's padded rows pass through the converter as they are
    got = params_from_jax(inits["gpt2_l3"], "cpu")
    assert got["layers"]["attn"]["wq"].shape[0] == 4


def test_pp_hops_carry_the_schedule_bytes(port):
    """Each rank's sends in a step: stage 0 sends M blocks forward,
    stage 1 sends M gradients back ([B, T, d] fp32 each way)."""
    d = dt.gpt2_config("tiny", **KW).hidden_size
    block = GB * SEQ * d * 4
    for name in ("p2_1f1b", "p2_gpipe"):
        for rr in port[2]:
            assert rr[name]["sent"] == GAS * block * STEPS, (name, rr[name])


def test_pp_forward_raises(port):
    for rr in port[2]:
        assert "pipeline" in rr["forward_raises"]


# ---------------------------------------------------------------------------
# the schedules as functions
# ---------------------------------------------------------------------------

GRADS = [(m, s) for m in ("gpt2_tied", "bloom", "phi")
         for s in ("gpipe", "1f1b")]


@pytest.mark.parametrize("model,schedule", GRADS,
                         ids=[f"{m}-{s}" for m, s in GRADS])
def test_pp_schedule_grads_match_jax(port, jax_grads, model, schedule):
    """GPipe's autograd and 1F1B's explicit backward against the JAX
    functions: the loss and every leaf's gradient (BLOOM's embed norm
    and Phi's head bias among them), on both ranks; 1F1B's gradients
    against the port's GPipe's."""
    want_loss, want = jax_grads[model][schedule]
    wl = _leaves(want)
    for r, rr in enumerate(port["grads"]):
        got = rr[model][schedule]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        gl = _leaves(got["grads"])
        assert sorted(gl) == sorted(wl)
        for k in wl:
            np.testing.assert_allclose(gl[k], wl[k], rtol=2e-4, atol=2e-4,
                                       err_msg=f"{model} {k} rank {r}")
        other = _leaves(rr[model]["gpipe"]["grads"])
        for k in gl:
            np.testing.assert_allclose(gl[k], other[k], rtol=2e-4,
                                       atol=2e-4, err_msg=k)
    if model == "phi":
        assert np.abs(wl["lm_head_bias"]).max() > 0


# ---------------------------------------------------------------------------
# checkpoints at data 2 × pipe 2
# ---------------------------------------------------------------------------

def test_jax_save_loads_into_the_port_at_data2_pipe2(port, jax_runs):
    want = jax_runs["jax_saved"]
    for r, rr in enumerate(port[4]):
        got = rr["load"]
        assert got["tag"] == f"global_step{STEPS}"
        gl = _leaves(got["params"])
        for k, v in _leaves(want["params"]).items():
            np.testing.assert_array_equal(gl[k], v, err_msg=f"{k} {r}")
        for key in ("exp_avg", "exp_avg_sq"):
            gl = _leaves(got["opt"][key])
            for k, v in _leaves(want["opt"][key]).items():
                np.testing.assert_array_equal(gl[k], v, err_msg=k)


def test_port_save_loads_into_jax_at_data2_pipe2(port, inits):
    """Each stage's rows written by its ranks, the leaves every stage
    holds by pipe rank 0 only; the JAX store reads them bitwise."""
    saved = jmesh._CURRENT_MESH
    try:
        _jmesh({"pipe": 2, "data": 2})
        jl, *_ = deepspeed_tpu.initialize(
            model=_jcfg("gpt2_l3"), config=_case_config("d2p2_s3"),
            params=jax.tree.map(np.zeros_like, inits["gpt2_l3"]))
        tag, _ = jl.load_checkpoint(port["pdir"])
        loaded = {"params": _np_tree(jl.params),
                  "opt": _np_tree(jl.opt_state)}
    finally:
        jmesh._CURRENT_MESH = saved
    assert tag == f"global_step{STEPS}"
    want = port[4][0]["save"]
    for k, v in _leaves(want["params"]).items():
        np.testing.assert_array_equal(_leaves(loaded["params"])[k], v,
                                      err_msg=k)
    for key in ("exp_avg", "exp_avg_sq"):
        for k, v in _leaves(want["opt"][key]).items():
            np.testing.assert_array_equal(_leaves(loaded["opt"][key])[k], v,
                                          err_msg=k)


# ---------------------------------------------------------------------------
# specs, the schedule key and the refusals (no process group)
# ---------------------------------------------------------------------------

def _tuple_tree(tree):
    if isinstance(tree, dict):
        return {k: _tuple_tree(v) for k, v in tree.items()}
    return tuple(tree)


SPECS = [("gpt2", 0, False), ("gpt2", 3, False), ("llama", 3, True),
         ("llama", 0, True)]


@pytest.mark.parametrize("model,stage,tp", SPECS,
                         ids=[f"{m}-s{s}-tp{int(t)}" for m, s, t in SPECS])
def test_pp_partition_specs_match_jax(model, stage, tp):
    """'pipe' on dim 0 of every layer leaf; under TP the embedding and
    the head whole (model_factory.py:431-445): the port's spec tree is
    the JAX factory's."""
    base = {"train_micro_batch_size_per_gpu": 1,
            "zero_optimization": {"stage": stage},
            "pipeline": {"stages": 2}}
    if tp:
        base["tensor_parallel"] = {"enabled": True, "tp_size": 2}
    jc = (j_llama if model == "llama" else j_gpt2)("tiny", **KW)
    tc = (dt.llama3_config if model == "llama" else dt.gpt2_config)(
        "tiny", **KW)
    want = jmf.decoder_model_spec(
        jc, DeepSpeedTPUConfig.from_any(base)).partition_specs
    got = tmf.decoder_model_spec(
        tc, DeepSpeedConfig.from_any(base)).partition_specs
    assert got == _tuple_tree(want)
    assert got["layers"]["attn"]["wq"][0] == "pipe"
    base_specs = ttf.partition_specs(tc, stage, tp=tp)
    assert got["embed"]["tokens"] == tuple(
        None if a == "model" else a for a in base_specs["embed"]["tokens"])


def test_pp_schedule_config():
    """schedule 'gpipe' leaves no 1F1B function; another value raises the
    JAX ValueError."""
    model = dt.gpt2_config("tiny", **KW)
    base = {"train_micro_batch_size_per_gpu": 1,
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}}}
    spec = tmf.decoder_model_spec(model, DeepSpeedConfig.from_any(
        {**base, "pipeline": {"stages": 2}}))
    assert spec.pipeline_grad_fn is not None
    spec = tmf.decoder_model_spec(model, DeepSpeedConfig.from_any(
        {**base, "pipeline": {"stages": 2, "schedule": "gpipe"}}))
    assert spec.pipeline_grad_fn is None and spec.pipeline_loss_fn is not None
    assert tmf.decoder_model_spec(model, DeepSpeedConfig.from_any(
        base)).pipeline_loss_fn is None
    bad = {**base, "pipeline": {"stages": 2, "schedule": "wat"}}
    with pytest.raises(ValueError) as want:
        jmf.decoder_model_spec(j_gpt2("tiny", **KW),
                               DeepSpeedTPUConfig.from_any(bad))
    with pytest.raises(ValueError) as got:
        tmf.decoder_model_spec(model, DeepSpeedConfig.from_any(bad))
    assert str(got.value) == str(want.value)
    cfg = DeepSpeedConfig.from_any({**base, "pipeline": {
        "stages": 2, "partition_method": "uniform", "micro_batches": 4,
        "activation_checkpoint_interval": 1}})
    assert cfg.pipeline.micro_batches == 4


def _jdec(name):
    from deepspeed_tpu.models import bert, gptneo
    return {"bert": bert.bert_config("tiny"),
            "gptneo": gptneo.gptneo_config("tiny"),
            "dropless": j_mixtral("tiny", **MOE_KW)}[name]


def _tdec(name):
    return {"bert": dt.bert_config("tiny"),
            "gptneo": dt.gptneo_config("tiny"),
            "dropless": mixtral_config("tiny", **MOE_KW)}[name]


REFUSED = ["bert", "gptneo", "dropless"]


@pytest.mark.parametrize("model", REFUSED)
def test_pp_factory_raises_the_jax_value_errors(model):
    """Encoders, per-layer windows and the dropless MoE under a pipeline:
    the JAX factory's ValueError, word for word."""
    conf = {"train_micro_batch_size_per_gpu": 1, "pipeline": {"stages": 2}}
    if model == "dropless":
        conf["moe"] = {"impl": "dropless"}
    with pytest.raises(ValueError) as want:
        jmf.decoder_model_spec(_jdec(model),
                               DeepSpeedTPUConfig.from_any(conf))
    with pytest.raises(ValueError) as got:
        tmf.decoder_model_spec(_tdec(model), DeepSpeedConfig.from_any(conf))
    assert str(got.value) == str(want.value)


def test_pp_engine_refusals():
    """PP + SP raises the JAX ValueError; offload_optimizer and the
    parameter tier under a pipeline raise theirs; a pipe mesh needs
    pipeline.stages of its size and torch.distributed."""
    cfg = dt.gpt2_config("tiny", **KW)
    with pytest.raises(ValueError) as want:
        deepspeed_tpu.initialize(model=j_gpt2("tiny", **KW), config={
            "train_micro_batch_size_per_gpu": 1, "pipeline": {"stages": 2},
            "sequence_parallel": {"size": 2}}, rng=jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as got:
        dt.initialize(cfg, {"train_micro_batch_size_per_gpu": 1,
                            "pipeline": {"stages": 2},
                            "sequence_parallel": {"size": 2}}, device="cpu")
    # the port's config validator raises it (inside pydantic's error)
    assert "does not compose" in str(want.value)
    assert str(want.value) in str(got.value)
    p2 = {"train_micro_batch_size_per_gpu": 1, "pipeline": {"stages": 2}}
    with pytest.raises(ValueError, match="bypass the pipeline schedule"):
        dt.initialize(cfg, dict(p2, zero_optimization={
            "stage": 2, "offload_optimizer": {"device": "cpu"}}),
            device="cpu", mesh=Mesh({"pipe": 2}))
    with pytest.raises(ValueError, match="pipeline/sequence parallelism"):
        dt.initialize(cfg, dict(p2, zero_optimization={
            "stage": 2, "offload_optimizer": {"device": "nvme",
                                              "nvme_path": "/nonexistent"},
            "offload_param": {"device": "nvme",
                              "nvme_path": "/nonexistent"}}),
            device="cpu", mesh=Mesh({"pipe": 2}))
    with pytest.raises(ValueError, match="pipeline.stages is 1"):
        dt.initialize(cfg, {"train_micro_batch_size_per_gpu": 1},
                      device="cpu", mesh=Mesh({"pipe": 2}))
    with pytest.raises(ValueError, match="torch.distributed"):
        dt.initialize(cfg, p2, device="cpu", mesh=Mesh({"pipe": 2}))
