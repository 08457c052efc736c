"""Sequence parallelism in the port: the mesh's 'seq' axis, Ulysses and
ring attention, and the engine over data × seq and model × seq — gloo
ranks on the CPU (tests/torch_dp.py) against the JAX package on
``build_mesh`` of the same shape over the 8-device CPU mesh, from the same
numpy inputs.

Attention: tests/test_sequence_parallel.py's shapes (B 2, T 64, D 16, the
uneven head counts of :65-93), each rank given its block of the sequence
(and of the heads under 'model'); its output block and the gradients of
the global sum(out²) against ``distributed_attention`` /
``ring_attention`` and ``jax.grad`` of the same loss, within 2e-5 (values)
and 5e-5 (gradients), the JAX file's tolerances. One Ulysses case runs
the JAX ``attention_impl`` 'pallas_flash' path (``flash_attention_sharded``,
its Pallas kernel in interpret mode: T 256, head dim 64).

Training: llama3-tiny (T 64, vocabulary 256) fp32, Adam 1e-3, a global
batch of 8 rows, 3 steps, at data 1 × seq 2 (Ulysses and ring), data 2 ×
seq 2 (stages 1 and 3) and model 2 × seq 2 (Ulysses under TP): losses
within 1e-5 relative and parameters within 1e-4 absolute of the JAX
engine (both fp32; gloo and XLA sum in other orders). Checkpoints at data
2 × seq 2 cross the packages bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.config import DeepSpeedTPUConfig
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.llama import llama3_config as j_llama
from deepspeed_tpu.ops.flash_attention import flash_attention_sharded
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel import ulysses as jul
from deepspeed_tpu.parallel.ring import ring_attention as j_ring
from deepspeed_tpu.runtime import model_factory as jmf

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models.mixtral import mixtral_config
from deepspeed_tpu_torch.parallel import ulysses as tul
from deepspeed_tpu_torch.parallel.mesh import Mesh
from deepspeed_tpu_torch.runtime import model_factory as tmf
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, T, D = 2, 64, 16
VOCAB, GB, STEPS = 256, 8, 3
LLAMA = ("llama3_config", {"max_seq_len": T, "vocab_size": VOCAB})


def _qkv(seed, h, kvh, t=T, d=D, b=B):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, n, d)).astype(np.float32)
            for n in (h, kvh, kvh)]


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jmesh.build_mesh(devices=jax.devices()[:n], **shape)


# ---------------------------------------------------------------------------
# _even_heads
# ---------------------------------------------------------------------------

#: tests/test_sequence_parallel.py:65-93: (q heads, kv heads, mesh)
UNEVEN = [(8, 2, dict(data=2, seq=4)), (8, 2, dict(data=2, seq=2, model=2)),
          (2, 2, dict(data=2, seq=2, model=2)), (6, 6, dict(data=2, seq=4)),
          (8, 4, dict(data=1, seq=8)), (6, 2, dict(data=1, seq=4))]


@pytest.mark.parametrize("h,kvh,topo", UNEVEN,
                         ids=[f"{h}q{k}kv-{'x'.join(map(str, t.values()))}"
                              for h, k, t in UNEVEN])
def test_even_heads_equals_jax(h, kvh, topo):
    """The padded / replicated heads over the head extent model × seq,
    bitwise, and the same None where no exact layout exists."""
    total = topo["seq"] * topo.get("model", 1)
    q, k, v = _qkv(11, h, kvh)
    want = jul._even_heads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           total)
    got = tul._even_heads(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), total)
    assert (got is None) == (want is None)
    if want is None:
        return
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == want[3]


# ---------------------------------------------------------------------------
# Ulysses and ring attention
# ---------------------------------------------------------------------------

#: name → (fn, mesh, q heads, kv heads, causal, seed); world 2 and world 4
ATTN = {
    2: {"ulysses_s2": ("ulysses", {"data": 1, "seq": 2}, 8, 4, True, 0),
        "ulysses_s2_mha": ("ulysses", {"data": 1, "seq": 2}, 6, 6, True, 1),
        "ring_s2": ("ring", {"data": 1, "seq": 2}, 8, 4, True, 2),
        "ring_s2_noncausal": ("ring", {"data": 1, "seq": 2}, 8, 4, False,
                              3)},
    4: {"ulysses_s4": ("ulysses", {"data": 1, "seq": 4}, 8, 4, True, 4),
        "ulysses_s4_kv2": ("ulysses", {"data": 1, "seq": 4}, 8, 2, True, 5),
        "ulysses_s4_pad": ("ulysses", {"data": 1, "seq": 4}, 6, 6, True, 6),
        "ulysses_s4_replicated": ("ulysses", {"data": 1, "seq": 4}, 6, 2,
                                  True, 7),
        "ulysses_m2s2": ("ulysses", {"data": 1, "seq": 2, "model": 2}, 8, 2,
                         True, 8),
        "ring_s4": ("ring", {"data": 1, "seq": 4}, 8, 4, True, 9),
        "ring_s4_mha": ("ring", {"data": 1, "seq": 4}, 8, 8, True, 10),
        "ring_s4_noncausal": ("ring", {"data": 1, "seq": 4}, 8, 4, False,
                              11)},
}
#: the 'pallas_flash' case: T 256, head dim 64 take the Pallas kernel
PALLAS = ("pallas_s2", {"data": 1, "seq": 2}, 4, 2, 1, 256, 64, 12)


def _attn_cases(world):
    cases = []
    for name, (fn, mesh, h, kvh, causal, seed) in ATTN[world].items():
        q, k, v = _qkv(seed, h, kvh)
        cases.append({"name": name, "fn": fn, "mesh": mesh, "q": q, "k": k,
                      "v": v, "causal": causal})
    if world == 2:
        name, mesh, h, kvh, b, t, d, seed = PALLAS
        q, k, v = _qkv(seed, h, kvh, t, d, b)
        cases.append({"name": name, "fn": "ulysses", "mesh": mesh, "q": q,
                      "k": k, "v": v, "causal": True})
    return cases


@pytest.fixture(scope="module")
def attn_ranks():
    return {w: spawn("sp_attention", w, cases=_attn_cases(w))
            for w in (2, 4)}


def _jax_attention(case):
    """The JAX function's output and the gradients of sum(out²)."""
    if case["name"].startswith("pallas"):
        def fn(a, b, c):
            return flash_attention_sharded(a, b, c, causal=True)
    elif case["fn"] == "ring":
        def fn(a, b, c):
            return j_ring(a, b, c, causal=case["causal"])
    else:
        def fn(a, b, c):
            return jul.distributed_attention(a, b, c, causal=case["causal"])
    saved = jmesh._CURRENT_MESH
    try:
        _jmesh(case["mesh"])
        args = [jnp.asarray(case[x]) for x in ("q", "k", "v")]
        out = jax.jit(fn)(*args)
        grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                                 argnums=(0, 1, 2)))(*args)
    finally:
        jmesh._CURRENT_MESH = saved
    return np.asarray(out), [np.asarray(g) for g in grads]


ATTN_CASES = [(w, c["name"]) for w in (2, 4) for c in _attn_cases(w)]


@pytest.mark.parametrize("world,name", ATTN_CASES,
                         ids=[n for _, n in ATTN_CASES])
def test_sp_attention_matches_jax(attn_ranks, world, name):
    case = next(c for c in _attn_cases(world) if c["name"] == name)
    out, grads = _jax_attention(case)
    mesh = case["mesh"]
    sp, tp = mesh["seq"], mesh.get("model", 1)
    tl = out.shape[1] // sp
    for r, rr in enumerate(attn_ranks[world]):
        got = rr[name]
        _, s, m = got["coords"]
        assert (s, m) == ((r // tp) % sp, r % tp)

        def mine(a):
            h = a.shape[2] // tp
            return a[:, s * tl:(s + 1) * tl, m * h:(m + 1) * h]
        np.testing.assert_allclose(got["out"], mine(out), rtol=2e-5,
                                   atol=2e-5, err_msg=f"{name} rank {r}")
        for g, key in zip(grads, ("dq", "dk", "dv")):
            np.testing.assert_allclose(got[key], mine(g), rtol=5e-5,
                                       atol=5e-5,
                                       err_msg=f"{name} {key} rank {r}")
        # the comms logger: the JAX records of one call (the global q's
        # bytes once; the global k and v × (sp - 1))
        q = case["q"]
        if case["fn"] == "ring":
            want = {"ppermute": 2 * case["k"].nbytes * (sp - 1)}
        elif name.endswith("replicated"):
            want = {"all_gather": 2 * case["k"].nbytes // tp // sp}
        else:
            want = {"all_to_all": None}
        got_log = got["logged"]
        assert set(got_log) == set(want), got_log
        if "all_to_all" in want:
            evened = jul._even_heads(jnp.asarray(q), jnp.asarray(case["k"]),
                                     jnp.asarray(case["v"]), sp * tp)
            assert got_log["all_to_all"] == evened[0].size * 4
        else:
            assert got_log == want, got_log


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _data(seed):
    rng = np.random.default_rng(seed)
    return [[{"input_ids": rng.integers(0, VOCAB, size=(GB, T),
                                        dtype=np.int32)}]
            for _ in range(STEPS)]


def _config(stage, data, seq, model=1, mode="ulysses"):
    return {"train_micro_batch_size_per_gpu": GB // data,
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": stage},
            "gradient_clipping": 1.0,
            "tensor_parallel": {"tp_size": model},
            "sequence_parallel": {"size": seq, "mode": mode}}


#: the JAX references: name → (mesh, mode, data seed)
JAX = {"d1s2": ({"data": 1, "seq": 2}, "ulysses", 1),
       "ring_d1s2": ({"data": 1, "seq": 2}, "ring", 2),
       "d2s2": ({"data": 2, "seq": 2}, "ulysses", 3),
       "m2s2": ({"data": 1, "seq": 2, "model": 2}, "ulysses", 4)}
#: port runs: world → name → (JAX reference, stage)
RUNS = {2: {"d1s2_s1": ("d1s2", 1), "ring_d1s2_s1": ("ring_d1s2", 1)},
        4: {"d2s2_s1": ("d2s2", 1), "d2s2_s3": ("d2s2", 3),
            "m2s2_s0": ("m2s2", 0)}}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def init():
    return _np_tree(jtf.init_params(j_llama("tiny", **LLAMA[1]),
                                    jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_runs(init, tmp_path_factory):
    """Every JAX reference; the data 2 × seq 2 one saves its checkpoint
    after its steps."""
    saved = jmesh._CURRENT_MESH
    out = {"dir": str(tmp_path_factory.mktemp("sp_ckpt"))}
    try:
        for name, (mesh, mode, seed) in JAX.items():
            _jmesh(mesh)
            je, *_ = deepspeed_tpu.initialize(
                model=j_llama("tiny", **LLAMA[1]), params=init,
                config=_config(1, mesh["data"], mesh["seq"],
                               mesh.get("model", 1), mode))
            out[name] = {"losses": [float(je.train_batch(iter(s)))
                                    for s in _data(seed)],
                         "params": _np_tree(je.params)}
            if name == "d2s2":
                je.save_checkpoint(out["dir"] + "/jax")
                out["jax_saved"] = {"params": out[name]["params"],
                                    "opt": _np_tree(je.opt_state)}
    finally:
        jmesh._CURRENT_MESH = saved
    return out


def _runs(world, init):
    out = []
    for name, (ref, stage) in RUNS[world].items():
        mesh, mode, seed = JAX[ref]
        out.append({"name": name, "model": LLAMA, "params": init,
                    "config": _config(stage, mesh["data"], mesh["seq"],
                                      mesh.get("model", 1), mode),
                    "steps": _data(seed)})
    return out


@pytest.fixture(scope="module")
def port(init, jax_runs):
    """World 2 over seq 2; world 4 over data 2 × seq 2 (its runs and the
    checkpoints both ways), then model 2 × seq 2."""
    pdir = jax_runs["dir"] + "/port"
    mesh, mode, seed = JAX["d2s2"]
    ckpt = [{"name": "save", "model": LLAMA, "params": init,
             "config": _config(1, 2, 2), "steps": _data(seed),
             "mode": "save", "dir": pdir},
            {"name": "load", "model": LLAMA, "params": init,
             "config": _config(1, 2, 2), "mode": "load",
             "dir": jax_runs["dir"] + "/jax"},
            {"name": "ep_raises", "model": LLAMA, "mode": "raises",
             "config": _config(0, 1, 2)}]
    runs4 = _runs(4, init)
    w4 = [{"shape": {"data": 2, "seq": 2},
           "runs": [r for r in runs4 if r["name"].startswith("d2")] + ckpt},
          {"shape": {"data": 1, "seq": 2, "model": 2},
           "runs": [r for r in runs4 if r["name"].startswith("m2")]},
          {"shape": {"expert": 2, "seq": 2}, "runs": [ckpt[-1]]}]
    return {2: spawn("sp_runs", 2, meshes=[{"shape": {"seq": 2},
                                            "runs": _runs(2, init)}]),
            4: spawn("sp_runs", 4, meshes=w4, timeout=240.0),
            "pdir": pdir}


CASES = [(w, n) for w in RUNS for n in RUNS[w]]


@pytest.mark.parametrize("world,name", CASES, ids=[n for _, n in CASES])
def test_sp_training_matches_jax_engine(port, jax_runs, world, name):
    want = jax_runs[RUNS[world][name][0]]
    mesh = JAX[RUNS[world][name][0]][0]
    sp, tp = mesh["seq"], mesh.get("model", 1)
    for r, rr in enumerate(port[world]):
        got = rr[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                                   err_msg=f"{name} rank {r}")
        assert got["losses"] == port[world][0][name]["losses"]
        jp, tp_ = _leaves(want["params"]), _leaves(got["params"])
        assert sorted(jp) == sorted(tp_)
        for k in jp:
            np.testing.assert_allclose(tp_[k], jp[k], rtol=0, atol=1e-4,
                                       err_msg=f"{name} {k} rank {r}")
        assert got["coords"] == {"data": r // (sp * tp),
                                 "seq": (r // tp) % sp, "model": r % tp}
        assert np.isfinite(got["eval"])


def test_jax_save_loads_into_the_port_at_data2_seq2(port, jax_runs):
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


def test_port_save_loads_into_jax_at_data2_seq2(port, init):
    """Each shard written once (seq rank 0 of its data group), read
    bitwise by the JAX store on the same mesh."""
    saved = jmesh._CURRENT_MESH
    try:
        _jmesh({"data": 2, "seq": 2})
        jl, *_ = deepspeed_tpu.initialize(
            model=j_llama("tiny", **LLAMA[1]), config=_config(1, 2, 2),
            params=jax.tree.map(np.zeros_like, init))
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
    import glob
    import os
    frags = glob.glob(os.path.join(port["pdir"], tag, "state", "params",
                                   "*.bin"))
    # the seq ranks (1 and 3) hold replicas and write nothing
    assert frags and not [f for f in frags if ".p1f0" in f or ".p3f0" in f]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _confs(**kw):
    base = {"train_micro_batch_size_per_gpu": 1}
    base.update(kw)
    return DeepSpeedConfig.from_any(dict(base)), \
        DeepSpeedTPUConfig.from_any(dict(base))


def _jdec(name):
    from deepspeed_tpu.models import (bert, bloom, gptneo, llama, mistral)
    return {"bert": bert.bert_config, "bloom": bloom.bloom_config,
            "gptneo": gptneo.gptneo_config, "mistral": mistral.mistral_config,
            "llama": llama.llama3_config}[name](
        "tiny", **({"sliding_window": 16} if name == "mistral" else {}))


def _tdec(name):
    return {"bert": dt.bert_config, "bloom": dt.bloom_config,
            "gptneo": dt.gptneo_config, "mistral": dt.mistral_config,
            "llama": dt.llama3_config}[name](
        "tiny", **({"sliding_window": 16} if name == "mistral" else {}))


REFUSED = [("fpdt", 2, "llama"), ("fpdt", 1, "bert"), ("fpdt", 1, "bloom"),
           ("fpdt", 1, "mistral"), ("fpdt", 1, "gptneo"),
           ("auto", 2, "gptneo"), ("auto", 2, "bert"), ("auto", 2, "bloom"),
           ("auto", 2, "mistral")]


@pytest.mark.parametrize("impl,sp,model", REFUSED,
                         ids=[f"{i}-sp{s}-{m}" for i, s, m in REFUSED])
def test_select_attention_raises_the_jax_value_errors(impl, sp, model):
    tc, jc = _confs(attention_impl=impl, sequence_parallel={"size": sp})
    with pytest.raises(ValueError) as want:
        jmf.select_attention(jc, _jdec(model))
    with pytest.raises(ValueError) as got:
        tmf.select_attention(tc, _tdec(model))
    assert str(got.value) == str(want.value)


def test_select_attention_picks_the_sp_wrappers(monkeypatch):
    from deepspeed_tpu_torch.parallel.fpdt import fpdt_attention
    from deepspeed_tpu_torch.parallel.ring import ring_attention
    for mode, fn in (("ring", ring_attention),
                     ("ulysses", tul.distributed_attention)):
        tc, _ = _confs(sequence_parallel={"size": 2, "mode": mode})
        assert tmf.select_attention(tc, _tdec("llama")).func is fn
    tc, _ = _confs(attention_impl="fpdt")
    monkeypatch.setenv("DSTPU_FPDT_CHUNK", "512")
    got = tmf.select_attention(tc, _tdec("llama"))
    assert got.func is fpdt_attention and got.keywords == {"chunk": 512}
    monkeypatch.delenv("DSTPU_FPDT_CHUNK")
    assert tmf.select_attention(tc).keywords == {"chunk": 4096}
    tc, _ = _confs(attention_impl="mine", sequence_parallel={"size": 2})
    with pytest.raises(NotImplementedError, match="registered"):
        tmf.select_attention(tc, _tdec("llama"))


def test_engine_refusals():
    """PP + SP and the parameter tier + SP raise the JAX ValueErrors; EP ×
    SP and the capacity MoE under SP are not ported; a seq mesh needs
    torch.distributed and sequence_parallel.size of its size."""
    cfg = dt.llama3_config("tiny", max_seq_len=T, vocab_size=VOCAB)
    with pytest.raises(ValueError, match="does not compose with "
                                         "sequence_parallel"):
        dt.initialize(cfg, {"pipeline": {"stages": 2},
                            "sequence_parallel": {"size": 2}},
                      device="cpu")
    sp2 = {"train_micro_batch_size_per_gpu": 1,
           "sequence_parallel": {"size": 2}}
    with pytest.raises(ValueError, match="pipeline/sequence parallelism"):
        dt.initialize(cfg, dict(sp2, zero_optimization={
            "stage": 2, "offload_optimizer": {"device": "nvme",
                                              "nvme_path": "/nonexistent"},
            "offload_param": {"device": "nvme",
                              "nvme_path": "/nonexistent"}}),
            device="cpu", mesh=Mesh({"seq": 2}))
    with pytest.raises(NotImplementedError, match="Parallelism breadth"):
        dt.initialize(cfg, dict(sp2, moe={"enabled": True, "ep_size": 2}),
                      device="cpu", mesh=Mesh({"expert": 2, "seq": 2}))
    with pytest.raises(NotImplementedError, match="Parallelism breadth"):
        dt.initialize(mixtral_config("tiny"),
                      dict(sp2, moe={"impl": "capacity"}), device="cpu",
                      mesh=Mesh({"seq": 2}))
    with pytest.raises(ValueError, match="torch.distributed"):
        dt.initialize(cfg, sp2, device="cpu", mesh=Mesh({"seq": 2}))
    with pytest.raises(ValueError, match="sequence_parallel.size is 1"):
        dt.initialize(cfg, {"train_micro_batch_size_per_gpu": 1},
                      device="cpu", mesh=Mesh({"seq": 2}))


def test_ep_times_sp_raises_on_ranks(port):
    for rr in port[4]:
        assert rr["ep_raises"].startswith("NotImplementedError") and \
            "Parallelism breadth" in rr["ep_raises"]
