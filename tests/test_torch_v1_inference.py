"""The v1 engine: deepspeed_tpu_torch's InferenceEngine / init_inference and
its KV-cached forward against deepspeed_tpu's InferenceEngineTPU and
forward_with_cache, on the CPU, fp32, tiny models, weights carried across
by ``params_from_jax`` (the scenarios of tests/test_inference.py).

Tolerances: fp32 logits within 1e-5 relative (the largest difference
over the largest logit; the packages sum in different orders); greedy
tokens identical. Sampled tokens come from the port's
``torch.Generator``, so they are held to the set the sampler allows (the
top-k, the nucleus), computed from the JAX forward's logits, and to the
port's own stepwise loop, which draws the same numbers in the same order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.inference.engine import InferenceEngineTPU
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.gpt import gpt2_config as jgpt2
from deepspeed_tpu.models.llama import llama3_config as jllama
from deepspeed_tpu.models.mixtral import mixtral_config as jmixtral
from deepspeed_tpu.parallel import mesh as jax_mesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.inference import (InferenceEngine,
                                           RaggedInferenceEngine,
                                           init_inference)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGIT_RTOL = 1e-5
ENG = {"dtype": "float32"}
_HOST_OPS = ("_local_scalar_dense", "lift_fresh", "nonzero", "multinomial",
             "masked_select")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _model(preset, seed, **over):
    jcfg = {"gpt2": jgpt2, "llama": jllama, "mixtral": jmixtral}[preset](
        "tiny", max_seq_len=64, vocab_size=256, **over)
    tcfg = ttf.DecoderConfig(**jcfg.__dict__)
    jp = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                  jax.random.PRNGKey(seed)))
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def one_device():
    saved = jax_mesh._CURRENT_MESH
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    yield
    jax_mesh._CURRENT_MESH = saved


@pytest.fixture(scope="module")
def llama(one_device):
    return _model("llama", 8)


@pytest.fixture(scope="module")
def gpt2(one_device):
    return _model("gpt2", 5)


def _prompts(b, t, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(b, t),
                                                dtype=np.int32)


def test_cached_forward_matches_jax_and_full(llama):
    """Prefill 8 then decode 8 one by one: each step's logits within 1e-5
    of JAX's forward_with_cache, and of the port's full forward."""
    jcfg, tcfg, jp, tp = llama
    tok = _prompts(2, 16, 0)
    full = ttf.forward(tcfg, tp, torch.from_numpy(tok)).detach().numpy()
    jcache = jtf.init_kv_cache(jcfg, 2, 32, jnp.float32)
    tcache = ttf.init_kv_cache(tcfg, 2, 32, torch.float32, "cpu")
    jl, jcache = jtf.forward_with_cache(jcfg, jp, jnp.asarray(tok[:, :8]),
                                        jcache, jnp.int32(0))
    with torch.no_grad():
        tl, tcache = ttf.forward_with_cache(tcfg, tp,
                                            torch.from_numpy(tok[:, :8]),
                                            tcache, 0)
    assert _rel(tl, jl) <= LOGIT_RTOL
    assert _rel(tl, full[:, 7]) <= LOGIT_RTOL
    for i in range(8, 16):
        jl, jcache = jtf.forward_with_cache(
            jcfg, jp, jnp.asarray(tok[:, i:i + 1]), jcache, jnp.int32(i))
        with torch.no_grad():
            tl, tcache = ttf.forward_with_cache(
                tcfg, tp, torch.from_numpy(tok[:, i:i + 1]), tcache,
                torch.tensor(i, dtype=torch.int32))
        assert _rel(tl, jl) <= LOGIT_RTOL, i
        assert _rel(tl, full[:, i]) <= LOGIT_RTOL, i
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("preset", ["gpt2", "llama"])
def test_greedy_tokens_match_jax_engine(preset, request):
    jcfg, tcfg, jp, tp = request.getfixturevalue(preset)
    prompt = _prompts(2, 8, 1)
    want = InferenceEngineTPU(jcfg, ENG, params=jp).generate(
        prompt, max_new_tokens=8)
    eng = init_inference(tcfg, ENG, params=tp, device="cpu")
    got = eng.generate(prompt, max_new_tokens=8)
    assert got.shape == (2, 16) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=8),
                                  got)
    assert _rel(eng.forward(prompt).numpy(),
                np.asarray(jtf.forward(jcfg, jp, jnp.asarray(prompt)))
                ) <= LOGIT_RTOL


def test_eos_fill_matches_jax_engine(llama):
    """Everything after a row's first eos is eos, as the JAX engine's
    host-side truncation makes it (engine.py:446-451)."""
    jcfg, tcfg, jp, tp = llama
    prompts = _prompts(3, 11, 9)
    eng = InferenceEngine(tcfg, ENG, params=tp, device="cpu")
    out = eng.generate(prompts, max_new_tokens=9)
    eos = int(out[0, 11 + 2])
    got = eng.generate(prompts, max_new_tokens=9, eos_token_id=eos)
    want = InferenceEngineTPU(jcfg, ENG, params=jp).generate(
        prompts, max_new_tokens=9, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    row = got[0, 11:]
    assert (row[np.where(row == eos)[0][0]:] == eos).all()
    np.testing.assert_array_equal(
        eng._generate_stepwise(prompts, max_new_tokens=9, eos_token_id=eos),
        got)


@pytest.mark.parametrize("kwargs", [dict(temperature=0.9, top_k=8),
                                    dict(temperature=0.7, top_p=0.9),
                                    dict(temperature=1.0)])
def test_fused_matches_stepwise_and_samples_allowed(llama, kwargs):
    """The fused loop (one prefill, max_new_tokens - 1 decode steps, one
    fetch) gives the stepwise loop's tokens from the same generator state;
    each sampled token lies in the set the sampler allows at its step,
    from the JAX forward's logits."""
    jcfg, tcfg, jp, tp = llama
    prompts = _prompts(3, 11, 9)
    outs = []
    for fused in (True, False):
        eng = InferenceEngine(tcfg, ENG, params=tp, device="cpu",
                              generator=torch.Generator().manual_seed(4))
        fn = eng.generate if fused else eng._generate_stepwise
        outs.append(fn(prompts, max_new_tokens=9, **kwargs))
    np.testing.assert_array_equal(outs[0], outs[1])
    logits = np.asarray(jtf.forward(jcfg, jp, jnp.asarray(outs[0])))
    for b in range(3):
        for pos in range(11, 20):
            lg = logits[b, pos - 1] / kwargs["temperature"]
            tok = outs[0][b, pos]
            if "top_k" in kwargs:
                assert tok in np.argsort(lg)[-kwargs["top_k"]:]
            if "top_p" in kwargs:
                p = np.exp(lg - lg.max())
                p /= p.sum()
                above = p[p > p[tok]].sum()
                assert above < kwargs["top_p"]


def test_argmax_equals_top_k_1(llama):
    jcfg, tcfg, jp, tp = llama
    eng = InferenceEngine(tcfg, ENG, params=tp, device="cpu")
    prompts = _prompts(2, 6, 3)
    np.testing.assert_array_equal(
        eng.generate(prompts, max_new_tokens=6),
        eng.generate(prompts, max_new_tokens=6, temperature=0.8, top_k=1))


@pytest.fixture(scope="module")
def mixtral(one_device):
    return _model("mixtral", 1)


def test_moe_v1_matches_jax_engine_and_v2(mixtral):
    """Mixtral tiny (the capacity MoE layer at every step): the port's v1
    greedy tokens equal InferenceEngineTPU's and the port's ragged
    engine's (v2 against v1)."""
    jcfg, tcfg, jp, tp = mixtral
    prompt = _prompts(1, 8, 3)
    want = InferenceEngineTPU(jcfg, ENG, params=jp).generate(
        prompt, max_new_tokens=6)
    v1 = InferenceEngine(tcfg, ENG, params=tp, device="cpu")
    np.testing.assert_array_equal(v1.generate(prompt, max_new_tokens=6), want)
    v2 = RaggedInferenceEngine(
        tcfg, {"dtype": "float32", "num_blocks": 16, "block_size": 16,
               "max_seq_len": 48, "prefill_chunk": 8,
               "max_batch_tokens": 32}, params=tp, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=(n,), dtype=np.int32)
               for n in (4, 9)]
    for pmt, got in zip(prompts, v2.generate(prompts, max_new_tokens=5)):
        np.testing.assert_array_equal(
            got, v1.generate(pmt[None], max_new_tokens=5)[0])


def test_tensor_parallel_and_mesh_raise(gpt2):
    """tp_size 4 needs as many ranks (test_torch_tp_inference.py runs
    them); a mesh with a sequence or expert axis is not ported."""
    from deepspeed_tpu_torch.parallel import mesh as tmesh
    from deepspeed_tpu_torch.parallel.mesh import Mesh
    _, tcfg, _, tp = gpt2
    saved = tmesh._CURRENT_MESH
    tmesh.set_mesh(None)          # tp_size builds the mesh when none lives
    try:
        with pytest.raises(ValueError, match="device count 1"):
            init_inference(tcfg, {"dtype": "float32",
                                  "tensor_parallel": {"tp_size": 4}},
                           params=tp, device="cpu")
    finally:
        tmesh.set_mesh(saved)
    with pytest.raises(NotImplementedError, match="Parallelism breadth"):
        InferenceEngine(tcfg, ENG, params=tp, device="cpu",
                        mesh=Mesh({"seq": 2}))
    # the expert axis serves (test_torch_ep_inference.py) over as many
    # ranks as the mesh holds
    with pytest.raises(ValueError, match="torch.distributed"):
        InferenceEngine(tcfg, ENG, params=tp, device="cpu",
                        mesh=Mesh({"expert": 2}))


def test_entry_points_and_guards(gpt2):
    _, tcfg, _, tp = gpt2
    assert dt.init_inference is init_inference
    assert dt.DeepSpeedTPUInferenceConfig().dtype == "bfloat16"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            InferenceEngine(tcfg, ENG, params=tp)
    with pytest.raises(ValueError, match="EncoderInference"):
        InferenceEngine(dt.bert_config("tiny"), ENG, device="cpu")
    with pytest.raises(ValueError, match="learned position"):
        InferenceEngine(tcfg, ENG, params=tp, device="cpu").generate(
            _prompts(1, 60, 0), max_new_tokens=8)


def test_decode_states_are_bucketed_and_bounded(llama):
    """Varied lengths and batches: a state's cache is prompt plus new
    tokens rounded up to TMAX_BUCKET rows, nearby lengths share it, and
    past MAX_DECODE_STATES the least recently used goes; greedy tokens
    equal the stepwise loop's (a fresh cache) and the JAX engine's
    throughout."""
    import dataclasses
    from deepspeed_tpu_torch.inference import engine as v1
    jcfg, tcfg, jp, tp = llama
    jcfg = dataclasses.replace(jcfg, max_seq_len=256)
    jeng = InferenceEngineTPU(jcfg, ENG, params=jp)
    eng = InferenceEngine(dataclasses.replace(tcfg, max_seq_len=256), ENG,
                          params=tp, device="cpu")
    bucket = v1.TMAX_BUCKET
    assert (bucket, v1.MAX_DECODE_STATES) == (128, 4)

    def gen(b, t, new):
        prompt = _prompts(b, t, b * 1000 + t)
        got = eng.generate(prompt, max_new_tokens=new)
        np.testing.assert_array_equal(
            got, eng._generate_stepwise(prompt, max_new_tokens=new))
        np.testing.assert_array_equal(
            got, jeng.generate(prompt, max_new_tokens=new))
        return [k[:2] for k in eng._states]

    assert gen(2, 8, 2) == [(2, bucket)]
    assert gen(2, 12, 4) == [(2, bucket)]
    assert gen(2, 130, 2) == [(2, bucket), (2, 2 * bucket)]
    assert gen(2, 8, 2) == [(2, 2 * bucket), (2, bucket)]
    gen(1, 4, 2)
    gen(3, 4, 2)
    # the fifth state drops the least recently used, (2, 2 * bucket)
    assert gen(4, 4, 2) == [(2, bucket), (1, bucket), (3, bucket),
                            (4, bucket)]


@pytest.mark.parametrize("weight_quant", [None, "int8"])
def test_decode_step_has_no_host_round_trip(llama, weight_quant):
    """The step a CUDA graph captures, run on the CPU under a dispatch
    mode, calls no op that reads a device value on the host or copies
    host data in (the prefill may)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(str(func))
            return func(*args, **(kwargs or {}))

    _, tcfg, _, tp = llama
    eng = InferenceEngine(tcfg, dict(ENG, weight_quant=weight_quant),
                          params=tp, device="cpu")
    for mode in (("argmax",), ("sample", 5, True)):
        st = eng._state(2, 16, mode)
        st.buf[:st.head].copy_(torch.from_numpy(st.pack(2, 4, 0.7, 0.9)))
        rec = Record()
        with torch.no_grad(), rec:
            eng._decode_step(st, mode)
        assert "aten.index_copy_.default" in rec.ops
        assert not [op for op in rec.ops
                    if any(h in op for h in _HOST_OPS)], (mode, rec.ops)
        assert int(st.cache_len) == 5 and int(st.i) == 2
