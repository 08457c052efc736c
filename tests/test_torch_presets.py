"""The port's model presets (deepspeed_tpu_torch/models/<family>.py)
against the JAX package's (deepspeed_tpu/models/<family>.py), on the CPU.

- Every preset function's every size builds the same DecoderConfig, field
  for field (no params drawn).
- Every decoder family at its "tiny" size, fp32, with the JAX package's
  ``init_params`` tree carried across by ``params_from_jax``: the port's
  ``forward`` logits within 2e-4 of the JAX ``forward``; the port's
  ``RaggedInferenceEngine.put`` logits within 2e-4 of
  ``RaggedInferenceEngineTPU.put``; greedy ``generate`` tokens identical.
  2e-4: two fp32 implementations of the same function summing in
  different orders through two layers.
- BLOOM (ALiBi) and BERT/DistilBERT (bidirectional, the masked-LM head):
  the port's ``forward`` within 2e-4 of the JAX one; both refused by the
  port's ragged engine (BLOOM pointed at the v1 engine). GPT-Neo's window
  pattern raises in both ragged engines.
"""

import dataclasses
import inspect
import re
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import deepspeed_tpu.models as jm
import deepspeed_tpu_torch as tpkg
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.inference.engine_v2 import RaggedInferenceEngineTPU
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.parallel.moe import moe_layer as j_moe_layer
from deepspeed_tpu_torch.inference.engine_v2 import RaggedInferenceEngine
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.parallel.moe import moe_layer as t_moe_layer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
ENG_CFG = {"dtype": "float32", "num_blocks": 32, "block_size": 16,
           "max_seq_len": 64, "prefill_chunk": 8, "max_batch_tokens": 64}

PRESETS = ["gpt2_config", "llama3_config", "mixtral_config",
           "mistral_config", "qwen_config", "qwen2_config", "falcon_config",
           "gptneox_config", "phi_config", "opt_config", "gemma_config",
           "bloom_config", "gpt_bigcode_config", "qwen2_moe_config",
           "gptj_config", "bert_config", "distilbert_config",
           "gptneo_config", "internlm_config"]

#: the families the ragged engines serve (causal, no ALiBi, no window
#: pattern)
SERVED = ["gpt2_config", "llama3_config", "mixtral_config",
          "mistral_config", "qwen_config", "qwen2_config", "falcon_config",
          "gptneox_config", "phi_config", "opt_config", "gemma_config",
          "gpt_bigcode_config", "qwen2_moe_config", "gptj_config",
          "internlm_config"]


def _sizes(name):
    """The preset names of one JAX preset function, read off its source
    (the presets dict is local to the function)."""
    src = inspect.getsource(getattr(jm, name))
    return re.findall(r'^\s+"([^"]+)":\s+dict\(', src, re.M)


def test_every_preset_is_exported():
    for name in PRESETS:
        assert name in tm.__all__ and name in tpkg.__all__, name
        assert getattr(tpkg, name) is getattr(tm, name)
    ported = {n for n in jm.__all__ if n.endswith("_config")}
    assert ported == set(PRESETS)


@pytest.mark.parametrize("name", PRESETS)
def test_full_size_configs_equal_jax(name):
    sizes = _sizes(name)
    assert "tiny" in sizes and len(sizes) >= 2, sizes
    for size in sizes:
        j = getattr(jm, name)(size)
        t = getattr(tm, name)(size)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), size
        assert t.num_params() == j.num_params(), size
        assert (t.head_dim, t.kv_heads, t.ffn_size, t.rope_dim) == \
            (j.head_dim, j.kv_heads, j.ffn_size, j.rope_dim), size
    assert getattr(tm, name)("tiny", vocab_size=300).vocab_size == 300
    with pytest.raises(KeyError):
        getattr(tm, name)("no-such-size")


def _models(name):
    jcfg = getattr(jm, name)("tiny")
    tcfg = getattr(tm, name)("tiny")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _moe_fns(cfg):
    if not cfg.num_experts:
        return None, None
    kw = dict(top_k=cfg.num_experts_per_tok, drop_tokens=False,
              aux_loss_coef=0.0, norm_topk=cfg.norm_topk_prob)
    return (partial(j_moe_layer, capacity_factor=8.0, ep_axis=None, **kw),
            partial(t_moe_layer, **kw))


@pytest.mark.parametrize("name", SERVED + ["gptneo_config"])
def test_tiny_forward_matches_jax(name):
    jcfg, tcfg, jp, tp = _models(name)
    j_moe, t_moe = _moe_fns(jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    want = np.asarray(jm.forward(jcfg, jp, jnp.asarray(tokens),
                                 moe_fn=j_moe))
    with torch.no_grad():
        got = tm.forward(tcfg, tp, torch.from_numpy(tokens),
                         moe_fn=t_moe).numpy()
    assert got.shape == (2, 24, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("name", SERVED)
def test_tiny_engine_matches_jax(name, monkeypatch):
    """put logits within 2e-4 and greedy generate tokens identical, over
    prompts of 5, 11 and 23 tokens (fresh, split and decode steps)."""
    build_mesh(data=1, devices=jax.devices()[:1])
    monkeypatch.setenv("DSTPU_NO_FUSED_DECODE", "1")
    jcfg, tcfg, jp, tp = _models(name)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, size=(n,), dtype=np.int32)
               for n in (5, 11, 23)]
    jeng = RaggedInferenceEngineTPU(jcfg, ENG_CFG, params=jp)
    teng = RaggedInferenceEngine(tcfg, ENG_CFG, params=tp, device="cpu")
    want = jeng.put([0, 1, 2], prompts)
    got = teng.put([0, 1, 2], prompts)
    for u in range(3):
        np.testing.assert_allclose(got[u], want[u], **LOGIT_TOL)
    for u in range(3):
        jeng.flush(u)
        teng.flush(u)
    want = jeng.generate(prompts, max_new_tokens=4)
    got = teng.generate(prompts, max_new_tokens=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert teng.state.allocator.free_blocks == ENG_CFG["num_blocks"]


def test_gptneo_window_pattern_raises_in_both_engines():
    build_mesh(data=1, devices=jax.devices()[:1])
    jcfg, tcfg, jp, tp = _models("gptneo_config")
    with pytest.raises(NotImplementedError, match="layer_window_pattern"):
        RaggedInferenceEngineTPU(jcfg, ENG_CFG, params=jp)
    with pytest.raises(NotImplementedError, match="layer_window_pattern"):
        RaggedInferenceEngine(tcfg, ENG_CFG, params=tp, device="cpu")


def test_bloom_alibi_raises():
    """BLOOM (the name kept from when its ALiBi forward was missing): the
    port's forward, its slopes baked in by the default attention, within
    2e-4 of the JAX forward; the port's ragged engine refuses ALiBi and
    points at the v1 engine."""
    jcfg, tcfg, jp, tp = _models("bloom_config")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    want = np.asarray(jm.forward(jcfg, jp, jnp.asarray(tokens, jnp.int32)))
    with torch.no_grad():
        got = tm.forward(tcfg, tp, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    with pytest.raises(NotImplementedError, match="ALiBi.*InferenceEngine"):
        RaggedInferenceEngine(tcfg, ENG_CFG, params=tp,
                              device="cpu").put([0], [np.arange(4)])


@pytest.mark.parametrize("name", ["bert_config", "distilbert_config"])
def test_encoders_raise(name):
    """BERT/DistilBERT (the name kept from when the masked-LM head was
    missing): the port's init_params draws the JAX tree's leaves, the
    masked-LM head included; its forward, given a padding mask (and
    segments for BERT), is within 2e-4 of the JAX forward; the ragged
    engine refuses bidirectional models."""
    jcfg, cfg, jp, tp = _models(name)
    assert not cfg.causal and cfg.mlm_head
    drawn = tm.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, torch.device("cpu"))
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        jax.tree.map(lambda a: tuple(a.shape), drawn)
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, cfg.vocab_size, (2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    kw = {"attention_mask": mask}
    if cfg.type_vocab_size:
        kw["token_type_ids"] = (np.arange(12) >= 6).astype(np.int32)[
            None].repeat(2, 0)
    want = np.asarray(jm.forward(jcfg, jp, jnp.asarray(tokens, jnp.int32),
                                 **{k: jnp.asarray(v) for k, v in
                                    kw.items()}))
    with torch.no_grad():
        got = tm.forward(cfg, tp, torch.from_numpy(tokens),
                         **{k: torch.from_numpy(v) for k, v in
                            kw.items()}).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    with pytest.raises(NotImplementedError, match="full-causal"):
        RaggedInferenceEngine(cfg, ENG_CFG, params={}, device="cpu")
