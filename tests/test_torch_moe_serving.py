"""MoE serving as a whole: deepspeed_tpu_torch's RaggedInferenceEngine
against deepspeed_tpu's RaggedInferenceEngineTPU on the CPU, for
mixtral-tiny (top-2 of 4) and a qwen2-moe-tiny (top-4 of 8, shared expert
with its gate, qkv biases, raw gates), both at d 128 so that the JAX
dropless layer takes its Pallas kernels (DSTPU_MOE_KERNEL=pallas, interpret
mode; the tiny presets' d 64 are off the Pallas gate).

Four prompts of 300 tokens in chunks of 256 give two prefill steps of
4 x 256 = 1024 tokens (the dropless path), then decode steps of 4 tokens
(the capacity path); the test checks that both paths ran.

Tolerance: ``put`` logits within 2e-4 (fp32, different summation orders
through two layers); greedy tokens identical.
"""

import numpy as np
import jax
import pytest
import torch

from deepspeed_tpu.inference.engine_v2 import RaggedInferenceEngineTPU
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.qwen2_moe import qwen2_moe_config as j_qwen
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.inference.engine_v2 import RaggedInferenceEngine
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.mixtral import mixtral_config as t_mixtral
from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config as t_qwen
from deepspeed_tpu_torch.parallel import moe as tm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
ENG_CFG = {"dtype": "float32", "num_blocks": 128, "block_size": 16,
           "max_seq_len": 320, "prefill_chunk": 256,
           "max_batch_tokens": 1024}
MODELS = {
    "mixtral": (j_mixtral, t_mixtral,
                dict(hidden_size=128, intermediate_size=256,
                     vocab_size=256)),
    "qwen2_moe": (j_qwen, t_qwen,
                  dict(hidden_size=128, intermediate_size=384,
                       num_experts=8, num_experts_per_tok=4,
                       shared_expert_size=256, vocab_size=256)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    build_mesh(data=1, devices=jax.devices()[:1])
    j_cfg_fn, t_cfg_fn, kw = MODELS[request.param]
    jcfg, tcfg = j_cfg_fn("tiny", **kw), t_cfg_fn("tiny", **kw)
    jp = j_init(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, size=(300,), dtype=np.int32)
               for _ in range(4)]
    return jcfg, tcfg, jp, tp, prompts


def _engines(model, monkeypatch):
    jcfg, tcfg, jp, tp, _ = model
    monkeypatch.setenv("DSTPU_NO_FUSED_DECODE", "1")
    monkeypatch.setenv("DSTPU_MOE_KERNEL", "pallas")
    calls = {"dropless": 0, "capacity": 0}
    for fn, tag in (("moe_layer", "capacity"),
                    ("dropless_moe_layer", "dropless")):
        real = getattr(tm, fn)

        def spy(*a, _r=real, _t=tag, **kw):
            calls[_t] += 1
            return _r(*a, **kw)
        monkeypatch.setattr(tm, fn, spy)
    return (RaggedInferenceEngineTPU(jcfg, ENG_CFG, params=jp),
            RaggedInferenceEngine(tcfg, ENG_CFG, params=tp, device="cpu"),
            calls)


def test_generate_token_identical_through_both_moe_paths(model,
                                                          monkeypatch):
    jeng, teng, calls = _engines(model, monkeypatch)
    want = jeng.generate(model[4], max_new_tokens=3)
    got = teng.generate(model[4], max_new_tokens=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    layers = model[1].num_layers
    # two prefill steps of 4 x 256 tokens, two decode steps of 4 rows
    assert calls == {"dropless": 2 * layers, "capacity": 2 * layers}
    assert teng.stats["fresh"]["steps"] == 1
    assert teng.stats["split"]["steps"] == 1
    assert not teng.state.seqs
    assert teng.state.allocator.free_blocks == ENG_CFG["num_blocks"]


def test_put_logits_match(model, monkeypatch):
    jeng, teng, calls = _engines(model, monkeypatch)
    prompts = model[4]
    want = jeng.put([0, 1, 2, 3], prompts)
    got = teng.put([0, 1, 2, 3], prompts)
    for u in range(4):
        np.testing.assert_allclose(got[u], want[u], **LOGIT_TOL)
    assert calls["dropless"] > 0
    # one decode-shaped step (4 tokens) through the capacity path
    nxt = [[int(np.argmax(got[u]))] for u in range(4)]
    want = jeng.put([0, 1, 2, 3], nxt)
    got = teng.put([0, 1, 2, 3], nxt)
    for u in range(4):
        np.testing.assert_allclose(got[u], want[u], **LOGIT_TOL)
    assert calls["capacity"] > 0
