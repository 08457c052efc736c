"""Shared by tests/test_torch_serving*.py: the serving stack of each
package behind one interface, so a scenario is written once and run
through deepspeed_tpu (the reference) and deepspeed_tpu_torch (the port)
on the same weights.

Both engines serve the tiny Llama-3 of tests/test_serving.py (fp32, 32
pages of 8 tokens, chunks of 8). The port gets the JAX package's
parameters through ``models.convert.params_from_jax``.
"""

from types import SimpleNamespace

import jax
import numpy as np

import deepspeed_tpu.serving as jserving
import deepspeed_tpu_torch.serving as tserving
from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.inference import ragged as jragged
from deepspeed_tpu.inference.engine_v2 import RaggedInferenceEngineTPU
from deepspeed_tpu.models.llama import llama3_config as jllama
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.resilience.faults import fault_injector as jfaults
from deepspeed_tpu.telemetry import registry as jregistry
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.inference import ragged as tragged
from deepspeed_tpu_torch.inference.engine_v2 import RaggedInferenceEngine
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.llama import llama3_config as tllama
from deepspeed_tpu_torch.resilience.faults import fault_injector as tfaults
from deepspeed_tpu_torch.telemetry import registry as tregistry

ENG_CFG = {"dtype": "float32", "num_blocks": 32, "block_size": 8,
           "max_seq_len": 128, "prefill_chunk": 8, "max_batch_tokens": 64,
           "max_sequences": 16}
#: logits of the two packages' engines on the same weights (fp32; they
#: sum in different orders)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)

_JAX_PARAMS = {}
_TORCH_PARAMS = {}


def jax_params(key: int):
    if key not in _JAX_PARAMS:
        _JAX_PARAMS[key] = j_init(jllama("tiny", max_seq_len=256,
                                         vocab_size=256),
                                  jax.random.PRNGKey(key))
    return _JAX_PARAMS[key]


def torch_params(key: int):
    if key not in _TORCH_PARAMS:
        _TORCH_PARAMS[key] = params_from_jax(
            jax.tree.map(np.asarray, jax_params(key)), device="cpu")
    return _TORCH_PARAMS[key]


def _jax_engine(key: int = 0, dtype: str = "float32", **over):
    build_mesh(data=1, devices=jax.devices()[:1])
    params = jax_params(key)
    if dtype != "float32":
        params = jax.tree.map(lambda a: a.astype(dtype), params)
    return RaggedInferenceEngineTPU(
        jllama("tiny", max_seq_len=256, vocab_size=256),
        {**ENG_CFG, "dtype": dtype, **over}, params=params)


def _torch_engine(key: int = 0, dtype: str = "float32", **over):
    return RaggedInferenceEngine(
        tllama("tiny", max_seq_len=256, vocab_size=256),
        {**ENG_CFG, "dtype": dtype, **over}, params=torch_params(key),
        device="cpu")


JAX = SimpleNamespace(name="jax", engine=_jax_engine, serving=jserving,
                      ragged=jragged, faults=jfaults, registry=jregistry,
                      config=DeepSpeedTPUConfig)
TORCH = SimpleNamespace(name="torch", engine=_torch_engine,
                        serving=tserving, ragged=tragged, faults=tfaults,
                        registry=tregistry, config=DeepSpeedConfig)
PACKAGES = (JAX, TORCH)


def prompts(n, seed=0):
    """test_megastep.py's prompts: n prompts of 6, 7, ... tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, size=6 + i).tolist() for i in range(n)]


def outcome(fe, reqs):
    """What a scenario is compared on: every request's tokens, finish
    reason, cached tokens and retries, the frontend's counters, and the
    arena's page accounting."""
    alloc = fe.engine.state.allocator
    return {
        "requests": [(list(r.tokens_out), r.finish_reason, r.state.value,
                      r.cached_tokens, r.retries) for r in reqs],
        "counters": dict(fe.metrics.counters),
        "free_blocks": alloc.free_blocks,
        "pages_cached": fe.cache.pages_cached if fe.cache else None,
        "live_seqs": sorted(fe.engine.state.seqs),
    }


def both(scenario):
    """Run ``scenario(pkg)`` in both packages and assert that the port
    gives the reference's result; returns it."""
    want = scenario(JAX)
    got = scenario(TORCH)
    assert got == want
    return got
