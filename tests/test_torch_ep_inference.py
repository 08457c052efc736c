"""Expert-parallel serving in the port: ``init_inference`` over an
'expert' mesh axis of 2 (gloo ranks on the CPU, tests/torch_dp.py)
against ``InferenceEngineTPU`` on ``build_mesh`` of the same shape over
the 8-device CPU mesh, from one numpy parameter tree (the scenarios of
tests/test_quantized_serving.py:383-423).

mixtral-tiny at d 256, f 256 (4 experts, top-2; the JAX int8 experts
take its Pallas K5c kernel, in interpret mode, at that width) and
qwen2-moe-tiny (the shared expert). Each rank keeps its 2 experts; the
capacity layer's buffers cross the 'expert' all-to-all at every token
count; a batch whose rows divide by the axis splits over it, one that
does not runs whole on every rank. One run puts rank 1 at expert
position 0 (``devices=[1, 0]``), so the exchange must route each block
by position, not by the group's rank order. Under tensor parallelism the experts
stay whole on each model rank (the JAX ``_shard_like``). An engine that
draws its tree keeps only its experts of the full draw. Packed int4
experts under EP raise the JAX ``ValueError``s.

Tolerances: logits within 2e-4 relative to the largest logit (the JAX
tests hold int8 EP against EP 1 at 2e-4; fp32 here, the sums run in
other orders); greedy tokens identical.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import InferenceEngineTPU
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.qwen2_moe import qwen2_moe_config as j_qwen
from deepspeed_tpu.ops.quantized_linear import quantize_param_tree as jquant
from deepspeed_tpu.parallel import mesh as jmesh

from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.models.transformer import DecoderConfig
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 2e-4
NEW = 5
PROMPT = np.random.default_rng(2).integers(0, 256, size=(2, 8),
                                           dtype=np.int32)
ODD = np.random.default_rng(3).integers(0, 256, size=(3, 8), dtype=np.int32)
MIX = j_mixtral("tiny", hidden_size=256, intermediate_size=256,
                max_seq_len=64, vocab_size=256)
QWEN = j_qwen("tiny", max_seq_len=64, vocab_size=256)
EP = {"expert": 2}
#: rank 1 at expert position 0: the group's rank order is not its
#: positions' (the exchange must route by position)
EP_SWAPPED = {"expert": 2, "devices": [1, 0]}
TP = {"model": 2}

#: name → (model, tree, mesh, config extras, prompt)
RUNS = {
    "int8": (MIX, "mix", EP, {"weight_quant": "int8"}, PROMPT),
    "int8_whole_rows": (MIX, "mix", EP, {"weight_quant": "int8"}, ODD),
    "fp32": (MIX, "mix", EP, {}, PROMPT),
    "fp32_swapped": (MIX, "mix", EP_SWAPPED, {}, PROMPT),
    "shared": (QWEN, "qwen", EP, {}, PROMPT),
    "prequant_int8": (MIX, "mix_q", EP, {}, PROMPT),
    "tp_int8": (MIX, "mix", TP, {"weight_quant": "int8"}, PROMPT),
    "tp_fp32": (MIX, "mix", TP, {}, PROMPT),
}
REFUSED = {"int4_refused": ("mix", {"weight_quant": "int4"}),
           "prequant_int4_refused": ("mix_q4", {})}
DRAWN = {"weight_quant": "int8"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    mix = _np(jtf.init_params(MIX, jax.random.PRNGKey(11)))
    return {"mix": mix, "qwen": _np(jtf.init_params(QWEN,
                                                    jax.random.PRNGKey(4))),
            "mix_q": _np(jquant(mix, mode="int8")),
            "mix_q4": _np(jquant(mix, mode="int4"))}


def _config(extra):
    return dict({"dtype": "float32"}, **extra)


@pytest.fixture(scope="module")
def jax_ref(trees):
    saved = jmesh._CURRENT_MESH
    out = {}
    try:
        for name, (cfg, key, mesh, extra, prompt) in RUNS.items():
            shape = dict({"data": 1}, **mesh)
            shape["devices"] = [jax.devices()[i]
                                for i in shape.get("devices", (0, 1))]
            m = jmesh.build_mesh(**shape)
            eng = InferenceEngineTPU(cfg, _config(extra),
                                     params=trees[key], mesh=m)
            out[name] = {
                "tokens": np.asarray(eng.generate(prompt,
                                                  max_new_tokens=NEW)),
                "logits": np.asarray(jtf.forward(
                    cfg, eng.params, jax.numpy.asarray(prompt),
                    moe_fn=eng._moe_fn))}
    finally:
        jmesh._CURRENT_MESH = saved
    return out


@pytest.fixture(scope="module")
def port(trees):
    runs = [{"name": name, "mesh": mesh, "cfg": dataclasses.asdict(cfg),
             "params": trees[key], "config": _config(extra),
             "prompt": prompt, "new": NEW}
            for name, (cfg, key, mesh, extra, prompt) in RUNS.items()]
    runs += [{"name": name, "mesh": EP, "cfg": dataclasses.asdict(MIX),
              "params": trees[key], "config": _config(extra),
              "prompt": PROMPT, "new": NEW}
             for name, (key, extra) in REFUSED.items()]
    runs.append({"name": "drawn", "mesh": EP, "cfg": dataclasses.asdict(MIX),
                 "params": None, "seed": 5, "config": _config(DRAWN),
                 "prompt": PROMPT, "new": NEW})
    return spawn("ep_serving", 2, runs=runs)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ep_serving_matches_jax_engine(port, jax_ref, name):
    want = jax_ref[name]
    mesh = RUNS[name][2]
    for r, rr in enumerate(port):
        got = rr[name]
        assert _rel(got["logits"], want["logits"]) <= RTOL, (name, r)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        # EP keeps this rank's 2 of 4 experts; TP keeps them whole
        assert got["wg"][1] == (2 if "expert" in mesh else 4)
        assert got["wg"][-1] == RUNS[name][0].ffn_size
        if "expert" in mesh:
            # one record a layer of the JAX layer's regroup: the [E, C, d]
            # buffer (C = the rank's tokens: nothing is dropped)
            rows = RUNS[name][4].shape[0]
            rows = rows // 2 if rows % 2 == 0 else rows
            cfg = RUNS[name][0]
            size = cfg.num_experts * rows * 8 * cfg.hidden_size * 4
            assert got["a2a"] == {size: [cfg.num_layers, 0.0]}, got["a2a"]


def test_packed_experts_refused_under_ep(port):
    for rr in port:
        assert "requires an expert mesh axis of 1" in rr["int4_refused"]
        assert "cannot shard over EP" in rr["prequant_int4_refused"]


def test_drawn_experts_are_the_full_draws(port):
    """A rank that draws its tree keeps its experts of the full draw: the
    same logits and tokens as one process that draws the whole tree from
    the same seed."""
    whole = init_inference(DecoderConfig(**dataclasses.asdict(MIX)),
                           _config(DRAWN), device="cpu",
                           generator=torch.Generator().manual_seed(5))
    want = whole.forward(PROMPT).numpy()
    tokens = whole.generate(PROMPT, max_new_tokens=NEW)
    for rr in port:
        assert _rel(rr["drawn"]["logits"], want) <= RTOL
        np.testing.assert_array_equal(rr["drawn"]["tokens"], tokens)
