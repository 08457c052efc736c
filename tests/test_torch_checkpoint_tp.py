"""Checkpoints of the port's engine on data × model against deepspeed_tpu's
store: tests/test_checkpoint.py:60-82 across the packages.

gpt2-tiny fp32, Adam, 8 x 32 tokens a step. The port's ranks are four
gloo processes on the CPU (tests/torch_dp.py) on
``build_mesh(data=2, model=2)``; the JAX engines run on the 8-device CPU
mesh's first four devices.

- A JAX save at ZeRO-3 on data 4 loads into the port at stage 1 on data 2
  × model 2 (each rank its 'model' block and its data shard), every leaf
  bitwise, and the port goes on to the JAX run's losses within 2e-4 (the
  JAX test's tolerance).
- A port save at stage 3 on data 2 × model 2 writes each rank's 2-D box
  in the JAX fragment layout; the JAX ``load_checkpoint`` on
  ``build_mesh(data=2, model=2)`` reads it bitwise, and so does the port
  at stage 1 on data 4.
"""

import json
import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models.gpt import gpt2_config as j_gpt2
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel import mesh as jmesh

from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ, ROWS = 512, 32, 8
GPT2 = ("gpt2_config", {"max_seq_len": SEQ, "vocab_size": VOCAB})


def _config(stage, data, tp):
    return {"train_micro_batch_size_per_gpu": ROWS // data,
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": stage}, "gradient_clipping": 1.0,
            "tensor_parallel": {"tp_size": tp}}


def _steps(n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [[{"input_ids": rng.integers(0, VOCAB, size=(ROWS, SEQ),
                                        dtype=np.int32)}] for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _model():
    return j_gpt2("tiny", max_seq_len=SEQ, vocab_size=VOCAB)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_tp")
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
    init = _np_tree(j_init(_model(), jax.random.PRNGKey(1)))
    steps = _steps()
    saved = jmesh._CURRENT_MESH
    try:
        jmesh.build_mesh(data=4, devices=jax.devices()[:4])
        je, *_ = deepspeed_tpu.initialize(model=_model(),
                                          config=_config(3, 4, 1),
                                          params=init)
        je.train_batch(iter(steps[0]))
        je.save_checkpoint(jax_dir)
        jax_saved = _np_tree(je.params)
        ref = [float(je.train_batch(iter(s))) for s in steps[1:]]
        port = spawn("checkpoint_tp", 4, model=GPT2, params=init,
                     steps=steps, jax_dir=jax_dir, save_dir=port_dir,
                     configs={"load": _config(1, 2, 2),
                              "save": _config(3, 2, 2),
                              "dp4": _config(1, 4, 1)})
        jmesh.build_mesh(data=2, model=2, devices=jax.devices()[:4])
        j2, *_ = deepspeed_tpu.initialize(model=_model(),
                                          config=_config(3, 2, 2),
                                          params=init)
        tag, _ = j2.load_checkpoint(port_dir)
        jax_read = _np_tree(j2.params)
    finally:
        jmesh._CURRENT_MESH = saved
    return {"jax_saved": jax_saved, "ref": ref, "port": port,
            "jax_read": jax_read, "jax_read_tag": tag, "port_dir": port_dir}


def _bitwise(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb), what
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=f"{what} {k}")


def test_jax_save_loads_on_data_x_model_and_trains_on(runs):
    for r in runs["port"]:
        assert r["jax_tag"] == "global_step1"
        _bitwise(r["jax_loaded"], runs["jax_saved"], "jax → port")
        np.testing.assert_allclose(r["losses"], runs["ref"], rtol=2e-4,
                                   atol=2e-4)


def test_port_save_has_2d_boxes_and_reads_in_jax(runs):
    port = runs["port"]
    saved = port[0]["saved"]
    for r in port:
        _bitwise(r["saved"], saved, "ranks agree")
    assert runs["jax_read_tag"] == "global_step1"
    _bitwise(runs["jax_read"], saved, "port → jax")
    metas = [json.load(open(os.path.join(runs["port_dir"], "global_step1",
                                         f"meta.p{p}.json")))
             for p in range(4)]
    # wq [L, D, 3·?]: 'model' on its output dim, the FSDP axes on D —
    # four fragments, one a rank, each a 2-D box
    wq = [m["index"]["params"]["layers.attn.wq"]["fragments"][0]
          for m in metas if "layers.attn.wq" in m["index"]["params"]]
    assert len(wq) == 4
    boxes = {(tuple(f["start"]), tuple(f["stop"])) for f in wq}
    assert len(boxes) == 4
    assert all(sum(a != 0 for a in f["start"]) <= 2 for f in wq)


def test_port_save_reloads_at_data_4(runs):
    for r in runs["port"]:
        assert r["dp4_tag"] == "global_step1"
        _bitwise(r["dp4_loaded"], runs["port"][0]["saved"], "2x2 → 4")
