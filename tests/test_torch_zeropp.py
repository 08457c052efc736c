"""ZeRO++ in the port: the quantized collectives of ``comm/quantized.py``
and the ZeRO++ engine step (gloo ranks on the CPU, tests/torch_dp.py)
against ``deepspeed_tpu.comm.quantized`` under ``shard_map`` and the JAX
ZeRO++ engine on ``build_mesh(data=d)``, from the same numpy inputs.

The port quantizes at 8 bits with K6's arithmetic (its plain version on
the CPU): the scale is absmax · fl(1/127) where the JAX functions' XLA
``quantize_blocks`` divides by 127 (ROADMAP C4), so a scale may differ by
one ulp and an int8 value by one at a rounding tie. Tolerances: scales
within one ulp, at least 99.9 % of int8 values equal and the rest within
one; the collectives' dequantized outputs within one quantization step
of the JAX ones; ZeRO++ losses within 1e-3 relative of the JAX engine's
over 4 steps, and the JAX criterion against the exact path
(tests/test_quantization.py:168). ZeRO++ checkpoints (the params one
flat leaf, each optimizer tree one too, each rank writing its chunk's
box) cross within the port and between the packages bitwise
(tests/test_quantization.py:180).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.comm import quantized as jq
from deepspeed_tpu.models.gpt import gpt2_config as j_gpt2
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.ops.quantizer import quantize_blocks as j_quantize
from deepspeed_tpu.parallel import mesh as jmesh

import torch
from deepspeed_tpu_torch.ops.quantizer import quantize_blocks_pallas
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ, GB = 128, 32, 8
GPT2 = ("gpt2_config", {"max_seq_len": SEQ, "vocab_size": VOCAB})
N = 4096


def _arrays(world):
    rng = np.random.default_rng(17 + world)
    return {"normal": rng.standard_normal((world, N)).astype(np.float32),
            "spread": (rng.standard_normal((world, N)) * np.exp(
                rng.uniform(-6, 6, (world, N // 256, 1))).repeat(
                    256, 1).reshape(world, N)).astype(np.float32)}


def _config(world, **zero):
    return {"train_micro_batch_size_per_gpu": GB // world,
            "optimizer": {"type": "adamw", "params": {"lr": 5e-3}},
            "gradient_clipping": 1.0,
            "zero_optimization": dict({"stage": 2}, **zero)}


QUANT = {"zero_quantized_weights": True, "zero_quantized_gradients": True}


def _batch(steps):
    rng = np.random.default_rng(42)
    batch = {"input_ids": rng.integers(0, VOCAB, size=(GB, SEQ),
                                       dtype=np.int32)}
    return [[batch] for _ in range(steps)]


@pytest.fixture(scope="module")
def init():
    return jax.tree.map(np.asarray, j_init(
        j_gpt2("tiny", max_seq_len=SEQ, vocab_size=VOCAB),
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def port(request, init):
    world = request.param
    runs = []
    if world == 2:
        runs = [{"name": "quant", "model": GPT2, "params": init,
                 "config": _config(2, **QUANT), "steps": _batch(8)},
                {"name": "exact", "model": GPT2, "params": init,
                 "config": _config(2), "steps": _batch(8)},
                {"name": "qgz_only", "model": GPT2, "params": init,
                 "config": _config(2, zero_quantized_gradients=True),
                 "steps": _batch(4)},
                {"name": "fp16", "model": GPT2,
                 "config": dict(_config(2, zero_quantized_weights=True),
                                fp16={"enabled": True}),
                 "mode": "raises"}]
    return world, spawn("zeropp_runs", world, arrays=_arrays(world),
                        runs=runs)


@pytest.fixture(scope="module")
def jax_side(init):
    """The JAX collectives under shard_map and the JAX ZeRO++ engine at
    dp 2."""
    saved = jmesh._CURRENT_MESH
    out = {}
    try:
        for world in (2, 4):
            mesh = jmesh.build_mesh(data=world,
                                    devices=jax.devices()[:world])
            for name, a in _arrays(world).items():
                def run(fn):
                    return np.asarray(jax.shard_map(
                        fn, mesh=mesh, in_specs=P("data", None),
                        out_specs=P("data"), check_vma=False)(
                        jnp.asarray(a)))
                out[(world, name)] = {
                    "gather": run(lambda x: jq.quantized_all_gather(
                        x.reshape(-1), "data")).reshape(world, -1),
                    "rs": run(lambda x: jq.quantized_reduce_scatter(
                        x.reshape(-1), "data")).reshape(world, -1),
                    "rs_sum": run(lambda x: jq.quantized_reduce_scatter(
                        x.reshape(-1), "data", mean=False)).reshape(
                        world, -1),
                    "rs4": run(lambda x: jq.quantized_reduce_scatter(
                        x.reshape(-1), "data", bits=4)).reshape(world, -1),
                    "a2a": run(lambda x: jq.all_to_all_quant_reduce(
                        x.reshape(-1), "data")).reshape(world, -1)}
        jmesh.build_mesh(data=2, devices=jax.devices()[:2])
        for name, zero, steps in (("quant", QUANT, 8), ("exact", {}, 8),
                                  ("qgz_only",
                                   {"zero_quantized_gradients": True}, 4)):
            je, *_ = deepspeed_tpu.initialize(
                model=j_gpt2("tiny", max_seq_len=SEQ, vocab_size=VOCAB),
                config=_config(2, **zero), params=init)
            out[name] = [float(je.train_batch(iter(s)))
                         for s in _batch(steps)]
    finally:
        jmesh._CURRENT_MESH = saved
    return out


def _step(a, bits=8):
    """Per element: the quantization step of its 256-block."""
    qmax = 127.0 if bits == 8 else 7.0
    b = np.abs(a.reshape(-1, 256)).max(1, keepdims=True) / qmax
    return np.repeat(b, 256, 1).reshape(a.shape)


@pytest.mark.parametrize("name", ["normal", "spread"])
def test_k6_scales_and_values_against_jax_quantize_blocks(name):
    """The 8-bit quantizer of the collectives against the JAX
    ``quantize_blocks`` (jitted, as inside shard_map)."""
    a = _arrays(4)[name].reshape(-1)
    q, s = quantize_blocks_pallas(torch.from_numpy(a))
    jqv, js, _ = jax.jit(lambda x: j_quantize(x, bits=8))(jnp.asarray(a))
    s, js = s.numpy(), np.asarray(js)
    ulp = np.spacing(np.abs(js))
    assert np.all(np.abs(s - js) <= ulp)
    q, jqv = q.numpy().astype(np.int32), np.asarray(jqv).astype(np.int32)
    assert np.mean(q == jqv) >= 0.999
    assert np.abs(q - jqv).max() <= 1


@pytest.mark.parametrize("op", ["gather", "rs", "rs_sum", "rs4", "a2a"])
@pytest.mark.parametrize("name", ["normal", "spread"])
def test_quantized_collectives_match_jax(port, jax_side, op, name):
    world, res = port
    want = jax_side[(world, name)][op]
    a = _arrays(world)[name]
    bits = 4 if op == "rs4" else 8
    for r, rr in enumerate(res):
        got = np.asarray(rr["coll"][name][op])
        if op == "gather":
            tol = _step(a.reshape(-1), bits)
            np.testing.assert_array_less(np.abs(got - want[r]),
                                         tol + 1e-30)
            np.testing.assert_array_less(np.abs(got - a.reshape(-1)),
                                         tol / 2 + 1e-6)
        else:
            # rank r's reduced chunk: the sum (or mean) over the ranks of
            # each rank's dequantized chunk r
            c = N // world
            steps = _step(a.reshape(-1), bits).reshape(world, world, c)
            bound = steps[:, r].sum(0) * (1.0 if op == "rs_sum"
                                          else 1.0 / world)
            np.testing.assert_array_less(np.abs(got - want[r]),
                                         bound + 1e-30)


def test_quantized_collectives_log_their_bytes(port):
    """Each call logged once under its name with the int8 (or packed
    int4) values and the scales it moves."""
    world, res = port
    b = res[0]["bytes"]
    per = N + N // 256 * 4            # int8 values + fp32 scales
    n_arrays = 2
    assert b["quantized_all_gather"] == n_arrays * per
    # rs, rs_sum and a2a at 8 bits, rs4 at 4 bits
    assert b["quantized_reduce_scatter"] == n_arrays * (
        3 * per + N // 2 + N // 256 * 4)
    assert "all_gather" not in b and "all_to_all" not in b


def test_zeropp_tracks_jax_engine(port, jax_side):
    """dp 2: qwZ + qgZ, qgZ alone and the exact path against the JAX
    engine's over the same steps."""
    world, res = port
    if world != 2:
        assert "quant" not in res[0]
        return
    for r in res:
        for name, n in (("quant", 4), ("exact", 4), ("qgz_only", 4)):
            np.testing.assert_allclose(r[name]["losses"][:n],
                                       jax_side[name][:n], rtol=1e-3,
                                       err_msg=name)
        assert r["quant"]["losses"] == res[0]["quant"]["losses"]


def test_zeropp_meets_jax_criterion_against_exact(port):
    """tests/test_quantization.py:168: it learns, and its last loss is
    near the exact path's."""
    world, res = port
    if world != 2:
        assert "exact" not in res[0]
        return
    quant, exact = res[0]["quant"]["losses"], res[0]["exact"]["losses"]
    assert quant[-1] < quant[0] * 0.8
    assert abs(quant[-1] - exact[-1]) < 0.15 * abs(exact[0])
    # each rank holds 1/dp of the padded flat buffer
    total = sum(np.asarray(x).size for x in jax.tree.leaves(
        res[0]["quant"]["params"]))
    assert res[0]["quant"]["chunk"][0] * 2 >= total


def test_zeropp_refuses_fp16(port):
    """tests/test_quantization.py:200: the JAX ValueError."""
    world, res = port
    if world != 2:
        assert "fp16" not in res[0]
        return
    assert "bf16" in res[0]["fp16"]


@pytest.fixture(scope="module")
def ckpt(init, tmp_path_factory):
    """The JAX ZeRO++ engine (qgZ) at dp 2 saves after 3 steps; the port's
    ranks do the same, reload their save, and load the JAX one; the JAX
    engine then loads the port's save."""
    tmp = tmp_path_factory.mktemp("zeropp_ckpt")
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
    conf = _config(2, zero_quantized_gradients=True)
    saved = jmesh._CURRENT_MESH
    try:
        jmesh.build_mesh(data=2, devices=jax.devices()[:2])
        je, *_ = deepspeed_tpu.initialize(
            model=j_gpt2("tiny", max_seq_len=SEQ, vocab_size=VOCAB),
            config=conf, params=init)
        for s in _batch(3):
            je.train_batch(iter(s))
        je.save_checkpoint(jax_dir)
        jax_flat = np.asarray(jax.device_get(je.params))
        port = spawn("zeropp_checkpoint", 2, model=GPT2, params=init,
                     config=conf, steps=_batch(3), jax_dir=jax_dir,
                     save_dir=port_dir)
        j2, *_ = deepspeed_tpu.initialize(
            model=j_gpt2("tiny", max_seq_len=SEQ, vocab_size=VOCAB),
            config=conf, params=init)
        tag, _ = j2.load_checkpoint(port_dir)
        jax_read = np.asarray(jax.device_get(j2.params))
    finally:
        jmesh._CURRENT_MESH = saved
    return {"jax_flat": jax_flat, "port": port, "jax_read": jax_read,
            "tag": tag}


def test_zeropp_checkpoint_round_trip_in_port(ckpt):
    for r in ckpt["port"]:
        assert r["tag"] == "global_step3"
        np.testing.assert_array_equal(r["reloaded"], r["saved"])
        for k in r["saved_opt"]:
            np.testing.assert_array_equal(r["reloaded_opt"][k],
                                          r["saved_opt"][k], err_msg=k)
        assert r["next_loss"][0] == r["next_loss"][1]


def test_zeropp_checkpoint_crosses_packages(ckpt):
    port = ckpt["port"][0]
    assert ckpt["tag"] == "global_step3" and port["jax_tag"] == "global_step3"
    np.testing.assert_array_equal(ckpt["jax_read"], port["saved"])
    np.testing.assert_array_equal(port["jax_loaded"], ckpt["jax_flat"])
