"""The port's 1-bit error-feedback all-reduce (deepspeed_tpu_torch/comm/
compressed.py) against deepspeed_tpu/comm/compressed.py on the same
numpy inputs: the packers, the padding and the error buffers in one
process; ``compressed_allreduce`` on four gloo ranks (tests/torch_dp.py)
against the JAX function in ``shard_map`` over four CPU devices, on the
plain rank layout and on a two-slice one whose positions on 'data' are
not the ranks' order. The scenarios of tests/test_compressed_comm.py:
the round trip, the numpy transcription of the two-stage exchange,
identical workers, and error-feedback conservation.

Tolerances: signs and packed bytes are exact; one exchange's output and
error buffers within 1e-5 of the JAX function and of the numpy
reference (fp32 means in other orders); the conservation identity
within 1e-3 over 50 exchanges (the JAX test's).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.comm import compressed as jc
from deepspeed_tpu.parallel import mesh as jmesh

from deepspeed_tpu_torch.comm import compressed as tc
from torch_dp import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 4
#: rank r's slice: positions on 'data' of the hybrid layout are
#: [0, 2 | 1, 3] (slice 0 holds ranks 0 and 2)
SLICE_IDS = [0, 1, 0, 1]
CONSERVE_T = 50


def _numpy_reference(xs, we, se):
    """tests/test_compressed_comm.py's transcription: worker i serves
    chunk i."""
    wn, n = xs.shape
    cs = n // wn

    def comp(x):
        scale = np.abs(x).mean()
        d = scale * np.where(x >= 0, 1.0, -1.0)
        return d.astype(np.float32), (x - d).astype(np.float32)

    d = np.zeros_like(xs)
    nwe = np.zeros_like(we)
    for w in range(wn):
        d[w], nwe[w] = comp(xs[w] + we[w])
    avg = d.mean(axis=0)
    out = np.zeros(n, np.float32)
    nse = np.zeros_like(se)
    for i in range(wn):
        sl = slice(i * cs, (i + 1) * cs)
        out[sl], nse[i] = comp(avg[sl] + se[i])
    return out, nwe, nse


def _cases():
    rng = np.random.default_rng(2)
    n = jc.padded_size(200, W)
    ref = {"xs": rng.standard_normal((W, n)).astype(np.float32),
           "we": (rng.standard_normal((W, n)) * 0.1).astype(np.float32),
           "se": (rng.standard_normal((W, n // W)) * 0.1).astype(
               np.float32)}
    m = jc.padded_size(64, W)
    x = (0.7 * np.random.default_rng(1).choice([-1.0, 1.0], size=m)
         ).astype(np.float32)
    same = {"xs": np.broadcast_to(x, (W, m)).copy(),
            "we": np.zeros((W, m), np.float32),
            "se": np.zeros((W, m // W), np.float32)}
    k = jc.padded_size(100, W)
    conserve = {"xs": np.random.default_rng(2).standard_normal(
        (W, k)).astype(np.float32), "we": np.zeros((W, k), np.float32),
        "se": np.zeros((W, k // W), np.float32), "steps": CONSERVE_T}
    return {"reference": ref, "identical": same, "conserve": conserve}


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def ranks(cases):
    return spawn("compressed", W, cases=cases, slice_ids=SLICE_IDS)


@pytest.fixture(scope="module")
def jax_out(cases):
    """The JAX function in shard_map over 4 devices: one exchange of the
    reference and identical cases, and the first exchange of the
    conservation case."""
    mesh = jmesh.build_mesh(data=W, devices=jax.devices()[:W],
                            set_current=False)
    f = jax.jit(shard_map(partial(jc.compressed_allreduce,
                                  axis_name="data"), mesh=mesh,
                          in_specs=(P("data"),) * 3,
                          out_specs=(P("data"),) * 3))
    out = {}
    for name, c in cases.items():
        o, we, se = f(jnp.asarray(c["xs"]).reshape(-1),
                      jnp.asarray(c["we"]).reshape(-1),
                      jnp.asarray(c["se"]).reshape(-1))
        n = c["xs"].shape[1]
        out[name] = (np.asarray(o).reshape(W, n),
                     np.asarray(we).reshape(W, n),
                     np.asarray(se).reshape(W, n // W))
    return out


def _by_position(ranks, layout):
    """Each rank's result, ordered by its position on 'data'."""
    return sorted((r[layout] for r in ranks), key=lambda x: x["pos"])


def test_pack_unpack_and_buffers_match_jax():
    """The packed bytes and the unpacked signs are the JAX functions'
    (zero counts as positive); padded_size and init_error_buffers."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(128).astype(np.float32)
    x[::17] = 0.0
    packed = tc.pack_signs(torch.from_numpy(x))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jc.pack_signs(jnp.asarray(x))))
    np.testing.assert_array_equal(tc.unpack_signs(packed).numpy(),
                                  np.where(x >= 0, 1.0, -1.0))
    np.testing.assert_array_equal(
        tc.unpack_signs(packed).numpy(),
        np.asarray(jc.unpack_signs(jnp.asarray(packed.numpy()))))
    for n, w in ((1, 1), (100, 4), (200, 8), (64, 8)):
        assert tc.padded_size(n, w) == jc.padded_size(n, w)
    we, se = tc.init_error_buffers(64, 8)
    jwe, jse = jc.init_error_buffers(64, 8)
    assert we.shape == jwe.shape and se.shape == jse.shape
    assert not we.any() and not se.any()
    with pytest.raises(AssertionError):
        tc.init_error_buffers(60, 8)


@pytest.mark.parametrize("layout", ["flat", "hybrid"])
def test_exchange_matches_jax_and_numpy_reference(ranks, jax_out, cases,
                                                  layout):
    """One exchange: every position's output is the JAX function's and
    the numpy transcription's, and so are its error buffers — also on the
    hybrid layout, whose groups rank their members otherwise than their
    positions. The logger records n // 8 + 4 bytes a call."""
    c = cases["reference"]
    ref_out, ref_we, ref_se = _numpy_reference(c["xs"], c["we"], c["se"])
    j_out, j_we, j_se = jax_out["reference"]
    got = _by_position(ranks, layout)
    assert [g["pos"] for g in got] == list(range(W))
    n = c["xs"].shape[1]
    for p, g in enumerate(got):
        r = g["reference"]
        for want in (ref_out, j_out[p]):
            np.testing.assert_allclose(r["out"][0], want, rtol=1e-5,
                                       atol=1e-5)
        for want in (ref_we[p], j_we[p]):
            np.testing.assert_allclose(r["we"], want, rtol=1e-5, atol=1e-5)
        for want in (ref_se[p], j_se[p]):
            np.testing.assert_allclose(r["se"], want, rtol=1e-5, atol=1e-5)
        assert r["bytes"] == {"compressed_allreduce": n // 8 + 4}
    if layout == "hybrid":
        # ranks 0, 2 hold positions 0, 1 (slice 0); ranks 1, 3 hold 2, 3
        assert [r["hybrid"]["pos"] for r in ranks] == [0, 2, 1, 3]


def test_identical_workers_compress_losslessly(ranks, jax_out, cases):
    """Identical tensors of uniform |x| pass both stages exactly: the
    output is x and both residuals are zero (as in JAX)."""
    x = cases["identical"]["xs"][0]
    for g in _by_position(ranks, "flat"):
        r = g["identical"]
        np.testing.assert_allclose(r["out"][0], x, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["we"], 0.0, atol=1e-6)
        np.testing.assert_allclose(r["se"], 0.0, atol=1e-6)
    np.testing.assert_allclose(jax_out["identical"][0][0], x, atol=1e-6)


def test_error_feedback_conservation(ranks, jax_out, cases):
    """(Σ_t out_t)/T = exact mean − (mean_w we_T + se_T)/T over 50
    exchanges of the same inputs (the port's exchanges), the first one
    equal to the JAX function's, and the time average beating one
    compressed step by 3x."""
    c = cases["conserve"]
    exact = c["xs"].mean(axis=0)
    got = _by_position(ranks, "flat")
    outs = got[0]["conserve"]["out"]
    assert outs.shape[0] == CONSERVE_T
    for g in got:
        np.testing.assert_array_equal(g["conserve"]["out"], outs)
    np.testing.assert_allclose(outs[0], jax_out["conserve"][0][0],
                               rtol=1e-5, atol=1e-5)
    we = np.stack([g["conserve"]["we"] for g in got])
    se = np.concatenate([g["conserve"]["se"] for g in got])
    total = outs.sum(axis=0)
    np.testing.assert_allclose(
        total / CONSERVE_T, exact - (we.mean(axis=0) + se) / CONSERVE_T,
        atol=1e-3)
    first_err = np.abs(outs[0] - exact).mean()
    avg_err = np.abs(total / CONSERVE_T - exact).mean()
    assert avg_err < first_err / 3.0, (avg_err, first_err)
