"""The port's ZeRO plan (runtime/zero/sharding.py), stage-3 partition specs
(models/transformer.py) and chunk schedule (runtime/zero/overlap.py)
against deepspeed_tpu's, with no processes: a port ``Mesh({"data": n})``
against a JAX mesh over n CPU devices.

The plan must pick the JAX dim for every leaf of the tiny Llama, GPT-2 and
Mixtral trees at dp 2, 4 and 8 and every stage — that is what makes a
rank's shard the ``(start, stop)`` box a JAX process holds. Everything
here is exact: specs, chunk bounds, byte counts, fractions.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.models.gpt import gpt2_config as j_gpt2
from deepspeed_tpu.models.llama import llama3_config as j_llama3
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.models.transformer import partition_specs as j_specs
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.zero import overlap as jovl
from deepspeed_tpu.runtime.zero import sharding as jsh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.mixtral import mixtral_config as t_mixtral
from deepspeed_tpu_torch.models.transformer import init_params as t_init
from deepspeed_tpu_torch.models.transformer import partition_specs as t_specs
from deepspeed_tpu_torch.parallel.mesh import Mesh
from deepspeed_tpu_torch.runtime.zero import overlap as tovl
from deepspeed_tpu_torch.runtime.zero import sharding as tsh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODELS = {"llama": (j_llama3, dt.llama3_config, {}),
          "gpt2": (j_gpt2, dt.gpt2_config, {}),
          "mixtral": (j_mixtral, t_mixtral, {"hidden_size": 128,
                                             "intermediate_size": 256})}


def _spec_tuple(s):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in s)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, (jc, tc, kw) in MODELS.items():
        jcfg, tcfg = jc("tiny", **kw), tc("tiny", **kw)
        abstract = jax.eval_shape(lambda r: j_init(jcfg, r),
                                  jax.random.PRNGKey(0))
        tparams = t_init(tcfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
        out[name] = (jcfg, tcfg, abstract, tparams)
    return out


def _jax_mesh(n):
    return jmesh.build_mesh(data=n, devices=jax.devices()[:n],
                            set_current=False)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_partition_specs_match_jax(trees, name):
    jcfg, tcfg, _, _ = trees[name]
    for stage in (0, 3):
        # plain, tensor parallel ('model' on AutoTP's dims beside the
        # FSDP axes) and MiCS (stage-3 shards within the sub-group)
        for kw in ({}, {"tp": True}, {"mics": True}, {"tp": True,
                                                      "mics": True}):
            want = {k: _spec_tuple(v) for k, v in _flat(jax.tree.map(
                lambda s: s, j_specs(jcfg, stage, **kw),
                is_leaf=lambda x: isinstance(x, P))).items()}
            got = {k: _spec_tuple(v) for k, v in _flat(
                t_specs(tcfg, stage, **kw)).items()}
            assert got == want, (name, stage, kw)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_plan_picks_the_jax_dims(trees, name, n):
    """grad and state specs of ZeroShardingPlan at every stage, and
    shard_over_dp on unsharded leaves, equal the JAX ones."""
    jcfg, tcfg, abstract, tparams = trees[name]
    jm, tm = _jax_mesh(n), Mesh({"data": n})
    for stage in (0, 1, 2, 3):
        jp = jsh.ZeroShardingPlan(jm, stage, j_specs(jcfg, stage), abstract)
        tp = tsh.ZeroShardingPlan(tm, stage, t_specs(tcfg, stage), tparams)
        for attr in ("param_specs", "grad_specs", "state_specs"):
            want = {k: _spec_tuple(v) for k, v in _flat(jax.tree.map(
                lambda s: s, getattr(jp, attr),
                is_leaf=lambda x: isinstance(x, P))).items()}
            got = {k: _spec_tuple(v) for k, v in _flat(
                getattr(tp, attr)).items()}
            assert got == want, (name, n, stage, attr)
    for path, x in _flat(tparams).items():
        assert _spec_tuple(tsh.shard_over_dp(x.shape, None, tm)) == \
            _spec_tuple(jsh.shard_over_dp(x.shape, None, jm)), path


@pytest.mark.parametrize("tp", [False, True], ids=["dp", "tp"])
@pytest.mark.parametrize("d,e", [(1, 2), (2, 2), (1, 4), (2, 4)])
def test_plan_over_data_and_expert_matches_jax(trees, d, e, tp):
    """The MoE preset's plan at data × expert (× 'model' specs): the
    expert leaves keep 'expert' on E and take the data axes on another
    dim (or extend E when it divides by ep · dp), dense leaves take the
    whole family — the JAX specs at every stage; the port's expert dim
    is the one its engine cuts."""
    jcfg, tcfg, abstract, tparams = trees["mixtral"]
    jm = jmesh.build_mesh(data=d, expert=e, devices=jax.devices()[:d * e],
                          set_current=False)
    tm = Mesh({"data": d, "expert": e})
    for stage in (0, 1, 2, 3):
        jp = jsh.ZeroShardingPlan(jm, stage, j_specs(jcfg, stage, tp=tp),
                                  abstract)
        tp_ = tsh.ZeroShardingPlan(tm, stage, t_specs(tcfg, stage, tp=tp),
                                   tparams)
        for attr in ("param_specs", "grad_specs", "state_specs"):
            want = {k: _spec_tuple(v) for k, v in _flat(jax.tree.map(
                lambda s: s, getattr(jp, attr),
                is_leaf=lambda x: isinstance(x, P))).items()}
            got = {k: _spec_tuple(v) for k, v in _flat(
                getattr(tp_, attr)).items()}
            assert got == want, (d, e, stage, attr)
    specs = _flat(t_specs(tcfg, 3, tp=tp))
    for path, spec in specs.items():
        ed = tsh.expert_dim(spec)
        assert (ed == 1) == (path.split("/")[-1] in ("wg", "wi", "wo")
                             and "/moe/" in f"/{path}/"
                             and "shared" not in path), path


def test_shard_over_dp_edge_cases():
    """Replicated when no dim divides (warned once); an already-sharded DP
    dim is extended; the largest dim wins; dp 1 changes nothing."""
    for n in (2, 4, 8):
        jm, tm = _jax_mesh(n), Mesh({"data": n})
        for shape, spec in (((3, 5), None), ((7,), None), ((8, 16), None),
                            ((16, 8), None), ((6, 4, 10), None),
                            ((16, 32), (None, "data_inner")),
                            ((16, 32), (("data_inner",), None)),
                            ((), None)):
            jspec = None if spec is None else P(*spec)
            assert _spec_tuple(tsh.shard_over_dp(shape, spec, tm)) == \
                _spec_tuple(jsh.shard_over_dp(shape, jspec, jm)), \
                (n, shape, spec)
    one = Mesh({"data": 1})
    assert tsh.shard_over_dp((8, 8), None, one) == (None, None)


def test_shard_boxes_cover_the_leaf():
    """Each rank's block along the chosen dim, and its box in full-leaf
    coordinates, tile the leaf."""
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    for dim in (0, 1, 2):
        n = 2
        parts = [tsh.shard_of(x, dim, r, n) for r in range(n)]
        assert torch.equal(torch.cat(parts, dim=dim), x)
        boxes = [tsh.box(x.shape, dim, r, n) for r in range(n)]
        for r, (start, stop) in enumerate(boxes):
            sl = tuple(slice(a, b) for a, b in zip(start, stop))
            assert torch.equal(x[sl], parts[r])
    assert tsh.box((3, 4), None, 1, 2) == ([0, 0], [3, 4])


def test_chunk_bounds_and_overlap_fraction_match_jax():
    for layers in (0, 1, 5, 16):
        for per in (0, 100, 4096):
            for bucket in (0, 1, 150, 4096, 10 ** 9):
                assert tovl.chunk_bounds(layers, per, bucket) == \
                    jovl.chunk_bounds(layers, per, bucket)
    for c, m, t in ((1.0, 0.5, 1.2), (1.0, 0.5, 1.5), (1.0, 0.5, 0.9),
                    (0.0, 1.0, 1.0), (2.0, 3.0, 4.0), (1.0, 1.0, -1.0)):
        assert tovl.overlap_fraction(c, m, t) == \
            jovl.overlap_fraction(c, m, t)
    assert tovl.dense_spec((None, ("data", "data_inner", "expert"),
                            "model")) == \
        _spec_tuple(jovl.dense_spec(P(None, ("data", "data_inner",
                                             "expert"), "model")))


@pytest.mark.parametrize("name", ["llama", "mixtral"])
def test_overlap_plan_matches_jax(trees, name):
    """Chunk count, bounds, bytes and the transient footprint of the
    stage-3 plan at several buckets, prefetch depths and both backward
    modes."""
    jcfg, tcfg, abstract, tparams = trees[name]
    per_layer = sum(int(np.prod(x.shape[1:])) * 4
                    for x in jax.tree.leaves(abstract["layers"]))
    for n in (2, 4):
        jm, tm = _jax_mesh(n), Mesh({"data": n})
        for bucket in (0, per_layer, per_layer + 1, 10 * per_layer):
            for prefetch in (0, 1, 2):
                for regather in (True, False):
                    jp = jovl.OverlapPlan(
                        jm, j_specs(jcfg, 3)["layers"], abstract["layers"],
                        bucket_bytes=bucket, prefetch=prefetch,
                        regather=regather)
                    tp = tovl.OverlapPlan(
                        tm, t_specs(tcfg, 3)["layers"], tparams["layers"],
                        bucket_bytes=bucket, prefetch=prefetch,
                        regather=regather)
                    key = (n, bucket, prefetch, regather)
                    assert tp.bounds == jp.bounds, key
                    assert tp.n_chunks == jp.n_chunks, key
                    assert tp.per_layer_bytes == jp.per_layer_bytes, key
                    assert tp.transient_bytes() == jp.transient_bytes(), key
                    assert tp.max_chunk_bytes() == jp.max_chunk_bytes(), key
                    assert tp.describe() == jp.describe(), key
