"""deepspeed_tpu_torch.models against deepspeed_tpu.models on the CPU.

The same numpy parameters and inputs go through the JAX functions and
their PyTorch ports. Tolerance: fp32, atol/rtol 1e-5 (the two frameworks
sum the matrix products in different orders; RoPE angles agree to ~1 ulp).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.llama import llama3_config as jllama
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.llama import llama3_config as tllama
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(seed=0, **kw):
    jcfg = jllama("tiny", vocab_size=256, **kw)
    tcfg = tllama("tiny", vocab_size=256, **kw)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(_np_tree(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def test_config_fields_and_properties_match():
    jcfg, tcfg = jllama("8b"), tllama("8b")
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "kv_heads", "head_dim", "q_dim", "ffn_size", "rope_dim",
              "is_glu", "qkv_bias", "out_bias", "ln_bias", "has_ln2",
              "has_final_norm", "rope_theta", "norm_eps"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.num_params() == jcfg.num_params()


def test_params_from_jax_round_trip():
    _, _, jp, tp = _setup()
    jflat = jax.tree_util.tree_flatten_with_path(_np_tree(jp))[0]
    for path, leaf in jflat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
    bf = params_from_jax(_np_tree(jp), device="cpu", dtype=torch.bfloat16)
    # every floating leaf takes the engine dtype, norm scales included
    assert bf["layers"]["ln1"]["scale"].dtype == torch.bfloat16
    assert bf["final_norm"]["scale"].dtype == torch.bfloat16


def test_embed_rope_qkv_match():
    jcfg, tcfg, jp, tp = _setup(1)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, size=(2, 7)).astype(np.int32)
    positions = (np.arange(7)[None] + np.array([[0], [13]])).astype(np.int32)
    jx = jt.embed_tokens(jcfg, jp["embed"], jnp.asarray(tokens),
                         jnp.asarray(positions))
    tx = tt.embed_tokens(tcfg, tp["embed"], torch.from_numpy(tokens),
                         torch.from_numpy(positions))
    _close(tx, jx)
    js, jc = jt.rope_table(jcfg, jnp.asarray(positions))
    ts, tc = tt.rope_table(tcfg, torch.from_numpy(positions))
    _close(ts, js)
    _close(tc, jc)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in tp["layers"].items()}
    jh = jt._norm(jcfg, jl["ln1"], jx)
    th = tt._norm(tcfg, tl["ln1"], tx)
    _close(th, jh)
    for a, b in zip(tt.qkv_project(tcfg, tl["attn"], th, ts, tc),
                    jt.qkv_project(jcfg, jl["attn"], jh, js, jc)):
        _close(a, b)


def test_mlp_block_and_logits_match():
    jcfg, tcfg, jp, tp = _setup(2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, jcfg.hidden_size)).astype(np.float32)
    a = rng.standard_normal((2, 5, jcfg.hidden_size)).astype(np.float32)
    jl = jax.tree.map(lambda t: t[1], jp["layers"])
    tl = {k: {kk: vv[1] for kk, vv in v.items()}
          for k, v in tp["layers"].items()}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(tt._mlp(tcfg, tl["mlp"], tx), jt._mlp(jcfg, jl["mlp"], jx))
    jpre = jt._norm(jcfg, jl["ln1"], jx)
    tpre = tt._norm(tcfg, tl["ln1"], tx)
    jo, _ = jt.block_combine(jcfg, jl, jx, jpre, jnp.asarray(a), None)
    to, taux = tt.block_combine(tcfg, tl, tx, tpre, torch.from_numpy(a))
    _close(to, jo)
    assert float(taux) == 0.0
    _close(tt.attn_out_project(tcfg, tl["attn"], torch.from_numpy(
               a[..., :jcfg.q_dim].reshape(2, 5, jcfg.num_heads, -1))),
           jt.attn_out_project(jcfg, jl["attn"], jnp.asarray(
               a[..., :jcfg.q_dim].reshape(2, 5, jcfg.num_heads, -1))))
    jlog = jt.lm_logits(jcfg, jp, jx)
    tlog = tt.lm_logits(tcfg, tp, tx)
    assert tlog.dtype == torch.float32
    _close(tlog, jlog)


def test_bf16_logits_keep_fp32_precision():
    """bf16 hidden states and head: both packages return the fp32 sum of
    the exact bf16 products (no bf16 rounding of the logits, whose step
    at |logit| ~ 1 is 8e-3). Tolerance 1e-4: summation order only."""
    jcfg, tcfg, jp, _ = _setup(5, tie_embeddings=True)
    x = np.random.default_rng(5).standard_normal(
        (2, 3, jcfg.hidden_size)).astype(np.float32)
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tpb = params_from_jax(_np_tree(jp), device="cpu", dtype=torch.bfloat16)
    jlog = jt.lm_logits(jcfg, jpb, jnp.asarray(x, jnp.bfloat16))
    tlog = tt.lm_logits(tcfg, tpb, torch.from_numpy(x).bfloat16())
    assert tlog.dtype == torch.float32 and jlog.dtype == jnp.float32
    _close(tlog, jlog, dict(rtol=1e-4, atol=1e-4))
    rounded = tlog.bfloat16().float()
    assert not torch.equal(rounded, tlog)


def test_tied_softcap_logits_match():
    jcfg, tcfg, jp, tp = _setup(3, tie_embeddings=True, logit_softcap=30.0)
    x = np.random.default_rng(3).standard_normal(
        (1, 3, jcfg.hidden_size)).astype(np.float32)
    _close(tt.lm_logits(tcfg, tp, torch.from_numpy(x)),
           jt.lm_logits(jcfg, jp, jnp.asarray(x)))


def test_dot_product_attention_matches():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    for kw in ({"causal": True}, {"causal": True, "window": 3},
               {"causal": False}):
        _close(tt.dot_product_attention(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), **kw),
               jt.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **kw))


def test_init_params_layout_and_seed():
    tcfg = tllama("tiny", vocab_size=256)
    jcfg = jllama("tiny", vocab_size=256)
    jp = _np_tree(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    p1 = tt.init_params(tcfg, g1)
    p2 = tt.init_params(tcfg, g2)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        a, b = p1, p2
        for k in path:
            a, b = a[k.key], b[k.key]
        assert tuple(a.shape) == leaf.shape, path
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    std = float(p1["layers"]["attn"]["wq"].std())
    assert abs(std - tcfg.init_std) < 0.1 * tcfg.init_std
