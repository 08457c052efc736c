"""Megatron-LM GPT import: deepspeed_tpu_torch's load_megatron_checkpoint
against deepspeed_tpu's, on the CPU (the scenarios of tests/test_megatron.py).

No megatron-lm package exists offline, so the fixture writes a checkpoint
in the documented on-disk layout (nested language_model dicts, the fused
query_key_value in the head-major per-head [q|k|v] interleave) from a
JAX-drawn GPT-2 tree. Both loaders read it: configs equal, every leaf
identical (fp32, bitwise), and the port's logits of the loaded tree within
1e-5 relative of the JAX forward of the original.
"""

import argparse

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.models.gpt import gpt2_config
from deepspeed_tpu.models.megatron import load_megatron_checkpoint as jload

from deepspeed_tpu_torch.models import load_megatron_checkpoint as tload
from deepspeed_tpu_torch.models import transformer as ttf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _write_ckpt(tmp_path, cfg, params, attn="self_attention",
                core="encoder", with_args=True, untied=False):
    """Our tree → a Megatron nested state dict (the inverse mapping)."""
    H, dh, D, L = (cfg.num_heads, cfg.head_dim, cfg.hidden_size,
                   cfg.num_layers)
    a, m = params["layers"]["attn"], params["layers"]["mlp"]

    def t(x):
        return torch.tensor(np.ascontiguousarray(np.asarray(x)))

    enc = {}
    for i in range(L):
        fused_w = np.stack([np.asarray(a[k][i]).T.reshape(H, dh, D)
                            for k in ("wq", "wk", "wv")],
                           axis=1).reshape(3 * H * dh, D)
        fused_b = np.stack([np.asarray(a[k][i]).reshape(H, dh)
                            for k in ("bq", "bk", "bv")], axis=1).reshape(-1)
        enc[f"layers.{i}.{attn}.query_key_value.weight"] = t(fused_w)
        enc[f"layers.{i}.{attn}.query_key_value.bias"] = t(fused_b)
        enc[f"layers.{i}.{attn}.dense.weight"] = t(np.asarray(a["wo"][i]).T)
        enc[f"layers.{i}.{attn}.dense.bias"] = t(a["bo"][i])
        for ours, theirs in (("ln1", "input_layernorm"),
                             ("ln2", "post_attention_layernorm")):
            enc[f"layers.{i}.{theirs}.weight"] = t(
                params["layers"][ours]["scale"][i])
            enc[f"layers.{i}.{theirs}.bias"] = t(
                params["layers"][ours]["bias"][i])
        enc[f"layers.{i}.mlp.dense_h_to_4h.weight"] = t(
            np.asarray(m["wi"][i]).T)
        enc[f"layers.{i}.mlp.dense_h_to_4h.bias"] = t(m["bi"][i])
        enc[f"layers.{i}.mlp.dense_4h_to_h.weight"] = t(
            np.asarray(m["wo"][i]).T)
        enc[f"layers.{i}.mlp.dense_4h_to_h.bias"] = t(m["bo"][i])
    enc["final_layernorm.weight"] = t(params["final_norm"]["scale"])
    enc["final_layernorm.bias"] = t(params["final_norm"]["bias"])
    lm = {"embedding": {
        "word_embeddings": {"weight": t(params["embed"]["tokens"])},
        "position_embeddings": {"weight": t(params["embed"]["pos"])}},
        core: enc}
    if untied:
        lm["output_layer"] = {"weight": t(np.asarray(params["lm_head"]).T)}
    ckpt = {"model": {"language_model": lm}}
    if with_args:
        ckpt["args"] = argparse.Namespace(
            num_attention_heads=H, hidden_size=D, num_layers=L,
            layernorm_epsilon=cfg.norm_eps)
    d = tmp_path / "megatron" / "mp_rank_00"
    d.mkdir(parents=True)
    torch.save(ckpt, str(d / "model_optim_rng.pt"))
    return str(tmp_path / "megatron")


def _check(path, cfg, params, **kw):
    jcfg, jp = jload(path, **kw)
    tcfg, tp = tload(path, device="cpu", **kw)
    assert tcfg.__dict__ == jcfg.__dict__
    jl, tl = _flat(jp), _flat(tp)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert tl[k].dtype == torch.float32, k
        np.testing.assert_array_equal(tl[k].numpy(), jl[k], err_msg=k)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    want = np.asarray(jtf.forward(cfg, params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = ttf.forward(tcfg, tp, torch.from_numpy(tokens)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5
    return tcfg, tp


@pytest.mark.parametrize("naming", [("self_attention", "encoder"),
                                    ("attention", "transformer")])
def test_load_matches_jax_loader(tmp_path, naming):
    cfg = gpt2_config("tiny", activation="gelu_exact", max_seq_len=64)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    path = _write_ckpt(tmp_path, cfg, params, *naming)
    tcfg, _ = _check(path, cfg, params)
    assert tcfg.num_heads == cfg.num_heads and tcfg.tie_embeddings


def test_untied_output_layer(tmp_path):
    cfg = gpt2_config("tiny", activation="gelu_exact", max_seq_len=64,
                      tie_embeddings=False)
    params = jtf.init_params(cfg, jax.random.PRNGKey(2))
    path = _write_ckpt(tmp_path, cfg, params, untied=True)
    tcfg, tp = _check(path, cfg, params)
    assert not tcfg.tie_embeddings and "lm_head" in tp


def test_heads_required_without_args(tmp_path):
    cfg = gpt2_config("tiny", activation="gelu_exact", max_seq_len=64)
    params = jtf.init_params(cfg, jax.random.PRNGKey(1))
    path = _write_ckpt(tmp_path, cfg, params, with_args=False)
    with pytest.raises(ValueError, match="num_heads"):
        tload(path, device="cpu")
    _check(path, cfg, params, num_heads=cfg.num_heads)


def test_error_cases(tmp_path):
    with pytest.raises(FileNotFoundError, match="mp_rank_00"):
        tload(str(tmp_path / "nope"), device="cpu")
    cfg = gpt2_config("tiny", activation="gelu_exact", max_seq_len=64)
    path = _write_ckpt(tmp_path, cfg,
                       jtf.init_params(cfg, jax.random.PRNGKey(3)))
    (tmp_path / "megatron" / "mp_rank_01").mkdir()
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        tload(path, device="cpu")
