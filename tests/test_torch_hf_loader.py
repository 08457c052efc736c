"""The port's HF interop (deepspeed_tpu_torch.models.hf_loader and its
safetensors module) against the JAX package's hf_loader and against
transformers' own torch forward, on the CPU (mirrors
tests/test_hf_interop.py).

Every family's tiny HF model is built from a local config and saved with
``save_pretrained``. Tolerances:
- the port's loaded parameter tree is BITWISE the JAX loader's (fp32: the
  same transposes, splits, permutations and folds in the same order);
- the port's fp32 logits are within 2e-4 of transformers' forward (two
  fp32 implementations of the same function summing in different orders);
- the port's export of a tree is BYTE-identical to the JAX export of the
  same tree (same safetensors layout, same config.json), and transformers
  reloads it with logits within 2e-3 of the port's (the tolerance of the
  reference's own round-trip tests);
- the safetensors writer is byte-identical to safetensors.torch.save_file.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.models import hf_loader as jhf
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import hf_loader as thf
from deepspeed_tpu_torch.models import safetensors_io
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.parallel.moe import serving_moe_fn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
EXPORT_TOL = dict(rtol=2e-3, atol=2e-3)


def _hf(kind):
    import transformers as tr
    table = {
        "llama": (tr.LlamaConfig, tr.LlamaForCausalLM, dict(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
            max_position_embeddings=128, rms_norm_eps=1e-6,
            tie_word_embeddings=False)),
        "llama_tied": (tr.LlamaConfig, tr.LlamaForCausalLM, dict(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
            max_position_embeddings=128, tie_word_embeddings=True)),
        "internlm": (tr.LlamaConfig, tr.LlamaForCausalLM, dict(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, vocab_size=256,
            max_position_embeddings=128, attention_bias=True,
            tie_word_embeddings=False)),
        "mistral": (tr.MistralConfig, tr.MistralForCausalLM, dict(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
            max_position_embeddings=128, sliding_window=64)),
        "qwen2": (tr.Qwen2Config, tr.Qwen2ForCausalLM, dict(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
            max_position_embeddings=128, tie_word_embeddings=False)),
        "mixtral": (tr.MixtralConfig, tr.MixtralForCausalLM, dict(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
            max_position_embeddings=128, num_local_experts=4,
            num_experts_per_tok=2)),
        "qwen2_moe": (tr.Qwen2MoeConfig, tr.Qwen2MoeForCausalLM, dict(
            hidden_size=64, intermediate_size=96, moe_intermediate_size=96,
            shared_expert_intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, num_experts=4,
            num_experts_per_tok=2, vocab_size=256,
            max_position_embeddings=128, norm_topk_prob=False,
            tie_word_embeddings=False)),
        "gemma": (tr.GemmaConfig, tr.GemmaForCausalLM, dict(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=1, head_dim=32,
            vocab_size=256, max_position_embeddings=128,
            hidden_act="gelu_pytorch_tanh",
            hidden_activation="gelu_pytorch_tanh")),
        "gpt_neox": (tr.GPTNeoXConfig, tr.GPTNeoXForCausalLM, dict(
            hidden_size=64, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, vocab_size=256,
            max_position_embeddings=128, rotary_pct=0.25,
            use_parallel_residual=True, tie_word_embeddings=False)),
        "gpt2": (tr.GPT2Config, tr.GPT2LMHeadModel, dict(
            n_embd=64, n_layer=2, n_head=4, vocab_size=256,
            n_positions=128)),
        "gpt_neo": (tr.GPTNeoConfig, tr.GPTNeoForCausalLM, dict(
            hidden_size=64, num_layers=2, num_heads=4, vocab_size=256,
            max_position_embeddings=128, window_size=8,
            attention_types=[[["global", "local"], 1]])),
        "opt": (tr.OPTConfig, tr.OPTForCausalLM, dict(
            hidden_size=64, ffn_dim=256, num_hidden_layers=2,
            num_attention_heads=4, vocab_size=256,
            max_position_embeddings=128, word_embed_proj_dim=64)),
        "bloom": (tr.BloomConfig, tr.BloomForCausalLM, dict(
            hidden_size=64, n_layer=2, n_head=4, vocab_size=512)),
        "falcon_mqa": (tr.FalconConfig, tr.FalconForCausalLM, dict(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            vocab_size=256, multi_query=True,
            new_decoder_architecture=False, parallel_attn=True, bias=False,
            alibi=False, max_position_embeddings=128)),
        "falcon_new": (tr.FalconConfig, tr.FalconForCausalLM, dict(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_kv_heads=2, vocab_size=256, new_decoder_architecture=True,
            parallel_attn=True, bias=False, alibi=False,
            max_position_embeddings=128)),
        "falcon_bias": (tr.FalconConfig, tr.FalconForCausalLM, dict(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_kv_heads=2, vocab_size=256, new_decoder_architecture=True,
            parallel_attn=True, bias=True, alibi=False,
            max_position_embeddings=128)),
        "phi": (tr.PhiConfig, tr.PhiForCausalLM, dict(
            hidden_size=64, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, vocab_size=256,
            max_position_embeddings=128, partial_rotary_factor=0.5)),
        "phi3": (tr.Phi3Config, tr.Phi3ForCausalLM, dict(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
            max_position_embeddings=128, pad_token_id=0,
            tie_word_embeddings=False)),
        "gptj": (tr.GPTJConfig, tr.GPTJForCausalLM, dict(
            n_embd=64, n_layer=2, n_head=4, n_inner=256, vocab_size=256,
            n_positions=128, rotary_dim=8)),
        "bigcode_mqa": (tr.GPTBigCodeConfig, tr.GPTBigCodeForCausalLM, dict(
            n_embd=64, n_layer=2, n_head=4, vocab_size=256,
            n_positions=128, multi_query=True)),
        "bigcode_mha": (tr.GPTBigCodeConfig, tr.GPTBigCodeForCausalLM, dict(
            n_embd=64, n_layer=2, n_head=4, vocab_size=256,
            n_positions=128, multi_query=False)),
    }
    return table[kind]


FAMILIES = ["llama", "llama_tied", "internlm", "mistral", "qwen2", "mixtral",
            "qwen2_moe", "gemma", "gpt_neox", "gpt2", "gpt_neo", "opt",
            "bloom", "falcon_mqa", "falcon_new", "falcon_bias", "phi",
            "phi3", "gptj", "bigcode_mqa", "bigcode_mha"]


def _save_hf(kind, path, seed=0, dtype=torch.float32, **save_kw):
    cfg_cls, model_cls, kw = _hf(kind)
    torch.manual_seed(seed)
    model = model_cls(cfg_cls(**kw)).eval().to(dtype)
    model.save_pretrained(str(path), safe_serialization=True, **save_kw)
    return model


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_trees_bitwise(jtree, ttree):
    jl = {k: np.asarray(v) for k, v in _leaves(jtree).items()}
    tl = {k: v.detach().cpu().numpy() for k, v in _leaves(ttree).items()}
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert jl[k].shape == tl[k].shape, k
        assert jl[k].dtype == tl[k].dtype, k
        assert np.array_equal(jl[k], tl[k]), k


def _port_logits(cfg, params, tokens):
    moe_fn = serving_moe_fn(cfg, None, params, ep=False) \
        if cfg.num_experts else None
    with torch.no_grad():
        return ttf.forward(cfg, params, torch.from_numpy(tokens),
                           moe_fn=moe_fn).numpy()


@pytest.mark.parametrize("kind", FAMILIES)
def test_load_matches_jax_loader_and_hf(kind, tmp_path):
    """Each family loads into params bitwise equal to the JAX loader's,
    with logits within 2e-4 of transformers' (BLOOM through the port's
    ALiBi attention)."""
    model = _save_hf(kind, tmp_path / kind)
    jcfg, jparams = jhf.load_hf_checkpoint(str(tmp_path / kind))
    tcfg, tparams = thf.load_hf_checkpoint(str(tmp_path / kind),
                                           device="cpu")
    assert tcfg == ttf.DecoderConfig(**jcfg.__dict__)
    _assert_trees_bitwise(jparams, tparams)
    tokens = np.arange(1, 17, dtype=np.int32)[None].repeat(2, 0)
    ours = _port_logits(tcfg, tparams, tokens)
    with torch.no_grad():
        theirs = model(torch.from_numpy(tokens.astype(np.int64))
                       ).logits.numpy()
    np.testing.assert_allclose(ours, theirs, **LOGIT_TOL)


def test_qwen_v1_layout_matches_jax_loader():
    """Qwen v1 (no transformers class without remote code): a state dict
    in its native layout (fused c_attn thirds, w1 = up, w2 = gate) maps to
    the JAX loader's tree bitwise."""
    hf_cfg = {"model_type": "qwen", "hidden_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "kv_channels": 16, "intermediate_size": 256,
              "vocab_size": 128, "seq_length": 64}
    rng = np.random.default_rng(0)
    sd = {"transformer.wte.weight": (128, 64),
          "transformer.ln_f.weight": (64,), "lm_head.weight": (128, 64)}
    for i in range(2):
        p = f"transformer.h.{i}."
        sd.update({p + "attn.c_attn.weight": (192, 64),
                   p + "attn.c_attn.bias": (192,),
                   p + "attn.c_proj.weight": (64, 64),
                   p + "ln_1.weight": (64,), p + "ln_2.weight": (64,),
                   p + "mlp.w1.weight": (128, 64),
                   p + "mlp.w2.weight": (128, 64),
                   p + "mlp.c_proj.weight": (64, 128)})
    sd = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in sd.items()}
    jcfg = jhf.config_from_hf(hf_cfg)
    tcfg = thf.config_from_hf(hf_cfg)
    assert tcfg == ttf.DecoderConfig(**jcfg.__dict__)
    jparams = jhf.params_from_state(jcfg, hf_cfg, sd.__getitem__, set(sd))
    tparams = thf.params_from_state(
        tcfg, hf_cfg, lambda n: torch.from_numpy(sd[n]), set(sd),
        device="cpu")
    _assert_trees_bitwise(jparams, tparams)


def _tpreset(name):
    from deepspeed_tpu_torch import models as tm
    return getattr(tm, name)


EXPORTS = {
    "llama": ("llama3_config", {}),
    "internlm": ("internlm_config", {}),
    "mistral": ("mistral_config", dict(sliding_window=64)),
    "qwen2": ("qwen2_config", {}),
    "qwen": ("qwen_config", {}),
    "mixtral": ("mixtral_config", {}),
    "qwen2_moe": ("qwen2_moe_config", {}),
    "gemma": ("gemma_config", {}),
    "gptneox": ("gptneox_config", {}),
    "gpt2": ("gpt2_config", {}),
    "gptneo": ("gptneo_config", {}),
    "opt": ("opt_config", {}),
    "bloom": ("bloom_config", {}),
    "falcon_mqa": ("falcon_config", {}),
    "falcon_new": ("falcon_config", dict(num_kv_heads=2,
                                         parallel_block_norms=2)),
    "falcon_bias2": ("falcon_config", dict(num_kv_heads=2,
                                           parallel_block_norms=2,
                                           use_bias=True)),
    "falcon_bias1": ("falcon_config", dict(use_bias=True)),
    "phi": ("phi_config", {}),
    "gptj": ("gptj_config", {}),
    "bigcode": ("gpt_bigcode_config", {}),
}


def _jinit(cfg, seed):
    import deepspeed_tpu.models as jm
    params = jm.init_params(cfg, jax.random.PRNGKey(seed))
    if cfg.lm_head_bias and not cfg.tie_embeddings:
        params["lm_head_bias"] = jax.random.normal(
            jax.random.PRNGKey(seed + 1), (cfg.vocab_size,),
            jnp.float32) * 0.1
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("family", sorted(EXPORTS))
def test_export_matches_jax_export(family, tmp_path):
    """The port's fp32 export of a tree is byte for byte the JAX export of
    the same tree (model.safetensors and config.json); transformers
    reloads it (logits within 2e-3 of the port's); the port's loader
    gives the tree back bitwise."""
    import deepspeed_tpu.models as jm
    name, kw = EXPORTS[family]
    jcfg = getattr(jm, name)("tiny", **kw)
    tcfg = _tpreset(name)("tiny", **kw)
    assert tcfg == ttf.DecoderConfig(**jcfg.__dict__)
    jp = _jinit(jcfg, 11)
    tp = params_from_jax(jp, device="cpu")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jhf.export_hf_checkpoint(jcfg, jax.tree.map(jnp.asarray, jp), str(jdir))
    thf.export_hf_checkpoint(tcfg, tp, str(tdir))
    for fname in ("model.safetensors", "config.json"):
        assert (jdir / fname).read_bytes() == (tdir / fname).read_bytes(), \
            fname
    tokens = np.arange(3, 17, dtype=np.int32)[None]
    if family == "falcon_bias1":
        # a tied biased one-norm falcon exports as phi with no lm_head;
        # the reference's phi loader reads lm_head.weight, and so does
        # the port's: both refuse the reload alike
        with pytest.raises(Exception, match="lm_head.weight"):
            jhf.load_hf_checkpoint(str(jdir))
        with pytest.raises(KeyError, match="lm_head.weight"):
            thf.load_hf_checkpoint(str(tdir), device="cpu")
        cfg2, back = tcfg, tp
    else:
        cfg2, back = thf.load_hf_checkpoint(str(tdir), device="cpu")
        jcfg2, jback = jhf.load_hf_checkpoint(str(jdir))
        _assert_trees_bitwise(jback, back)
    from transformers import AutoModelForCausalLM
    hf = AutoModelForCausalLM.from_pretrained(str(tdir)).eval()
    ours = _port_logits(cfg2, back, tokens)
    with torch.no_grad():
        theirs = hf(torch.from_numpy(tokens.astype(np.int64))
                    ).logits.numpy()
    np.testing.assert_allclose(ours, theirs, **EXPORT_TOL)


def test_bf16_export_round_trip(tmp_path):
    """A bf16 tree exports in bf16 (torch_dtype 'bfloat16') and loads
    back in bf16: bitwise for the renames and splits, within one bf16 ulp
    on Gemma's folded norm scales."""
    cfg = _tpreset("gemma_config")("tiny")
    gen = torch.Generator().manual_seed(0)
    params = ttf.init_params(cfg, gen, torch.bfloat16, torch.device("cpu"))
    for ln in (params["layers"]["ln1"], params["layers"]["ln2"],
               params["final_norm"]):
        ln["scale"] = (1.0 + 0.3 * torch.randn(ln["scale"].shape,
                                               generator=gen)
                       ).to(torch.bfloat16)
    thf.export_hf_checkpoint(cfg, params, str(tmp_path))
    with open(tmp_path / "config.json") as fh:
        assert json.load(fh)["torch_dtype"] == "bfloat16"
    _, back = thf.load_hf_checkpoint(str(tmp_path), dtype=torch.bfloat16,
                                     device="cpu")
    orig, got = _leaves(params), _leaves(back)
    assert sorted(orig) == sorted(got)
    for k in orig:
        assert got[k].dtype == torch.bfloat16, k
        if k.endswith("/scale"):
            ulp = torch.finfo(torch.bfloat16).eps * orig[k].float().abs()
            assert ((got[k].float() - orig[k].float()).abs()
                    <= ulp).all(), k
        else:
            assert torch.equal(got[k], orig[k]), k


@pytest.mark.parametrize("overrides", [
    dict(norm="rmsnorm", pos_emb="learned", activation="gelu",
         use_bias=False),
    dict(norm="rmsnorm", pos_emb="rope", activation="silu_glu",
         use_bias=False, parallel_block=True, parallel_block_norms=2),
    dict(norm="layernorm", pos_emb="learned", activation="gelu",
         use_bias=False),
    dict(norm="layernorm", pos_emb="learned", activation="gelu",
         use_bias=True, tie_embeddings=False, lm_head_bias=True),
    dict(norm="layernorm", pos_emb="rope", activation="silu_glu",
         use_bias=False, parallel_block=True, parallel_block_norms=2),
    dict(norm="layernorm", pos_emb="rope", activation="gelu_exact",
         use_bias=True, parallel_block=True, parallel_block_norms=2,
         num_kv_heads=2, rotary_pct=0.5),
    dict(norm="layernorm", pos_emb="learned", activation="gelu",
         use_bias=True, num_kv_heads=2),
])
def test_export_rejects_unsupported_layout(overrides, tmp_path):
    """Layouts no HF family can express raise ValueError in both
    packages, before anything is written."""
    base = dict(hidden_size=64, num_layers=2, num_heads=4, vocab_size=256,
                max_seq_len=64, **overrides)
    jcfg = jtf.DecoderConfig(**base)
    tcfg = ttf.DecoderConfig(**base)
    with pytest.raises(ValueError):
        jhf.export_hf_checkpoint(jcfg, jtf.init_params(
            jcfg, jax.random.PRNGKey(0)), str(tmp_path / "j"))
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0),
                             torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError):
        thf.export_hf_checkpoint(tcfg, params, str(tmp_path / "t"))
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("hf_cfg,match", [
    ({"model_type": "qwen2_moe", "hidden_size": 64,
      "num_hidden_layers": 4, "num_attention_heads": 4,
      "moe_intermediate_size": 96, "shared_expert_intermediate_size": 128,
      "num_experts": 4, "vocab_size": 256, "intermediate_size": 96,
      "decoder_sparse_step": 2}, "decoder_sparse_step"),
    ({"model_type": "phi3", "hidden_size": 64, "num_hidden_layers": 2,
      "num_attention_heads": 4, "intermediate_size": 128,
      "vocab_size": 256, "rope_scaling": {"type": "longrope"}}, "longrope"),
    ({"model_type": "t5"}, "unsupported model_type"),
    ({"model_type": "opt", "hidden_size": 64, "do_layer_norm_before": False},
     "post-norm"),
    ({"model_type": "falcon", "hidden_size": 64, "num_attention_heads": 4,
      "parallel_attn": False}, "parallel_attn"),
    ({"model_type": "phi", "qk_layernorm": True}, "qk_layernorm"),
    ({"model_type": "qwen", "no_bias": False}, "no_bias"),
    ({"model_type": "gpt2", "n_embd": 64, "n_layer": 2, "n_head": 4,
      "vocab_size": 256, "activation_function": "swish"},
     "activation_function"),
])
def test_config_from_hf_rejects_as_reference(hf_cfg, match):
    with pytest.raises(ValueError, match=match):
        jhf.config_from_hf(hf_cfg)
    with pytest.raises(ValueError, match=match):
        thf.config_from_hf(hf_cfg)


@pytest.mark.parametrize("size", ["bert", "distilbert"])
def test_encoders_wait_for_the_mlm_head(size, tmp_path):
    """BERT/DistilBERT (the name kept from when the masked-LM head was
    missing): the configs map as in the reference; a transformers model
    saved with ``save_pretrained`` loads into the port bitwise as the JAX
    loader loads it, with masked-LM logits within 2e-4 of transformers'
    (segment B from position 8 for BERT), and the port's export of that
    tree reloads in transformers within 2e-3."""
    import transformers as tr
    from deepspeed_tpu_torch.models import bert_config, distilbert_config
    cfg = (bert_config if size == "bert" else distilbert_config)("tiny")
    hf_cfg = thf.config_to_hf(cfg)
    assert hf_cfg == jhf.config_to_hf(jtf.DecoderConfig(**cfg.__dict__))
    assert thf.config_from_hf(hf_cfg) == cfg
    if size == "bert":
        model = tr.BertForMaskedLM(tr.BertConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, vocab_size=512,
            max_position_embeddings=128, type_vocab_size=2,
            layer_norm_eps=1e-12))
    else:
        model = tr.DistilBertForMaskedLM(tr.DistilBertConfig(
            dim=64, n_layers=2, n_heads=4, hidden_dim=256, vocab_size=512,
            max_position_embeddings=128))
    torch.manual_seed(0)
    model.eval().save_pretrained(str(tmp_path / "hf"),
                                 safe_serialization=True)
    jcfg, jparams = jhf.load_hf_checkpoint(str(tmp_path / "hf"))
    tcfg, tparams = thf.load_hf_checkpoint(str(tmp_path / "hf"),
                                           device="cpu")
    assert tcfg == ttf.DecoderConfig(**jcfg.__dict__)
    _assert_trees_bitwise(jparams, tparams)
    tokens = np.arange(1, 17, dtype=np.int64)[None].repeat(2, 0)
    kw = {"token_type_ids": torch.from_numpy((np.arange(16) >= 8).astype(
        np.int64))[None].repeat(2, 1)} if size == "bert" else {}
    with torch.no_grad():
        ours = ttf.forward(tcfg, tparams, torch.from_numpy(tokens), **kw)
        theirs = model(torch.from_numpy(tokens), **kw).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), **LOGIT_TOL)
    thf.export_hf_checkpoint(tcfg, tparams, str(tmp_path / "out"))
    cls = tr.BertForMaskedLM if size == "bert" else tr.DistilBertForMaskedLM
    back = cls.from_pretrained(str(tmp_path / "out")).eval()
    with torch.no_grad():
        again = back(torch.from_numpy(tokens), **kw).logits
    np.testing.assert_allclose(ours.numpy(), again.numpy(), **EXPORT_TOL)


def test_moe_residual_export_rejected(tmp_path):
    cfg = _tpreset("mixtral_config")("tiny", moe_residual=True)
    with pytest.raises(ValueError, match="Residual-MoE"):
        thf.export_hf_checkpoint(cfg, {"layers": {}}, str(tmp_path))


def test_loader_defaults_to_cuda(tmp_path):
    _save_hf("llama", tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="is_available"):
        thf.load_hf_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# the safetensors module
# ---------------------------------------------------------------------------

def _mixed_dict():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn(3, 5, generator=g),
        "w_bf16": torch.randn(4, 2, generator=g).to(torch.bfloat16),
        "w_fp16": torch.randn(5, generator=g).to(torch.float16),
        "scalar": torch.tensor(2.5),
        "ids": torch.arange(7, dtype=torch.int64),
        "i32": torch.arange(3, dtype=torch.int32),
        "i16": torch.arange(3, dtype=torch.int16),
        "q": torch.arange(6, dtype=torch.int8).reshape(2, 3),
        "u": torch.arange(5, dtype=torch.uint8),
        "mask": torch.tensor([True, False, True]),
        "f8": torch.randn(4, generator=g).to(torch.float8_e4m3fn),
        "f64": torch.randn(2, generator=g).double(),
        "empty": torch.zeros(0, 3),
        "a.b.c": torch.ones(1),
    }


@pytest.mark.parametrize("metadata", [None, {"format": "pt"},
                                      {"format": "np"}])
def test_writer_byte_identical_to_safetensors(metadata, tmp_path):
    """One metadata key at most: safetensors keeps metadata in a Rust
    HashMap, whose key order is not fixed."""
    from safetensors.torch import save_file
    d = _mixed_dict()
    save_file(d, str(tmp_path / "ref.safetensors"), metadata=metadata)
    n = safetensors_io.save_file(d, str(tmp_path / "port.safetensors"),
                                 metadata=metadata)
    ref = (tmp_path / "ref.safetensors").read_bytes()
    assert (tmp_path / "port.safetensors").read_bytes() == ref
    assert n == len(ref)


def test_reader_matches_safe_open(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file
    d = _mixed_dict()
    save_file(d, str(tmp_path / "f.safetensors"), metadata={"format": "pt"})
    f = safetensors_io.SafetensorsFile(str(tmp_path / "f.safetensors"))
    assert f.metadata == {"format": "pt"}
    with safe_open(str(tmp_path / "f.safetensors"), framework="pt") as ref:
        assert sorted(ref.keys()) == sorted(f.keys())
        for k in ref.keys():
            a, b = ref.get_tensor(k), f.get(k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)) \
                if a.numel() and a.dim() else torch.equal(a, b), k
    # copy-on-write: writing to a tensor leaves the file as it was
    before = (tmp_path / "f.safetensors").read_bytes()
    f.get("w").zero_()
    assert (tmp_path / "f.safetensors").read_bytes() == before
    with pytest.raises(ValueError, match="header length"):
        (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 16)
        safetensors_io.SafetensorsFile(str(tmp_path / "bad.safetensors"))


def test_sharded_bf16_checkpoint_through_index(tmp_path):
    """A bf16 checkpoint saved in shards (model.safetensors.index.json)
    loads in bf16 with every leaf bitwise the JAX loader's fp32 tree cast
    back to bf16 (bf16 → fp32 is exact), and the port's fp32 load of the
    same shards is bitwise the JAX loader's."""
    _save_hf("gemma", tmp_path, dtype=torch.bfloat16,
             max_shard_size="40KB")
    index = json.loads((tmp_path / "model.safetensors.index.json"
                        ).read_text())
    assert len(set(index["weight_map"].values())) > 1
    assert not (tmp_path / "model.safetensors").exists()
    _, jparams = jhf.load_hf_checkpoint(str(tmp_path))
    _, t32 = thf.load_hf_checkpoint(str(tmp_path), device="cpu")
    _assert_trees_bitwise(jparams, t32)
    _, t16 = thf.load_hf_checkpoint(str(tmp_path), dtype=torch.bfloat16,
                                    device="cpu")
    get, names = safetensors_io.open_checkpoint(str(tmp_path))
    assert names == set(index["weight_map"])
    assert get("model.embed_tokens.weight").dtype == torch.bfloat16
    # the fold adds 1 in bf16 here and in fp32 in the fp32 load: compare
    # the renames bitwise and the folded scales within one bf16 ulp
    for k, v in _leaves(t16).items():
        ref = _leaves(t32)[k]
        assert v.dtype == torch.bfloat16, k
        if k.endswith("/scale"):
            assert torch.allclose(v.float(), ref, rtol=2 ** -8, atol=0), k
        else:
            assert torch.equal(v.float(), ref), k
