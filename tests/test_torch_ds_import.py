"""The port's DeepSpeed-checkpoint import
(deepspeed_tpu_torch.checkpoint.ds_import) against the JAX package's
(deepspeed_tpu/checkpoint/ds_import.py) and transformers, on the CPU —
the scenarios of tests/test_ds_import.py.

Each scenario writes the reference's on-disk layout with torch.save from
a tiny HF model, imports it with both packages and holds the port's tree
BITWISE against the JAX one (both read fp32 and apply the same mapping),
and the port's fp32 logits within 2e-4 of transformers' forward (two
fp32 implementations summing in different orders).
"""

import collections
import math
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint import ds_import as jdi
from deepspeed_tpu_torch.checkpoint import ds_import as tdi
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.parallel.moe import serving_moe_fn

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


def _tiny_llama():
    from transformers import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, vocab_size=256,
                      max_position_embeddings=128, rope_theta=10000.0,
                      rms_norm_eps=1e-6, tie_word_embeddings=False,
                      attention_bias=False)
    torch.manual_seed(7)
    return LlamaForCausalLM(cfg).eval()


def _tiny_mixtral():
    from transformers import MixtralConfig, MixtralForCausalLM
    cfg = MixtralConfig(hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, vocab_size=256,
                        max_position_embeddings=128,
                        num_local_experts=4, num_experts_per_tok=2,
                        rms_norm_eps=1e-6)
    torch.manual_seed(3)
    return MixtralForCausalLM(cfg).eval()


def _write_engine_ckpt(model, root, tag="global_step10", prefix=""):
    d = root / tag
    d.mkdir(parents=True)
    sd = {prefix + k: v for k, v in model.state_dict().items()}
    torch.save({"module": sd, "global_steps": 10},
               str(d / "mp_rank_00_model_states.pt"))
    (root / "latest").write_text(tag)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_bitwise(jtree, ttree):
    jl, tl = _leaves(jtree), _leaves(ttree)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        a, b = np.asarray(jl[k]), tl[k].detach().cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


def _assert_logits_parity(hf_model, cfg, params):
    tokens = np.arange(1, 17, dtype=np.int32)[None].repeat(2, 0)
    moe_fn = serving_moe_fn(cfg, None, params, ep=False) \
        if cfg.num_experts else None
    with torch.no_grad():
        ours = ttf.forward(cfg, params, torch.from_numpy(tokens),
                           moe_fn=moe_fn).numpy()
        theirs = hf_model(torch.from_numpy(tokens.astype(np.int64))
                          ).logits.numpy()
    np.testing.assert_allclose(ours, theirs, **LOGIT_TOL)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_engine_checkpoint_import(prefix, tmp_path):
    """mp_rank_00_model_states.pt, bare and with the 'module.' wrapper
    prefix."""
    model = _tiny_llama()
    _write_engine_ckpt(model, tmp_path, prefix=prefix)
    hf_cfg = model.config.to_dict()
    _, jp = jdi.load_ds_checkpoint(str(tmp_path), hf_cfg)
    cfg, tp = tdi.load_ds_checkpoint(str(tmp_path), hf_cfg, device="cpu")
    assert cfg.num_heads == 4 and cfg.kv_heads == 2
    _assert_bitwise(jp, tp)
    _assert_logits_parity(model, cfg, tp)


def test_engine_checkpoint_import_bf16(tmp_path):
    """bf16 model states import in the asked dtype: each leaf is the fp32
    import rounded to bf16."""
    model = _tiny_llama().to(torch.bfloat16)
    _write_engine_ckpt(model, tmp_path)
    hf_cfg = model.config.to_dict()
    _, p32 = tdi.load_ds_checkpoint(str(tmp_path), hf_cfg, device="cpu")
    _, p16 = tdi.load_ds_checkpoint(str(tmp_path), hf_cfg,
                                    dtype=torch.bfloat16, device="cpu")
    for k, v in _leaves(p16).items():
        assert v.dtype == torch.bfloat16, k
        assert torch.equal(v, _leaves(p32)[k].to(torch.bfloat16)), k


def test_tag_resolution(tmp_path):
    model = _tiny_llama()
    _write_engine_ckpt(model, tmp_path, tag="epoch3")
    assert tdi.resolve_tag(str(tmp_path)) == "epoch3"
    os.remove(tmp_path / "latest")                  # single subdir fallback
    assert tdi.resolve_tag(str(tmp_path)) == "epoch3"
    assert tdi.resolve_tag(str(tmp_path), tag="explicit") == "explicit"
    (tmp_path / "other").mkdir()
    with pytest.raises(ValueError, match="cannot resolve"):
        tdi.resolve_tag(str(tmp_path))


def test_mp_rank_shards_rejected(tmp_path):
    model = _tiny_llama()
    _write_engine_ckpt(model, tmp_path)
    torch.save({}, str(tmp_path / "global_step10" /
                       "mp_rank_01_model_states.pt"))
    with pytest.raises(ValueError, match="model-parallel"):
        tdi.load_ds_checkpoint(str(tmp_path), model.config.to_dict(),
                               device="cpu")


def test_missing_model_states_rejected(tmp_path):
    (tmp_path / "global_step1").mkdir()
    with pytest.raises(FileNotFoundError, match="no model states"):
        tdi.load_ds_checkpoint(str(tmp_path), {}, device="cpu")


def test_zero3_placeholder_states_rejected(tmp_path):
    """ZeRO-3 saves 0-size placeholders unless gather_16bit is on."""
    model = _tiny_llama()
    d = tmp_path / "global_step10"
    d.mkdir(parents=True)
    sd = {k: torch.empty(0) for k in model.state_dict()}
    torch.save({"module": sd}, str(d / "mp_rank_00_model_states.pt"))
    (tmp_path / "latest").write_text("global_step10")
    with pytest.raises(ValueError, match="ZeRO-3 placeholder"):
        tdi.load_ds_checkpoint(str(tmp_path), model.config.to_dict(),
                               device="cpu")


@pytest.mark.parametrize("prefix", ["", "module."])
def test_universal_checkpoint_import(prefix, tmp_path):
    """zero/<param>/fp32.pt per parameter (optimizer fragments present
    and ignored), bare and 'module.'-prefixed directory names."""
    model = _tiny_llama()
    tag = "global_step10"
    zero = tmp_path / tag / "zero"
    for name, tensor in model.state_dict().items():
        pdir = zero / (prefix + name)
        pdir.mkdir(parents=True)
        torch.save(tensor.float(), str(pdir / "fp32.pt"))
        torch.save(torch.zeros_like(tensor, dtype=torch.float32),
                   str(pdir / "exp_avg.pt"))
    (tmp_path / "latest").write_text(tag)
    hf_cfg = model.config.to_dict()
    _, jp = jdi.load_universal_checkpoint(str(tmp_path), hf_cfg)
    cfg, tp = tdi.load_universal_checkpoint(str(tmp_path), hf_cfg,
                                            device="cpu")
    _assert_bitwise(jp, tp)
    _assert_logits_parity(model, cfg, tp)


def test_moe_expert_shard_import(tmp_path):
    """Expert weights in per-expert shard files with the deepspeed_moe
    wrapper infix fold back into the HF naming."""
    model = _tiny_mixtral()
    tag = "global_step5"
    d = tmp_path / tag
    d.mkdir(parents=True)
    sd = dict(model.state_dict())
    infix = ".deepspeed_moe.experts.deepspeed_experts."
    expert_files = {}
    for key in list(sd):
        if ".block_sparse_moe.experts." in key:
            prefix, rest = key.split(".experts.", 1)
            eid, wname = rest.split(".", 1)
            layer = int(prefix.split(".")[2])
            ds_key = f"{prefix}{infix}{eid}.{wname}"
            expert_files.setdefault((layer, int(eid)), {})[ds_key] = \
                sd.pop(key)
    assert expert_files, "expert split found nothing — naming drifted"
    torch.save({"module": sd, "global_steps": 5},
               str(d / "mp_rank_00_model_states.pt"))
    for (layer, eid), esd in expert_files.items():
        torch.save(esd, str(
            d / f"layer_{layer}_expert_{eid}_mp_rank_00_model_states.pt"))
    (tmp_path / "latest").write_text(tag)
    hf_cfg = model.config.to_dict()
    _, jp = jdi.load_ds_checkpoint(str(tmp_path), hf_cfg)
    cfg, tp = tdi.load_ds_checkpoint(str(tmp_path), hf_cfg, device="cpu")
    assert cfg.num_experts == 4
    _assert_bitwise(jp, tp)
    _assert_logits_parity(model, cfg, tp)
    torch.save({}, str(d / "layer_0_expert_0_mp_rank_01_model_states.pt"))
    with pytest.raises(ValueError, match="model-parallel expert shard"):
        tdi.load_ds_checkpoint(str(tmp_path), hf_cfg, device="cpu")


def _write_zero_ckpt(model, root, stage, tag="global_step7", world=2,
                     moment_scale=0.5):
    """Synthetic DeepSpeed ZeRO checkpoint: fp32 master flat partitions in
    zero_pp_rank_* optim shards + param_shapes in the model states file
    (the layout utils/zero_to_fp32.py reads). Stage 2: one flat group cut
    in ``world`` parts; stage 3: every param padded to ``world`` and each
    rank holding its slice of each."""
    d = root / tag
    d.mkdir(parents=True)
    sd = model.state_dict()
    shapes = collections.OrderedDict(
        (k, tuple(v.shape)) for k, v in sd.items())
    if stage <= 2:
        flat = torch.cat([v.reshape(-1).float() for v in sd.values()])
        align = 2 * world
        padded = math.ceil(flat.numel() / align) * align
        flat = torch.nn.functional.pad(flat, (0, padded - flat.numel()))
        part = padded // world
        chunks = [flat[r * part:(r + 1) * part].clone()
                  for r in range(world)]
        torch.save({"module": {k: v.to(torch.bfloat16)
                               for k, v in sd.items()},
                    "param_shapes": [shapes]},
                   str(d / "mp_rank_00_model_states.pt"))
    else:
        per_rank = [[] for _ in range(world)]
        for v in sd.values():
            f = v.reshape(-1).float()
            pn = -(-f.numel() // world)
            f = torch.nn.functional.pad(f, (0, pn * world - f.numel()))
            for r in range(world):
                per_rank[r].append(f[r * pn:(r + 1) * pn])
        chunks = [torch.cat(p) for p in per_rank]
        torch.save({"module": {}, "param_shapes": [shapes]},
                   str(d / "zero_pp_rank_0_mp_rank_00_model_states.pt"))
    for r in range(world):
        osd = {"zero_stage": stage, "partition_count": world,
               "base_optimizer_state": {
                   "state": {0: {"step": 7,
                                 "exp_avg": chunks[r] * moment_scale,
                                 "exp_avg_sq":
                                     (chunks[r] * moment_scale) ** 2}},
                   "param_groups": [{}]}}
        key = "single_partition_of_fp32_groups" if stage <= 2 \
            else "fp32_flat_groups"
        osd[key] = [chunks[r]]
        torch.save({"optimizer_state_dict": osd},
                   str(d / f"zero_pp_rank_{r}_mp_rank_00_optim_states.pt"))
    (root / "latest").write_text(tag)


@pytest.mark.parametrize("stage,world", [(2, 2), (2, 3), (3, 2), (3, 4)])
def test_zero_direct_optim_states_import(stage, world, tmp_path):
    """zero_pp_rank_* optim shards import directly: the fp32 master gives
    the JAX import's tree bitwise and transformers' logits; at stage 2 the
    Adam moments ride the same mapping (0.5 × the weights, leaf for
    leaf) and the step comes back."""
    model = _tiny_llama()
    _write_zero_ckpt(model, tmp_path, stage, world=world)
    hf_cfg = model.config.to_dict()
    _, jp = jdi.load_zero_checkpoint(str(tmp_path), hf_cfg)
    cfg, tp = tdi.load_zero_checkpoint(str(tmp_path), hf_cfg, device="cpu")
    _assert_bitwise(jp, tp)
    _assert_logits_parity(model, cfg, tp)
    if stage == 3:
        with pytest.raises(ValueError, match="stage-3"):
            tdi.load_zero_checkpoint(str(tmp_path), hf_cfg,
                                     load_optimizer_states=True,
                                     device="cpu")
        return
    _, jp, jm = jdi.load_zero_checkpoint(str(tmp_path), hf_cfg,
                                         load_optimizer_states=True)
    _, tp, tm = tdi.load_zero_checkpoint(str(tmp_path), hf_cfg,
                                         load_optimizer_states=True,
                                         device="cpu")
    assert tm["step"] == jm["step"] == 7
    for key in ("exp_avg", "exp_avg_sq"):
        _assert_bitwise(jm[key], tm[key])
    for k, p in _leaves(tp).items():
        m = _leaves(tm["exp_avg"])[k]
        torch.testing.assert_close(m, 0.5 * p, rtol=1e-6, atol=1e-7)


def test_zero_incomplete_checkpoint_rejected(tmp_path):
    model = _tiny_llama()
    _write_zero_ckpt(model, tmp_path, 2, world=2)
    os.remove(tmp_path / "global_step7" /
              "zero_pp_rank_1_mp_rank_00_optim_states.pt")
    with pytest.raises(ValueError, match="incomplete"):
        tdi.load_zero_checkpoint(str(tmp_path), model.config.to_dict(),
                                 device="cpu")


def test_zero2_import_into_training_engine(tmp_path):
    """A synthetic DeepSpeed Z2 checkpoint → import → the port's training
    engine resumes from the imported params and moments with finite,
    decreasing loss."""
    from deepspeed_tpu_torch import initialize
    model = _tiny_llama()
    _write_zero_ckpt(model, tmp_path, 2, world=2)
    cfg, params, moments = tdi.load_zero_checkpoint(
        str(tmp_path), model.config.to_dict(), load_optimizer_states=True,
        device="cpu")
    eng, *_ = initialize(
        model=cfg,
        config={"train_micro_batch_size_per_gpu": 8,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}},
        params=params, device="cpu")
    for key in ("exp_avg", "exp_avg_sq"):
        for dst, src in zip(_leaves(eng.opt_state[key]).values(),
                            _leaves(moments[key]).values()):
            dst.copy_(src)
    eng.opt_state["step"] = moments["step"]
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 256, size=(8, 32),
                                       dtype=np.int32)}
    losses = [float(eng.train_batch(iter([batch]))) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
