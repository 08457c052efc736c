"""Megatron-LM GPT checkpoint import.

Port of ``deepspeed_tpu/models/megatron.py`` (reference:
module_inject/containers/megatron_gpt.py + features/megatron.py). The
reference's v1 inference kernel-injects Megatron-LM
``ParallelTransformerLayer`` models; its policy documents the layout this
loader maps into the parameter tree:

- fused ``(self_)attention.query_key_value`` with the head-major per-head
  [q|k|v] interleave (features/megatron.py:_align_qkv_transposed views the
  out dim as [H, 3·dh] — GPT-NeoX's convention);
- otherwise the GPT-2 block: learned positions, LayerNorm with bias,
  sequential residual, dense_h_to_4h/dense_4h_to_h MLP, tied head unless
  the checkpoint carries ``output_layer``.

Takes ``mp_rank_00/model_optim_rng.pt`` (or a direct .pt path), reads the
hyperparameters from the checkpoint's ``args`` when present, and both the
modern (``encoder`` / ``self_attention``) and the legacy (``transformer``
/ ``attention``) names. The arithmetic is the reference's, on torch
tensors: fp32 reads, then the dtype cast, split and transpose.
"""

import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.models.transformer import DecoderConfig
from deepspeed_tpu_torch.utils.logging import logger

Params = Any


def _flatten(d, prefix="") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def _resolve_ckpt_file(path: str) -> str:
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        ranks = sorted(d for d in os.listdir(path)
                       if d.startswith("mp_rank_"))
        if len(ranks) > 1:
            # reading rank 0's shard alone would give a well-formed
            # half-width model of garbage
            raise NotImplementedError(
                f"checkpoint at {path!r} is tensor-parallel sharded "
                f"({len(ranks)} mp_rank_* dirs); merge the TP shards "
                "first (concatenate qkv/h_to_4h on the out dim, "
                "dense/4h_to_h on the in dim) — sharded import is not "
                "supported")
    for sub in ("mp_rank_00/model_optim_rng.pt",
                "mp_rank_00/model_rng.pt", "model_optim_rng.pt"):
        cand = os.path.join(path, sub)
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(
        f"no Megatron checkpoint found under {path!r} (looked for "
        "mp_rank_00/model_optim_rng.pt and friends)")


def load_megatron_checkpoint(path: str, num_heads: Optional[int] = None,
                             activation: str = "gelu_exact",
                             dtype: torch.dtype = torch.float32,
                             device: Optional[Union[str, torch.device]]
                             = None) -> Tuple[DecoderConfig, Params]:
    """Megatron-LM GPT checkpoint → (DecoderConfig, parameter tree) with
    leaves in ``dtype`` on ``device`` (None → CUDA) — megatron.py:70.

    ``num_heads`` overrides the checkpoint's ``args`` (and is required
    when it has none). ``activation``: Megatron's default F.gelu is the
    exact erf form; pass ``"gelu"`` for models trained with the tanh
    variant. The file is read with ``torch.load(weights_only=False)``:
    load only checkpoints you trust."""
    dev = get_device(device)
    f = _resolve_ckpt_file(path)
    ckpt = torch.load(f, map_location="cpu", weights_only=False)
    model = ckpt.get("model", ckpt)
    lm = model.get("language_model", model)
    flat = {k: (v.float() if isinstance(v, torch.Tensor) else
                torch.as_tensor(v, dtype=torch.float32))
            for k, v in _flatten(lm).items() if hasattr(v, "shape")}

    args = ckpt.get("args")
    emb = flat["embedding.word_embeddings.weight"]
    pos = flat["embedding.position_embeddings.weight"]
    core = "encoder" if any(k.startswith("encoder.") for k in flat) \
        else "transformer"
    attn = "self_attention" if \
        f"{core}.layers.0.self_attention.query_key_value.weight" in flat \
        else "attention"
    L = 1 + max(int(k.split(".")[2]) for k in flat
                if k.startswith(f"{core}.layers."))
    D = emb.shape[1]
    H = num_heads or (getattr(args, "num_attention_heads", None)
                      if args is not None else None)
    if H is None:
        raise ValueError(
            "checkpoint has no 'args'; pass num_heads= explicitly")
    H = int(H)
    ffn = flat[f"{core}.layers.0.mlp.dense_h_to_4h.weight"].shape[0]
    # --untie-embeddings-and-output-weights checkpoints carry an explicit
    # output_layer; dropping it would decode through the embeddings
    untied = "output_layer.weight" in flat
    cfg = DecoderConfig(
        hidden_size=D, num_layers=L, num_heads=H,
        intermediate_size=int(ffn),
        vocab_size=emb.shape[0], max_seq_len=pos.shape[0],
        norm="layernorm", activation=activation, pos_emb="learned",
        norm_eps=float(getattr(args, "layernorm_epsilon", 1e-5)
                       if args is not None else 1e-5),
        use_bias=True, tie_embeddings=not untied)

    dh = cfg.head_dim
    p = f"{core}.layers.{{}}.{attn}."

    def get(name):
        return flat[name].to(dtype)

    def split_qkv_w(i):
        w = get(p.format(i) + "query_key_value.weight").reshape(H, 3, dh, D)
        return tuple(w[:, j].reshape(H * dh, D).T.contiguous()
                     for j in range(3))

    def split_qkv_b(i):
        b = get(p.format(i) + "query_key_value.bias").reshape(H, 3, dh)
        return tuple(b[:, j].reshape(-1) for j in range(3))

    def stack(fmt):
        return torch.stack([get(fmt.format(i)) for i in range(L)])

    def stackT(fmt):
        return torch.stack([get(fmt.format(i)).T for i in range(L)])

    qw, kw, vw = zip(*(split_qkv_w(i) for i in range(L)))
    qb, kb, vb = zip(*(split_qkv_b(i) for i in range(L)))
    lp = f"{core}.layers.{{}}."
    layers = {
        "attn": {
            "wq": torch.stack(qw), "wk": torch.stack(kw),
            "wv": torch.stack(vw), "wo": stackT(p + "dense.weight"),
            "bq": torch.stack(qb), "bk": torch.stack(kb),
            "bv": torch.stack(vb), "bo": stack(p + "dense.bias"),
        },
        "ln1": {"scale": stack(lp + "input_layernorm.weight"),
                "bias": stack(lp + "input_layernorm.bias")},
        "ln2": {"scale": stack(lp + "post_attention_layernorm.weight"),
                "bias": stack(lp + "post_attention_layernorm.bias")},
        "mlp": {
            "wi": stackT(lp + "mlp.dense_h_to_4h.weight"),
            "bi": stack(lp + "mlp.dense_h_to_4h.bias"),
            "wo": stackT(lp + "mlp.dense_4h_to_h.weight"),
            "bo": stack(lp + "mlp.dense_4h_to_h.bias"),
        },
    }
    params: Params = {
        "embed": {"tokens": emb.to(dtype), "pos": pos.to(dtype)},
        "layers": layers,
        "final_norm": {"scale": get(f"{core}.final_layernorm.weight"),
                       "bias": get(f"{core}.final_layernorm.bias")},
    }
    if untied:
        params["lm_head"] = get("output_layer.weight").T.contiguous()
    params = _to_device(params, dev)
    logger.info(f"loaded Megatron checkpoint from {path}: "
                f"{cfg.num_params() / 1e6:.1f}M params, {L} layers, "
                f"{attn} naming")
    return cfg, params


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.contiguous().to(dev)
