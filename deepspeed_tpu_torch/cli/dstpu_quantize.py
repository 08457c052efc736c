"""Offline checkpoint quantization — the port of ``bin/dstpu_quantize``
(reference: module_inject/module_quantize.py and the FP6-LLM offline
quantizer flow in ops/fp_quantizer: quantize once, serve many times).

    python -m deepspeed_tpu_torch.cli.dstpu_quantize \\
        --model-dir /path/to/hf_ckpt --mode int4 \\
        --out /path/to/quantized.npz [--report] [--device cpu]

Loads an HF safetensors checkpoint in fp32 on ``--device`` (default
cuda), applies the serving quantizer (``quantize_param_tree``: the
transform the engines run at start-up under ``weight_quant``) and writes
the engine-ready tree as one .npz with the model config. Serving then
skips the start-up quantization and never holds the float weights:

    cfg, params = load_quantized_npz("/path/to/quantized.npz")
    eng = InferenceEngine(cfg, {"dtype": "bfloat16"}, params=params)

The file is the JAX tool's, so either package reads the other's: flat
``a/b/c`` keys, a ``__meta__`` entry holding JSON (``config``: the
DecoderConfig's fields; ``fp8_leaves``: the keys of float8_e4m3fn
leaves, stored as their uint8 bytes and viewed back on load). Float
leaves must be fp32 or fp16 (numpy has no bfloat16).

``--report`` prints each quantized leaf's relative error and bytes, the
check before shipping a coarser grid such as int4.
"""
import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.models.transformer import DecoderConfig
from deepspeed_tpu_torch.ops.quantized_linear import (MODES, SCALE_SUFFIX,
                                                      dequantize_weight,
                                                      quantize_param_tree)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """'/'-joined keys in sorted order (the JAX tool's ``leaf_items``)."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out.update(_flatten(tree[k], name))
        else:
            out[name] = tree[k]
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        raise ValueError("save_quantized_npz: numpy has no bfloat16; cast "
                         "the tree's float leaves to float32 first")
    return t.numpy()


def save_quantized_npz(path: str, cfg: DecoderConfig, params) -> None:
    """Write a (quantized) tree of torch tensors and its config in the JAX
    tool's npz layout (bin/dstpu_quantize ``save_quantized_npz``)."""
    flat, fp8_leaves = {}, []
    for k, v in _flatten(params).items():
        if v.dtype == torch.float8_e4m3fn:
            fp8_leaves.append(k)
        flat[k] = _host(v)
    meta = {"config": dataclasses.asdict(cfg), "fp8_leaves": fp8_leaves}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                     dtype=np.uint8)
    np.savez(path, **flat)


def load_quantized_npz(path: str, device: Optional[Union[str, torch.device]]
                       = None):
    """(DecoderConfig, engine-ready quantized tree) from a quantizer file
    of either package, leaves on ``device`` (None → CUDA); fp8 leaves come
    back as ``torch.float8_e4m3fn`` through a view of their bytes."""
    dev = get_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        fp8 = set(meta["fp8_leaves"])
        flat = {}
        for k in z.files:
            if k == "__meta__":
                continue
            t = torch.from_numpy(np.array(z[k]))
            flat[k] = (t.view(torch.float8_e4m3fn) if k in fp8 else t
                       ).to(dev)
    cfg_d = meta["config"]
    for k in ("layer_window_pattern",):
        if cfg_d.get(k) is not None:
            cfg_d[k] = tuple(cfg_d[k])
    return DecoderConfig(**cfg_d), _unflatten(flat)


def report(params, qparams) -> None:
    """Each quantized leaf's relative error of its dequantized weight and
    its bytes against the float leaf's."""
    flat_f, flat_q = _flatten(params), _flatten(qparams)
    for name in sorted(flat_q):
        if not name.endswith(SCALE_SUFFIX):
            continue
        base = name[:-len(SCALE_SUFFIX)]
        wq, orig = flat_q[base], flat_f.get(base)
        if orig is None:   # lm_head_q: the tied embedding, transposed
            orig = flat_f["embed/tokens"].t()
        back = dequantize_weight(wq, flat_q[name]).float()
        rel = float(torch.linalg.vector_norm(back - orig.float())
                    / max(float(torch.linalg.vector_norm(orig.float())),
                          1e-12))
        qb, ob = wq.numel() * wq.element_size(), \
            orig.numel() * orig.element_size()
        print(f"{base}: rel_err={rel:.5f} bytes={qb}/{ob} "
              f"({qb / ob:.3f}x)")


def main(argv=None) -> int:
    from deepspeed_tpu_torch.models.hf_loader import load_hf_checkpoint
    ap = argparse.ArgumentParser(
        description="offline weight-only checkpoint quantization")
    ap.add_argument("--model-dir", required=True,
                    help="HF safetensors checkpoint directory")
    ap.add_argument("--mode", default="int8", choices=MODES)
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--report", action="store_true",
                    help="print per-leaf quantization error stats")
    ap.add_argument("--device", default=None,
                    help="where to quantize: cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg, params = load_hf_checkpoint(args.model_dir, dtype=torch.float32,
                                     device=args.device)
    with torch.no_grad():
        qp = quantize_param_tree(params, mode=args.mode)
        if args.report:
            report(params, qp)
    save_quantized_npz(args.out, cfg, qp)
    total = sum(v.numel() * v.element_size()
                for v in _flatten(qp).values())
    print(f"wrote {args.out}: mode={args.mode} "
          f"{total / 1e6:.1f} MB ({cfg.num_params() / 1e6:.1f}M params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
