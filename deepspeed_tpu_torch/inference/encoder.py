"""Encoder (BERT-class) scoring engine.

Port of ``deepspeed_tpu/inference/encoder.py`` (``EncoderInferenceTPU``;
the reference served encoders through the kernel-injection containers,
module_inject/containers/bert.py and distil_bert.py): batched scoring, no
decode loop. The engine owns the v1 engine's bring-up (dtype policy,
weight-only quantization through
:func:`deepspeed_tpu_torch.inference.engine.setup_engine_params`) and the
padding: a ragged list of sequences is right-padded with a key mask, so
padding keys never reach a real position of a bidirectional model, and
each output is trimmed to its sequence's given length.

The batch pads to its longest sequence only. The JAX engine pads to
64-token and power-of-two batch buckets so that variable shapes share XLA
compiles; eager PyTorch compiles nothing, so the port computes no padding
it does not need.
"""

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import (_parse_config,
                                                  setup_engine_params)
from deepspeed_tpu_torch.models.transformer import (DecoderConfig, forward,
                                                    forward_hidden, with_tp)
from deepspeed_tpu_torch.utils.logging import log_dist


class EncoderInference:
    """Batched encoder scoring — the port of ``EncoderInferenceTPU``
    (deepspeed_tpu/inference/encoder.py:30): ``__call__`` returns MLM
    logits (or final hidden states) for batches of any length.
    ``params``/``generator``/``device`` as :class:`InferenceEngine`'s."""

    def __init__(self, model: DecoderConfig,
                 config: Union[Dict[str, Any], None] = None,
                 params=None, generator: Optional[torch.Generator] = None,
                 device=None, mesh=None):
        config = _parse_config(config)
        if model.causal:
            raise ValueError(
                "EncoderInference is for bidirectional (causal=False) "
                "models; use InferenceEngine / the ragged engine for "
                "decoder models")
        self.config = config
        self.device, self.dtype, self.params, _, self.mesh = \
            setup_engine_params(model, config, params, generator, device,
                                mesh)
        # tensor parallelism (encoder.py:37-60): this rank's 'model'
        # shards, the MLM logits gathered over the axis
        self.tp_size = self.mesh.shape["model"] if self.mesh else 1
        self.model_config = with_tp(model, self.tp_size)
        log_dist(f"encoder engine ready: tp={self.tp_size} "
                 f"dtype={config.dtype} device={self.device}")

    def __call__(self, input_ids: Union[np.ndarray, Sequence[Sequence[int]]],
                 attention_mask: Optional[np.ndarray] = None,
                 token_type_ids: Optional[np.ndarray] = None,
                 output: str = "logits") -> List[np.ndarray]:
        """Score a batch (encoder.py:77-146). ``input_ids``: a [B, T] array
        or a ragged list of token lists (right-padded and masked here).
        Returns B arrays, each trimmed to its given length: [t_i, V] fp32
        logits (``output='logits'``) or [t_i, D] hidden states
        (``output='hidden'``, fp32)."""
        if output not in ("logits", "hidden"):
            raise ValueError(f"output must be 'logits'|'hidden', "
                             f"got '{output}'")
        if not isinstance(input_ids, np.ndarray):
            lens = [len(s) for s in input_ids]
            tmax = max(lens)
            ids = np.zeros((len(lens), tmax), np.int32)
            mask = np.zeros((len(lens), tmax), np.int32)
            for i, s in enumerate(input_ids):
                ids[i, :len(s)] = np.asarray(s, np.int32)
                if attention_mask is not None:
                    # a caller's mask row by row (a sequence may hold pad
                    # tokens of its own)
                    mask[i, :len(s)] = np.asarray(attention_mask[i],
                                                  np.int32)[:len(s)]
                else:
                    mask[i, :len(s)] = 1
            # lens stay the given lengths: outputs are trimmed to what the
            # caller passed, masked positions inside included
            if token_type_ids is not None:
                tt = np.zeros((len(lens), tmax), np.int32)
                for i, s in enumerate(token_type_ids):
                    tt[i, :len(s)] = np.asarray(s, np.int32)
                token_type_ids = tt
            input_ids, attention_mask = ids, mask
        else:
            input_ids = np.asarray(input_ids, np.int32)
            lens = [input_ids.shape[1]] * input_ids.shape[0] \
                if attention_mask is None else \
                [int(m.sum()) for m in np.asarray(attention_mask)]
        b, t = input_ids.shape
        if t > self.model_config.max_seq_len:
            raise ValueError(f"sequence length {t} exceeds model "
                             f"max_seq_len {self.model_config.max_seq_len}")
        mask = np.ones((b, t), np.int32) if attention_mask is None else \
            np.asarray(attention_mask, np.int32)
        types = np.zeros((b, t), np.int32) if token_type_ids is None else \
            np.asarray(token_type_ids, np.int32)
        # one host → device copy for the three int inputs
        packed = torch.from_numpy(np.stack([input_ids, mask, types])
                                  ).to(self.device)
        tokens, key_mask, segments = packed.unbind(0)
        cfg = self.model_config
        with torch.no_grad():
            if output == "hidden":
                out, _ = forward_hidden(cfg, self.params, tokens,
                                        token_type_ids=segments,
                                        attention_mask=key_mask)
            else:
                out = forward(cfg, self.params, tokens,
                              token_type_ids=segments,
                              attention_mask=key_mask)
            out = out.float().cpu().numpy()
        return [out[i, :lens[i]] for i in range(b)]


def init_encoder_inference(model: DecoderConfig, config=None, **kw
                           ) -> EncoderInference:
    """The encoder engine's constructor by the reference's name
    (``deepspeed.init_inference`` routed encoders through one entry
    point; encoder.py:149)."""
    return EncoderInference(model, config, **kw)
