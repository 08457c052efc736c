"""Model code of the port (serving subset of the decoder core)."""

from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.llama import llama3_config
from deepspeed_tpu_torch.models.transformer import (DecoderConfig,
                                                    dot_product_attention,
                                                    init_params, lm_logits)

__all__ = ["DecoderConfig", "init_params", "lm_logits",
           "dot_product_attention", "llama3_config", "params_from_jax"]
