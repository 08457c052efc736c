"""Model code of the port (decoder core for serving and training)."""

from deepspeed_tpu_torch.models.convert import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.models.llama import llama3_config
from deepspeed_tpu_torch.models.mixtral import mixtral_config
from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config
from deepspeed_tpu_torch.models.transformer import (DecoderConfig,
                                                    chunked_cross_entropy,
                                                    cross_entropy_loss,
                                                    dot_product_attention,
                                                    forward, forward_hidden,
                                                    init_params, lm_logits)

__all__ = ["DecoderConfig", "init_params", "lm_logits", "forward",
           "forward_hidden", "chunked_cross_entropy", "cross_entropy_loss",
           "dot_product_attention", "llama3_config", "mixtral_config",
           "qwen2_moe_config", "params_from_jax", "params_to_numpy"]
