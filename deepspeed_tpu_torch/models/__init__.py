"""Model code of the port (decoder core for serving and training), the
preset families and the HF checkpoint loader/exporter."""

from deepspeed_tpu_torch.models.convert import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.models.transformer import (DecoderConfig,
                                                    chunked_cross_entropy,
                                                    cross_entropy_loss,
                                                    dot_product_attention,
                                                    forward, forward_hidden,
                                                    init_params, lm_logits)
from deepspeed_tpu_torch.models.gpt import gpt2_config
from deepspeed_tpu_torch.models.llama import llama3_config
from deepspeed_tpu_torch.models.mixtral import mixtral_config
from deepspeed_tpu_torch.models.mistral import mistral_config
from deepspeed_tpu_torch.models.qwen import qwen_config
from deepspeed_tpu_torch.models.qwen2 import qwen2_config
from deepspeed_tpu_torch.models.falcon import falcon_config
from deepspeed_tpu_torch.models.gptneox import gptneox_config
from deepspeed_tpu_torch.models.phi import phi_config
from deepspeed_tpu_torch.models.opt import opt_config
from deepspeed_tpu_torch.models.gemma import gemma_config
from deepspeed_tpu_torch.models.bloom import bloom_config
from deepspeed_tpu_torch.models.gpt_bigcode import gpt_bigcode_config
from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config
from deepspeed_tpu_torch.models.gptj import gptj_config
from deepspeed_tpu_torch.models.bert import bert_config, distilbert_config
from deepspeed_tpu_torch.models.gptneo import gptneo_config
from deepspeed_tpu_torch.models.internlm import internlm_config

__all__ = ["DecoderConfig", "init_params", "lm_logits", "forward",
           "forward_hidden", "chunked_cross_entropy", "cross_entropy_loss",
           "dot_product_attention", "params_from_jax", "params_to_numpy",
           "gpt2_config", "llama3_config", "mixtral_config",
           "mistral_config", "qwen_config", "qwen2_config", "falcon_config",
           "gptneox_config", "gpt_bigcode_config", "qwen2_moe_config",
           "gptj_config", "phi_config", "opt_config", "gemma_config",
           "bloom_config", "bert_config", "distilbert_config",
           "gptneo_config", "internlm_config"]
