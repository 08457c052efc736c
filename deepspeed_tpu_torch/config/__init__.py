"""config helpers of deepspeed_tpu_torch."""
