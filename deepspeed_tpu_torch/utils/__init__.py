"""utils helpers of deepspeed_tpu_torch."""
