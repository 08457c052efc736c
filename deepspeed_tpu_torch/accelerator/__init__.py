"""accelerator helpers of deepspeed_tpu_torch."""
