"""Parallel layers of the port: the MoE layers for serving
(:mod:`deepspeed_tpu_torch.parallel.moe`)."""
