"""Parallel layers of the port: the MoE layers for serving and training
(:mod:`deepspeed_tpu_torch.parallel.moe`)."""
