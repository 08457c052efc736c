"""Command-line tools of the port (``python -m
deepspeed_tpu_torch.cli.<tool>``): :mod:`.dstpu_quantize`, the offline
weight quantizer."""
