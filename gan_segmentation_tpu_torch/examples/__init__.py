"""Runnable demonstrations of the port (``python -m
gan_segmentation_tpu_torch.examples.<name>``)."""
