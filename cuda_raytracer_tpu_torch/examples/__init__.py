"""Runnable demonstrations of the port's API (``python -m cuda_raytracer_tpu_torch.examples.<name>``)."""
