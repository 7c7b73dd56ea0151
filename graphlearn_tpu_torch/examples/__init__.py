"""Runnable examples of the port (``python -m graphlearn_tpu_torch.examples.<name>``)."""
