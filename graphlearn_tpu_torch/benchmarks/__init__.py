"""The port's probe suites (``python -m graphlearn_tpu_torch.benchmarks.<name>``)."""
