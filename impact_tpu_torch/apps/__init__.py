"""Applications of the port (``python -m impact_tpu_torch.apps.<name>``)."""
