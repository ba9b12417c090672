"""Training data: :mod:`repro_torch.data.pipeline`."""
