"""repro_torch.apps — the paper's applications, built on repro_torch.core."""
