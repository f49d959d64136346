"""repro_torch.io — graph generators (numpy, host-side)."""
