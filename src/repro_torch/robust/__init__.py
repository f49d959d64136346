"""repro_torch.robust — recovery for long-running workloads (bare loop only)."""
