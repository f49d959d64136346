"""repro_torch.obs — host-side flight recorder (spans, counters, events)."""
