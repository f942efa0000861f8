"""repro_torch.data: the synthetic training stream (counterpart of ``repro.data``)."""
