"""repro_torch.checkpoint: atomic, asynchronous checkpoints (counterpart of ``repro.checkpoint``)."""
