"""repro_torch.train: optimizers, the train step and fault tolerance (counterpart of ``repro.train``)."""
