"""PyTorch port of the MIG scheduler reproduction (see ``repro_torch.sim.batched``)."""
