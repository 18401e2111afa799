"""QPART's decision layer: quantizer, noise model, partitioning, cost
model and solver."""
