"""The step roofline on one H100: FLOPs and bytes counted on fake
tensors (``op_cost``) over the card's data-sheet rates (``analysis``)."""
