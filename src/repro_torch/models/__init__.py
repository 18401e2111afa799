"""Decoder-LM building blocks on torch tensors (dense attention + MLP)."""
