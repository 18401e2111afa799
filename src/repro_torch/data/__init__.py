"""Synthetic data: the MNIST/image surrogates and the token stream."""
