"""Training: AdamW (``optimizer``), the LM train step (``train_loop``) and
``.npz`` checkpoints (``checkpoint``)."""
