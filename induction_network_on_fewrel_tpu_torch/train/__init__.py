"""Training: the optimizer chain and steps, checkpoints, the trainer loop."""
