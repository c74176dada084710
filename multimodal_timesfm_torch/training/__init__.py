"""Training: optimizer, checkpoints, trainer and evaluator."""
