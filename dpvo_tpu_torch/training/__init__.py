"""Training: the VONet rollout and its losses, and training-time validation."""
