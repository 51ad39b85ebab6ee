"""Training: the two stages' steps, their optimizer, the loop, and the
port's own checkpoints."""
