"""Training: schedules, train state, steps, the loop, checkpoints and
metrics."""
