"""Training on one card: optimizer and schedule, train and eval steps,
checkpoints, statistics."""
