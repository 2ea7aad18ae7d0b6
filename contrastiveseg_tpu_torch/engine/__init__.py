"""Training engine of the port: optimizer, state, train step, evaluator,
checkpoints, trainer."""
