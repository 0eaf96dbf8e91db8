"""Training of the port: the step, checkpoints and the fault supervisor."""
