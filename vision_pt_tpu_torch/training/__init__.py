"""Training runtime of the port: the Trainer, the workload contract,
optimizers, schedules and the EMA."""
