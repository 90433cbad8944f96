"""Training workloads of the port."""
