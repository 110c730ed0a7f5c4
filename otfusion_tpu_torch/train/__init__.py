"""Training: losses, optimiser, steps, per-epoch coupling, epoch loop."""
