"""Step builders and optimizer settings. The serving steps of the recsys
family are ported; the training steps and the optimizers come with the
training slice (ROADMAP.md queue 1)."""
