"""Training: optimizers, the train step, checkpoints and the quick-fit
fixtures (port of ``repro/train``)."""
