"""Training: the synthetic streams and the datasets, the augmentation,
the causal-LM and image-classification tasks and their optimizers, and
the train-step engine."""
