"""Training: the synthetic LM stream, the causal-LM task and optimizer,
and the train-step engine."""
