"""Runtime: the training-run entry point."""
