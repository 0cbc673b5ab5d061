"""Observability: the training path's MFU and goodput accounting."""
