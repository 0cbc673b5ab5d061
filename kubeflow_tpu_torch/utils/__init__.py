"""Shared utilities: logging, metrics, device selection."""
