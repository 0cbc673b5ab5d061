"""Configuration: the training config subset the port honours."""
