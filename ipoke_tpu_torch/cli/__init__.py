"""The experiment layer and the CLI's experiments."""
