"""Inference trainer, checkpoint IO and metrics of the port."""
