"""Evaluation: the models of an experiment configuration."""
