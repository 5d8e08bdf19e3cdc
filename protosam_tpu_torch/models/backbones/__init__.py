"""Convolutional coarse backbones."""
