"""Episodic training of the ALPNet coarse model."""
