"""Evaluation: the ProtoSAM and ALPNet-only drivers and test-time
training."""
