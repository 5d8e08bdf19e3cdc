"""Measurement tools of the port, the counterparts of the JAX package's
``tools/*.py``.  Each runs on the card only:
``python3 -m protosam_tpu_torch.tools.<name>``."""
