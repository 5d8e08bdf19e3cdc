"""Host C++ libraries (JAX ``native/``): the NIfTI feeder and the
Felzenszwalb segmentation, built with g++ at first use
(``native/build.py``)."""

from protosam_tpu_torch.native.feeder import (  # noqa: F401
    native_available,
    preprocess_volume_native,
    read_volume_native,
    resize_labels_native,
)
