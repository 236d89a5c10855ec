"""Containment-step kernel: the per-step embedding-join predicate of the
serving path.  ``ref.py`` is the plain PyTorch version, ``ops.py`` the
wrapper, ``csrc/containment.cu`` the CUDA kernel."""
