"""Join-step compaction kernel: the first-emax compaction and phi/psi
update that follow the containment predicate in every step of the
serving join.  ``ref.py`` is the plain PyTorch version, ``ops.py`` the
wrapper, ``csrc/step_compact.cu`` the CUDA kernel."""
