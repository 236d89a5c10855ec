"""PyTorch port of the GTRACE-RS system for NVIDIA Hopper GPUs.

Mirrors the dotted paths of the JAX package ``repro`` (for example
``repro_torch.mining.driver`` is the counterpart of
``repro.mining.driver``) and is held bit-equal to it by the
``tests/test_torch_*.py`` suites.  It imports ``torch`` and never JAX or
anything of ``repro``: the host modules it needs are its own copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU each kernel wrapper runs its plain PyTorch version.
"""
