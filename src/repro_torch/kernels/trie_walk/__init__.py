"""Fused trie-walk kernel: the whole subtree walk of the serving path's
``trie_fused`` layout in one launch.  ``ref.py`` is the plain PyTorch
version, ``ops.py`` the wrapper, ``csrc/trie_walk.cu`` the CUDA kernel."""
