"""Blockwise online-softmax attention: ``ref`` (plain PyTorch), ``kernel``
(CUDA C++ for sm_90a, ``csrc/flash_attention.cu``) and ``ops``
(dispatch)."""
