"""Ragged grouped expert matmul: ``ref`` (plain PyTorch), ``kernel`` (CUDA
C++ for sm_90a, ``csrc/moe_gmm.cu``) and ``ops`` (dispatch)."""
