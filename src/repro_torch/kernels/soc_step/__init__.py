"""The fused Cohmeleon episode step: ``ref`` (plain PyTorch), ``kernel``
(CUDA C++ for sm_90a, ``csrc/soc_step.cu``) and ``ops`` (dispatch)."""
