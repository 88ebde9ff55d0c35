"""Chunk-parallel RWKV-6 WKV recurrence: ``ref`` (plain PyTorch, step by
step), ``kernel`` (CUDA C++ for sm_90a, ``csrc/rwkv6_scan.cu``) and
``ops`` (dispatch)."""
