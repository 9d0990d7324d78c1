"""Hand-written Hopper kernels for the serving main path.

  nest_gemm        csrc/nest_gemm.cu     act(X @ W), IO-S transposed store
  fused_chain      csrc/fused_chain.cu   a chained segment in one launch
  flash_attention  csrc/flash_decode.cu  batched ragged decode attention
  ref              the plain PyTorch version of each kernel
  ops              wrappers: the kernel on the card, the plain version on
                   the CPU
  build            nvcc into ``_build/`` at first use, loaded via ctypes
"""
