"""Hand-written Hopper kernels, one for each TPU kernel of the JAX package.

  nest_gemm        csrc/nest_gemm.cu     act(X @ W), IO-S transposed store
  fused_chain      csrc/fused_chain.cu   a chained segment in one launch
  flash_attention  csrc/flash_decode.cu  batched ragged decode attention
                   csrc/flash_decode_proj.cu
                                         ... with the adapt + Wo projection
                   csrc/flash_attention.cu
                                         prefill attention, causal or full
  mamba_scan       csrc/mamba_scan.cu    the selective-scan recurrence
  ref              the plain PyTorch version of each kernel
  ops              wrappers: the kernel on the card, the plain version on
                   the CPU
  build            nvcc into ``_build/`` at first use, loaded via ctypes
"""
