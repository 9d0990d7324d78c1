"""Hand-written Hopper kernels, one for each TPU kernel of the JAX package.

  nest_gemm        csrc/nest_gemm.cu     act(X @ W), IO-S transposed store
  fused_chain      csrc/fused_chain.cu   a chained segment in one launch
  flash_attention  csrc/flash_decode.cu  batched ragged decode attention
                   csrc/flash_decode_proj.cu
                                         ... with the adapt + Wo projection
                   csrc/flash_attention.cu
                                         prefill attention, causal or full
                   csrc/flash_attention_bwd.cu
                                         ... its gradients (dq, dk, dv)
  mamba_scan       csrc/mamba_scan.cu    the selective-scan recurrence
                   csrc/mamba_scan_bwd.cu
                                         ... its gradients, reverse scan
  ref              the plain PyTorch version of each kernel
  ops              wrappers: the kernel on the card, the plain version on
                   the CPU; autograd Functions for the two with gradients
  build            nvcc into ``_build/`` at first use, loaded via ctypes
"""
