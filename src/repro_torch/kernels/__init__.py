"""Hand-written Hopper kernels for the compute hot-spots, with their plain
PyTorch versions (ref.py), their build (nvcc.py) and the device dispatch
(ops.py).

* ``morph_recon`` — morphological reconstruction by dilation (the paper's
  segmentation propagation hot-spot), CUDA C++ in ``csrc/morph_recon.cu``.
* ``ssm_scan`` — the chunked diagonal-gated linear recurrence of RWKV-6 and
  Mamba2, CUDA C++ in ``csrc/ssm_scan.cu``.
* ``flash_attention`` — causal, sliding-window, grouped-query attention
  (FlashAttention-2's forward pass) of Zamba2's shared block, CUDA C++ in
  ``csrc/flash_attention.cu``.
"""
