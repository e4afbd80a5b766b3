"""Hand-written Hopper kernels for the compute hot-spots, with their plain
PyTorch versions (ref.py), their build (nvcc.py) and the device dispatch
(ops.py).

* ``morph_recon`` — morphological reconstruction by dilation (the paper's
  segmentation propagation hot-spot), CUDA C++ in ``csrc/morph_recon.cu``.
* ``label_prop`` — the pathology path's label loops (connected components
  and the watershed's seeded flood) run to their fixpoint on the card,
  CUDA C++ in ``csrc/label_prop.cu`` (one cooperative launch a loop).
* ``component_sizes`` — each pixel's component size, and the area filters'
  size test, from the label loops' labels, CUDA C++ in
  ``csrc/component_sizes.cu`` (a warp merges equal labels before its
  atomic; a count pass and a look-up pass).
* ``ssm_scan`` — the chunked diagonal-gated linear recurrence of RWKV-6 and
  Mamba2, CUDA C++ in ``csrc/ssm_scan.cu`` (parallel over chunks, three
  passes).
* ``flash_attention`` — causal, sliding-window, grouped-query attention of
  Zamba2's shared block: on the tensor cores for bf16
  (``csrc/flash_attention_wgmma.cu``, ``wgmma`` fed by TMA) and on the CUDA
  cores in IEEE fp32 otherwise (``csrc/flash_attention.cu``).
* ``decode_attention`` — one query token against a KV cache, every serve
  path's decode attention, CUDA C++ in ``csrc/decode_attention.cu`` (K and
  V read once in bf16; split over the cache, three launches).
"""
