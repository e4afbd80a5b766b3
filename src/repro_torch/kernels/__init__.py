"""Hand-written Hopper kernels for the compute hot-spots, with their plain
PyTorch versions (ref.py) and the device dispatch (ops.py).

* ``morph_recon`` — morphological reconstruction by dilation (the paper's
  segmentation propagation hot-spot), CUDA C++ in ``csrc/morph_recon.cu``.
"""
