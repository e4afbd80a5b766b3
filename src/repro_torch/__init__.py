"""repro_torch — the PyTorch and CUDA port of ``repro`` for one NVIDIA H100:
the run-time parameter sensitivity analysis system (multi-level computation
reuse, RTMA merging, RMSR scheduling, Manager–Worker dispatch) over the
pathology segmentation workflow, with a hand-written Hopper kernel for
reconstruction by dilation.

It imports torch and numpy, never jax and nothing of ``repro``; the tests
hold it against ``repro`` on the same inputs.
"""

__version__ = "1.0.0"
