"""tpufw_torch: the PyTorch/CUDA port of ``tpufw`` for one NVIDIA H100.

The package mirrors ``tpufw``'s module names so each counterpart is easy
to find. It imports torch, numpy and the standard library only. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; without
a GPU they raise instead of carrying on quietly on the CPU.

The Pallas flash-attention kernels of ``tpufw.ops.flash`` are CUDA C++
kernels here (``tpufw_torch/ops/csrc``), built with ``nvcc`` for
``sm_90a`` at first use.
"""

__version__ = "0.1.0"
