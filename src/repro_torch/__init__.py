"""PyTorch / CUDA port of the reproduction of "Can Tensor Cores Benefit
Memory-Bound Kernels? (No!)".

Every kernel of the paper's experiment has a CUDA-core (vector) and a
tensor-core (matrix) kernel written by hand for Hopper (``sm_90a``),
built from ``kernels/csrc`` at first use.  Entry points run on the card
unless the caller passes CPU tensors with ``backend="plain"``.
"""
