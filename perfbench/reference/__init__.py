"""Plain PyTorch references of what the cells' timed paths compute.

They import nothing of the port, of JAX or of the JAX package, take only
the inputs the benchmark makes from the seed, and run with TF32 off.
``precision="tf32"`` computes the same in the next precision below the
configurations' float32: every product's operands rounded to TF32's ten
mantissa bits, sums in float32.  That is the control, which has to come
out as not correct.
"""


def no_tf32(torch) -> None:
    """Matrix products in full float32 (no TF32), as the configurations
    state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(torch, x):
    """``x`` (float32) rounded to TF32: ten explicit mantissa bits, to
    nearest, ties away from zero, as a float32 tensor."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)
