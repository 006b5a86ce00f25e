"""The split 3xTF32 product of the port's K5 and K6 scans, in torch, for
the tests that emulate those kernels' arithmetic on the CPU.

The kernels round hi = x to TF32 (10 mantissa bits, to nearest) by adding
half a TF32 ulp to the bits and masking, take lo = x - hi, which the tensor
core reads as TF32 (its low 13 bits ignored), and form
a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, the two small terms summed apart
from the main one and added last.
"""
import torch

__all__ = ["round_tf32", "as_tf32", "mm3"]


def round_tf32(x):
    """x (f32) rounded to TF32 as the kernels do it."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def as_tf32(x):
    """What the tensor core reads of an f32 operand: its low 13 bits
    ignored."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b as the kernels' 3xTF32 products."""
    ah, bh = round_tf32(a), round_tf32(b)
    al, bl = as_tf32(a - ah), as_tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)
