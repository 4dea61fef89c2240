"""uint32 arithmetic for the plain PyTorch versions.

PyTorch stores ``torch.uint32`` but implements few operations on it (on
the CPU there is no UInt32 ``>>``, ``<<``, ``+``, ``<`` or ``minimum``).
The plain versions therefore carry u32 values in ``int64`` tensors holding
``[0, 2**32)``, and every helper here returns values in that range. The
same code runs on the CPU and on the card.

``uint32`` stays the storage dtype at public interfaces (it matches the
JAX layouts bit for bit); :func:`widen` and :func:`narrow` convert.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """uint32 / int32 tensor -> int64 tensor of the same u32 values."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values (any int64: reduced mod 2**32) ->
    uint32 tensor."""
    x = x & M32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).view(
        torch.uint32)


def add(*xs: torch.Tensor) -> torch.Tensor:
    """Wrapping sum (mod 2**32) of u32 values (up to 2**31 terms)."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out & M32


def mul(a: torch.Tensor, c: int | torch.Tensor) -> torch.Tensor:
    """Wrapping product (mod 2**32). The 32x32 product can exceed int64, so
    it is split at 16 bits: both partial products stay below 2**48."""
    lo = a * (c & 0xFFFF)
    hi = (a * ((c >> 16) & 0xFFFF)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def shr(x: torch.Tensor, n: int | torch.Tensor) -> torch.Tensor:
    """Logical right shift (values are non-negative, so ``>>`` is
    logical)."""
    return x >> n


def shl(x: torch.Tensor, n: int | torch.Tensor) -> torch.Tensor:
    """Left shift, truncated to 32 bits (n in [0, 32])."""
    return (x << n) & M32


def rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate right by a constant 0 < n < 32."""
    return ((x >> n) | (x << (32 - n))) & M32


def bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of each u32 value (LE word <-> BE word)."""
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x & 0xFF) << 24))


def fmix32(x: torch.Tensor, m1: int, m2: int) -> torch.Tensor:
    """lowbias32 finalizer (the Gear and anchor hashes share it)."""
    x = x ^ (x >> 16)
    x = mul(x, m1)
    x = x ^ (x >> 15)
    x = mul(x, m2)
    return x ^ (x >> 16)
