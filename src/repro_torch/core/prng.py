"""JAX's key chain and Gumbel-max sampler, in torch.

The serving engine samples at a temperature as the JAX package's does:
``jax.random.categorical(key, logits / T)`` from a key chain that starts
at ``PRNGKey(seed)`` and splits once a token. This module is the part of
``jax.random`` that chain touches, for the default threefry PRNG with
``jax_threefry_partitionable`` on (the default since JAX 0.5) and 64-bit
types off, so the same seed and logits give the same tokens here:

  ``threefry2x32``  the Threefry-2x32 hash, 20 rounds;
  ``prng_key``      ``PRNGKey(seed)``: the seed's low word;
  ``split``         the fold-like split: the hash of the 64-bit iota;
  ``random_bits``   ``bits1 ^ bits2`` over the iota of the shape;
  ``uniform``       the mantissa trick of ``jax._src.random._uniform``;
  ``gumbel``        ``-log(-log(u))`` with u in [tiny, 1) ("low" mode);
  ``categorical``   ``argmax(logits + gumbel)`` over the last axis.

A key is two Python ints on the host, so splitting costs no device
work. Bits are int64 tensors masked to 32 bits (torch's ``uint32`` has
few operators) and reach floats by bit-casting ``int32`` / ``int16``.
``uniform`` and what builds on it take the compute dtypes of the
registry, ``float32`` and ``bfloat16``, and raise on any other. The
same functions run on the CPU and on the card: noise is made on the
device of the logits it is added to.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# float dtype -> (bits of the float, mantissa bits, int type of its width)
_FLOATS = {torch.float32: (32, 23, torch.int32),
           torch.bfloat16: (16, 7, torch.int16)}


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 of the counters ``(x1, x2)`` under the key
    ``(k1, k2)``: Python ints or int64 tensors holding 32-bit words."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    a, b = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK
    return a, b


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed is
    taken as a 32-bit integer, so the high word is 0."""
    return 0, int(seed) & MASK


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)``: key ``i`` is the hash of the counter
    pair ``(0, i)``, the 64-bit iota's high and low words."""
    return threefry2x32(*key, 0, 0), threefry2x32(*key, 0, 1)


def random_bits(key: Key, bit_width: int, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """``jax.random.bits``'s words of ``bit_width`` (8, 16 or 32) as an
    int64 tensor of ``shape`` on ``device``."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    iota = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(*key, iota >> 32, iota & MASK)
    return ((b1 ^ b2) & ((1 << bit_width) - 1)).reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int], dtype: torch.dtype,
            minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform``: random mantissa bits under the exponent
    of 1.0, minus 1, scaled into ``[minval, maxval)``. A type of fewer
    than 8 mantissa bits (bfloat16) draws 8 bits a value."""
    if dtype not in _FLOATS:
        raise TypeError(f"uniform takes float32 or bfloat16, got {dtype}")
    nbits, nmant, itype = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, rng_bits, shape, device)
    one = torch.tensor(1.0, dtype=dtype).view(itype).item()
    floats = ((bits >> (rng_bits - nmant)) | one).to(itype).view(dtype)
    # the bounds as ``dtype`` holds them, and their difference rounded in
    # ``dtype``: exact as Python scalars, so each op below rounds once in
    # ``dtype``, as XLA's do, with no host-to-device copy
    lo, hi = (torch.tensor(v, dtype=dtype) for v in (minval, maxval))
    span, lo = (hi - lo).item(), lo.item()
    return ((floats - 1.0) * span + lo).clamp_min(lo)


def gumbel(key: Key, shape: Sequence[int], dtype: torch.dtype,
           device=None) -> torch.Tensor:
    """``jax.random.gumbel`` in its default "low" mode."""
    if dtype not in _FLOATS:
        raise TypeError(f"gumbel takes float32 or bfloat16, got {dtype}")
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    first index of the largest ``gumbel + logits``, in the logits' dtype
    and on their device."""
    noise = gumbel(key, logits.shape, logits.dtype, logits.device)
    return torch.argmax(noise + logits, dim=-1)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| elementwise, on the host, in bf16 spacings at the larger
    magnitude: how far two devices' bf16 noise (or any two bf16
    tensors) lie apart."""
    a, b = a.float().cpu(), b.float().cpu()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(
        torch.finfo(torch.bfloat16).tiny)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)
