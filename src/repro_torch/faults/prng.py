"""The reference's random draws, bit for bit: Threefry-2x32 as JAX draws it.

The reference's fault model draws from ``jax.random`` with JAX's default
generator, Threefry-2x32 (Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", SC 2011), in its *partitionable* form
(``jax_threefry_partitionable``, on by default since jax 0.5).  That form is
counter-based and fully specified, so the port computes the same words
itself instead of seeding a ``torch.Generator`` (whose stream no JAX draw
matches):

* a key is two 32-bit words ``(k1, k2)``; :func:`prng_key` of an int32
  seed is ``(0, seed mod 2**32)``;
* a draw of ``shape`` hashes the row-major 64-bit index of each element,
  split into its high and low words, with the key:
  ``(b1, b2) = threefry2x32(k1, k2, hi, lo)``;
* :func:`split` stacks ``(b1, b2)`` as the new keys, :func:`random_bits`
  is ``b1 ^ b2``;
* :func:`uniform` puts the top 23 bits of those words into the mantissa of
  a float32 in [1, 2) and subtracts 1, :func:`bernoulli` is ``uniform < p``.

The words are held in int64 tensors masked to 32 bits: a rotation needs a
logical right shift, and int32 has only the arithmetic one.  A key is a
(2,) int64 tensor on the device that draws with it, so no draw reads
anything back to the host.  These are elementwise PyTorch ops: the
reference computes its draws in XLA, not in a kernel of its own.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

__all__ = ["bernoulli", "prng_key", "random_bits", "split", "threefry2x32",
           "uniform"]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                 # Threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000               # float32 1.0

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds: the key words ``k1``, ``k2`` and the
    counter words ``x0``, ``x1`` are int64 tensors holding values in
    [0, 2**32) (broadcast together); returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as JAX computes it with 64-bit types
    off: the seed wraps to 32 bits, so the key is ``(0, seed mod 2**32)``.
    (2,) int64 words."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit a C long")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def _hash(key: torch.Tensor, shape: Tuple[int, ...]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both output words for every element of ``shape``: its row-major
    64-bit index, split into high and low words, hashed with ``key``."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK)
    return b1.reshape(shape), b2.reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) int64 key words."""
    b1, b2 = _hash(key, (int(num),))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 in [0, 2**32)."""
    b1, b2 = _hash(key, _shape(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    bits = (random_bits(key, shape) >> 9) | _ONE_BITS
    return torch.clamp_min(bits.to(torch.int32).view(torch.float32) - 1.0,
                           0.0)


def bernoulli(key: torch.Tensor, p: Union[float, torch.Tensor],
              shape: Shape = None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in float32,
    of ``p``'s shape when no shape is given."""
    if shape is None:
        shape = tuple(p.shape) if isinstance(p, torch.Tensor) else ()
    return uniform(key, shape) < p
