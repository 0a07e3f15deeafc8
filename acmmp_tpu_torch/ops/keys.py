"""Explicit random keys: a numpy threefry2x32 that yields the same key
words as ``jax.random.key`` / ``split`` / ``fold_in``.

The JAX package derives every random stream from a threefry key
(``engine/patchmatch.py`` splits and folds per sweep; ``ops/sampling.py``
splits per plane draw) and hands the two raw key words to its per-pixel
hash (``ops/pixel_rng.py``). Reproducing the key schedule word for word
lets both packages solve the same problem with the same random stream.

The variant reproduced is JAX's partitionable threefry (the default of
current JAX, ``jax_threefry_partitionable=True``):
  * ``split(key, n)[i] = threefry2x32(key, (0, i))`` — the fold-like split;
  * ``fold_in(key, d) = threefry2x32(key, (0, d))`` — the threefry of the
    seed words of ``d``;
  * ``key(seed) = (seed >> 32, seed & 0xFFFFFFFF)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(k0: int, k1: int, x0, x1):
    """The 20-round threefry2x32 block cipher on uint32 arrays."""
    ks = [np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ _PARITY]
    x = [np.atleast_1d(np.asarray(x0, np.uint32)) + ks[0],
         np.atleast_1d(np.asarray(x1, np.uint32)) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


@dataclasses.dataclass(frozen=True)
class Key:
    """A threefry key: its two uint32 words (``jax.random.key_data``)."""

    k0: int
    k1: int

    @property
    def data(self) -> np.ndarray:
        return np.asarray([self.k0, self.k1], np.uint32)


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a non-negative integer seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("key: seed must be non-negative")
    return Key((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)


def from_key_data(data) -> Key:
    """A Key from the two words ``jax.random.key_data`` returns."""
    d = np.asarray(data, np.uint32).reshape(2)
    return Key(int(d[0]), int(d[1]))


def split(k: Key, num: int = 2):
    """``jax.random.split(k, num)`` as a list of Keys."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(k.k0, k.k1, np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
    return [Key(int(a), int(b)) for a, b in zip(b0, b1)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(k.k0, k.k1, np.zeros(1, np.uint32),
                              np.asarray([int(data) & 0xFFFFFFFF], np.uint32))
    return Key(int(b0[0]), int(b1[0]))
