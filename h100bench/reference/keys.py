"""[The benchmark's plain reference: a frozen copy of the program's
`acmmp_tpu_torch/ops/keys.py`, its plain (non-kernel) path only, importing
nothing of the program. Its original text follows.]

Explicit random keys: a numpy threefry2x32 that yields the same key
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

``KeyBatch`` holds B keys, one per view of a batched solve; ``split`` and
``fold_in`` take it too and give each view the words its own key would
give (``jax.vmap(jax.random.split)``, as the JAX package's batched
executor derives its stage keys). The words stay on the host; the pixel
hash reads them from ``KeyBatch.words_on``, one copy to the device per
key.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(k0: int, k1: int, x0, x1):
    """The 20-round threefry2x32 block cipher on uint32 arrays."""
    k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
    ks = [k0, k1, k0 ^ k1 ^ _PARITY]
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


class KeyBatch:
    """B threefry keys, one per view of a batch: their words [B, 2]
    uint32 on the host."""

    def __init__(self, words):
        self.words = np.asarray(words, np.uint32).reshape(-1, 2)
        self._on = {}

    def __len__(self) -> int:
        return self.words.shape[0]

    def words_on(self, device):
        """(k0, k1), each a [B, 1, 1] int64 tensor on `device`, to
        broadcast over [B, H, W] grids; copied once per device, from
        pinned memory without waiting on the device's queue."""
        dev = torch.device(device)
        if dev not in self._on:
            w = torch.from_numpy(self.words.astype(np.int64))
            if dev.type == "cuda":
                w = w.pin_memory().to(dev, non_blocking=True)
            w = w.reshape(-1, 1, 1, 2)
            self._on[dev] = (w[..., 0], w[..., 1])
        return self._on[dev]


AnyKey = Union[Key, KeyBatch]


def stack(ks: Sequence[Key]) -> KeyBatch:
    """One KeyBatch of per-view Keys."""
    return KeyBatch([k.data for k in ks])


def _words(k: AnyKey):
    if isinstance(k, KeyBatch):
        return k.words[:, 0, None], k.words[:, 1, None]     # [B, 1]
    return k.k0, k.k1


def _keys(k: AnyKey, b0, b1):
    """The n keys of threefry blocks b0, b1 ([n], or [B, n] for a
    batch)."""
    if isinstance(k, KeyBatch):
        return [KeyBatch(np.stack([b0[:, i], b1[:, i]], -1))
                for i in range(b0.shape[1])]
    return [Key(int(a), int(b)) for a, b in zip(b0, b1)]


def split(k: AnyKey, num: int = 2):
    """``jax.random.split(k, num)`` as a list of Keys (of KeyBatches,
    each view's split, for a KeyBatch)."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(*_words(k), np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
    return _keys(k, b0, b1)


def fold_in(k: AnyKey, data: int) -> AnyKey:
    """``jax.random.fold_in(k, data)`` (of each view's key, for a
    KeyBatch)."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(*_words(k), np.zeros(1, np.uint32),
                              np.asarray([int(data) & 0xFFFFFFFF], np.uint32))
    return _keys(k, b0, b1)[0]
