"""Threefry-2x32 counter-based sampling, bit for bit `jax.random`'s.

Counterpart of what the JAX package takes from `jax.random` (jax 0.9,
``jax_threefry_partitionable`` on, the default ``threefry2x32``
implementation): `prng_key` (``PRNGKey``), `split`, `fold_in`,
`random_bits` (32-bit), `uniform`, `gumbel` (the default ``"low"``
mode) and `categorical` (Gumbel-max with replacement). The same seed
gives the same key chain and the same bits as the reference, so a
seeded stream of the port equals the JAX package's.

Design:

* **Keys live on the host** as numpy ``uint32`` pairs ``[..., 2]``
  (``[hi, lo]``). `split` and `fold_in` hash a few counters with numpy
  on the host, with no device work and no sync. A batch of keys
  ``[L, 2]`` splits in one call. (Given a key tensor instead, they hash
  on its device, bitwise the same: the card's check of the hash.)
* **Bits are made on the tensor's device** from an ``[L, 2]`` key
  tensor in one batched call, on int64 tensors masked to 32 bits
  (torch's ``uint32`` lacks shifts and adds on some backends); the
  hash needs only add, rotate and xor. It is plain PyTorch with no
  hand kernel: in the reference XLA fuses it, and no Pallas call
  site exists for it.

Counter layout (partitionable mode): element ``i`` of a row-major
shape hashes the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and
32-bit bits are ``b1 ^ b2`` of the two output words; ``split(key,
n)[j]`` is the output pair of counter ``(0, j)``, and ``fold_in(key,
d)`` the output pair of counter ``(0, d)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


def _threefry2x32(k1, k2, x1, x2, add, rotl):
    """The Threefry-2x32 hash (20 rounds, five key injections) over any
    array type: ``add`` is addition mod 2**32 and ``rotl`` a 32-bit
    left rotation; xor is the type's own."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = add(x1, ks[0])
    x2 = add(x2, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = add(x1, x2)
            x2 = rotl(x2, r) ^ x1
        x1 = add(x1, ks[(i + 1) % 3])
        x2 = add(add(x2, ks[(i + 2) % 3]), i + 1)
    return x1, x2


def _np_add(a, b):
    return a + np.uint32(b) if isinstance(b, int) else a + b


def _np_rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _hash_np(keys: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """Host hash: ``keys`` [..., 2] uint32 against counter words that
    broadcast with ``keys[..., 0]``."""
    k1 = keys[..., 0].astype(np.uint32)
    k2 = keys[..., 1].astype(np.uint32)
    with np.errstate(over="ignore"):
        return _threefry2x32(k1, k2, x1.astype(np.uint32),
                             x2.astype(np.uint32), _np_add, _np_rotl)


def _t_add(a, b):
    return (a + b) & MASK


def _t_rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def as_keys(key) -> np.ndarray:
    """A key or batch of keys as a host ``uint32`` array [..., 2]."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    arr = np.asarray(key)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"a threefry key has 2 words, got shape "
                         f"{arr.shape}")
    return (arr.astype(np.int64) & MASK).astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` under x64: the seed's 64-bit two's
    complement split into ``[hi, lo]`` words, so ``[0, seed]`` for
    0 <= seed < 2**32."""
    s = int(seed)
    if not -(1 << 63) <= s < (1 << 64):
        raise OverflowError(f"seed {seed} does not fit 64 bits")
    s &= (1 << 64) - 1
    return np.array([s >> 32, s & MASK], np.uint32)


def split(key, num: int = 2):
    """``jax.random.split(key, num)``: [num, 2] keys from one key, or
    [..., num, 2] from a batch of keys [..., 2] (one hash for all).
    Host keys give a host ``uint32`` array; a key tensor is split on
    its own device (int64 words), bitwise the same."""
    if isinstance(key, torch.Tensor):
        k = key.long()[..., None, :]
        j = torch.arange(num, dtype=torch.int64, device=k.device)
        b1, b2 = _threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(j),
                               j, _t_add, _t_rotl)
        return torch.stack([b1, b2], dim=-1)
    keys = as_keys(key)[..., None, :]
    b1, b2 = _hash_np(keys, np.zeros(num, np.uint32),
                      np.arange(num, dtype=np.uint32))
    return np.stack([b1, b2], axis=-1)


def advance(key, skips: int) -> np.ndarray:
    """``skips`` carry-splits of one key (``key = split(key)[0]`` each
    time), the forced-prefix resume's skip: one hash of counter
    ``(0, 0)`` per step, in Python ints (a few microseconds each)."""
    k1, k2 = (int(w) for w in as_keys(key))
    for _ in range(int(skips)):
        k1, k2 = _threefry2x32(k1, k2, 0, 0, _t_add, _t_rotl)
    return np.array([k1, k2], np.uint32)


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)`` (``data`` as uint32), on the
    host or, for a key tensor, on its device."""
    d = int(data) & MASK
    if isinstance(key, torch.Tensor):
        k = key.long()
        b1, b2 = _threefry2x32(k[..., 0], k[..., 1], 0, d, _t_add,
                               _t_rotl)
        return torch.stack([b1, b2], dim=-1)
    keys = as_keys(key)
    b1, b2 = _hash_np(keys, np.zeros((), np.uint32),
                      np.asarray(np.uint32(d)))
    return np.stack([b1, b2], axis=-1)


def key_tensor(key, device) -> torch.Tensor:
    """Host keys [..., 2] as an int64 device tensor (a pinned,
    non-blocking copy on CUDA, so it does not wait on queued work)."""
    t = torch.from_numpy(as_keys(key).astype(np.int64))
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def random_bits(key, shape: Sequence[int], *, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: uint32 values in an
    int64 tensor on ``device``. ``key`` [2] gives ``shape``; a batch
    [L, 2] (host array or device tensor) gives [L, *shape], lane ``l``
    drawn from key ``l`` as if alone."""
    shape = tuple(int(s) for s in shape)
    if isinstance(key, torch.Tensor) and key.device.type != "cpu":
        keys = key.long()
    else:
        keys = key_tensor(key, device)
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = keys[..., 1].reshape(*lead, *([1] * len(shape)))
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    idx = idx.reshape(shape) if shape else idx.reshape(())
    b1, b2 = _threefry2x32(k1, k2, idx >> 32, idx & MASK, _t_add, _t_rotl)
    return b1 ^ b2


def uniform(key, shape: Sequence[int], *, minval: float = 0.0,
            maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits OR'd into the
    mantissa of 1.0, minus 1, scaled into [minval, maxval) and floored
    at ``minval``."""
    bits = random_bits(key, shape, device=device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape: Sequence[int], *, device="cpu") -> torch.Tensor:
    """``jax.random.gumbel`` in float32, ``mode="low"``:
    ``-log(-log(u))`` of a uniform on [tiny, 1)."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0, device=device)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis
    (Gumbel-max with replacement). One key [2] draws noise over the
    whole of ``logits``' shape, as the reference does; a batch [L, 2]
    draws row ``l`` of ``logits`` [L, V] from key ``l``."""
    keys = key if isinstance(key, torch.Tensor) else as_keys(key)
    if keys.ndim == 1:
        noise = gumbel(keys, logits.shape, device=logits.device)
    else:
        noise = gumbel(keys, logits.shape[-1:], device=logits.device)
    return torch.argmax(noise + logits, dim=-1)

