"""Paged KV cache: the preallocated block pool + host-side allocator
(the port of torchacc_tpu/serve/kv_cache.py; the host logic is the
same, the pools are torch tensors on the device).

One pool per layer of shape ``[num_blocks, block_size, kv_heads,
head_dim]`` for keys and the same for values, stacked over layers into
``[L, NB, BS, KH, D]``.  A sequence's cache is the list of blocks named
by its block table.  Block 0 is the NULL BLOCK: free decode slots and
masked prefill tokens write their k/v there, so the forward needs no
write masking; the allocator never hands it out.

Prefix sharing: blocks are refcounted, and a :class:`PrefixIndex` maps a
hash chain over each FULL block of prompt tokens (``key_i =
blake2b(key_{i-1} || tokens[i*bs:(i+1)*bs])``) to the pool block that
holds that span's k/v.  A block whose last reference drops moves to a
cached LRU list, matchable until the allocator reclaims it.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchacc_tpu_torch.utils.metrics import counters


def blocks_needed(num_tokens: int, block_size: int) -> int:
    """Blocks required to hold ``num_tokens`` cache slots."""
    return -(-max(num_tokens, 0) // block_size)


class PrefixIndex:
    """Token-hash prefix index over pool blocks (radix-style chain):
    a full block's key is the 16-byte blake2b digest of its parent's key
    followed by its token ids, so a key encodes the block's position and
    the whole prefix before it.  Entries point at ALLOCATED or CACHED
    blocks; the pool calls :meth:`forget` when it evicts one."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._by_key: Dict[bytes, int] = {}
        self._key_of: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self._by_key)

    def keys(self, prompt: np.ndarray) -> List[bytes]:
        """Chain keys for every FULL block of ``prompt``."""
        bs = self.block_size
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        out: List[bytes] = []
        parent = b""
        for i in range(int(toks.shape[0]) // bs):
            h = hashlib.blake2b(parent, digest_size=16)
            h.update(toks[i * bs:(i + 1) * bs].tobytes())
            parent = h.digest()
            out.append(parent)
        return out

    def match(self, keys: List[bytes]) -> List[int]:
        """Blocks of the longest resident chain ``keys[0..m)``."""
        blocks: List[int] = []
        for k in keys:
            b = self._by_key.get(k)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def register(self, key: bytes, block: int) -> bool:
        """Map ``key`` -> ``block``; False (no-op) when the key is
        already mapped (first writer wins) or the block carries a key."""
        if key in self._by_key or block in self._key_of:
            return False
        self._by_key[key] = block
        self._key_of[block] = key
        return True

    def owns(self, block: int) -> bool:
        return block in self._key_of

    def forget(self, block: int) -> None:
        k = self._key_of.pop(block, None)
        if k is not None:
            del self._by_key[k]

    def clear(self) -> int:
        n = len(self._by_key)
        self._by_key.clear()
        self._key_of.clear()
        return n


class BlockPool:
    """Refcounted free-list allocator over pool blocks 1..num_blocks-1.

    A block is FREE, ALLOCATED (refcount >= 1) or CACHED (refcount 0,
    indexed, in an LRU that :meth:`alloc` evicts oldest-first).
    Invariants: block 0 is never handed out; freeing a block with no
    outstanding reference raises; eviction takes only refcount-0 cached
    blocks; ``available + in_use == num_blocks - 1``."""

    def __init__(self, num_blocks: int, index: Optional[PrefixIndex] = None):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (block 0 is reserved), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._index = index
        self.evictions = 0

    @property
    def available(self) -> int:
        """Blocks an ``alloc`` could grant: free + evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def in_use(self) -> int:
        return len(self._ref)

    @property
    def cached(self) -> int:
        return len(self._cached)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= self.available

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` blocks, or None when the pool lacks headroom (never a
        partial grant); evicts cached blocks oldest-first if needed."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.available:
            return None
        while len(self._free) < n:
            b, _ = self._cached.popitem(last=False)
            if self._index is not None:
                self._index.forget(b)
            self.evictions += 1
            counters.inc("prefix_evictions")
            self._free.append(b)
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        return blocks

    def share(self, block: int) -> None:
        """One more reference on an allocated block, or revive a cached
        one (prefix hit)."""
        if block in self._ref:
            self._ref[block] += 1
        elif block in self._cached:
            del self._cached[block]
            self._ref[block] = 1
        else:
            raise ValueError(
                f"share of block {block} which is neither allocated nor "
                f"cached (stale prefix-index entry, or a block this pool "
                f"never handed out)")

    def free(self, blocks: List[int]) -> None:
        """Release one reference per listed block; the last release
        parks an indexed block in the cached LRU."""
        for b in blocks:
            r = self._ref.get(b)
            if r is None:
                raise ValueError(
                    f"free of block {b} which is not allocated (double "
                    f"free, or a block this pool never handed out)")
            if r > 1:
                self._ref[b] = r - 1
                continue
            del self._ref[b]
            if self._index is not None and self._index.owns(b):
                self._cached[b] = None
            else:
                self._free.append(b)

    def flush_cached(self) -> int:
        """Drop every cached block and every index entry."""
        n = len(self._cached)
        while self._cached:
            b, _ = self._cached.popitem(last=False)
            if self._index is not None:
                self._index.forget(b)
            self._free.append(b)
        if self._index is not None:
            self._index.clear()
        return n


def make_pools(model_cfg, serve_cfg, device: torch.device,
               dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_pools, v_pools), each ``[L, NB, BS, KH, D]`` of zeros on
    ``device`` in the compute dtype."""
    shape = (model_cfg.num_layers, serve_cfg.num_blocks,
             serve_cfg.block_size, model_cfg.kv_heads, model_cfg.head_size)
    dt = dtype or model_cfg.dtype
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))
