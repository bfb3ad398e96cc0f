"""The port's BlockPool / PrefixIndex: the JAX package's invariants
(tests/test_serving.py, tests/test_prefix_cache.py) mirrored, and the
same operation sequence giving the same block ids and chain keys in
both packages."""

import numpy as np
import pytest

from torchacc_tpu.serve.kv_cache import BlockPool as JaxBlockPool
from torchacc_tpu.serve.kv_cache import PrefixIndex as JaxPrefixIndex
from torchacc_tpu_torch.serve.kv_cache import (
    BlockPool,
    PrefixIndex,
    blocks_needed,
)


def test_blocks_needed_edges():
    assert blocks_needed(0, 8) == 0
    assert blocks_needed(1, 8) == 1
    assert blocks_needed(8, 8) == 1
    assert blocks_needed(9, 8) == 2
    assert blocks_needed(-3, 8) == 0


def test_block_pool_invariants():
    pool = BlockPool(8)                      # usable blocks: 1..7
    assert pool.available == 7
    a = pool.alloc(3)
    b = pool.alloc(2)
    assert 0 not in a + b                    # null block never handed out
    assert len(set(a) | set(b)) == 5         # no aliasing between grants
    assert pool.available + pool.in_use == 7
    pool.free(a)
    with pytest.raises(ValueError):
        pool.free(a)                         # double free detected
    with pytest.raises(ValueError):
        pool.free([0])                       # foreign/null block detected
    c = pool.alloc(4)
    assert set(c).isdisjoint(b)              # reuse never aliases live
    pool.free(b)
    pool.free(c)
    assert pool.available == 7               # nothing leaked


def test_block_pool_exhaustion_returns_none_never_partial():
    pool = BlockPool(4)
    assert pool.alloc(4) is None
    assert pool.available == 3
    got = pool.alloc(3)
    assert pool.alloc(1) is None
    pool.free(got)
    with pytest.raises(ValueError):
        BlockPool(1)


def test_shared_block_free_per_sharer_then_double_free_raises():
    idx = PrefixIndex(8)
    pool = BlockPool(8, index=idx)
    (b,) = pool.alloc(1)
    pool.share(b)
    assert pool.refcount(b) == 2
    pool.free([b])
    pool.free([b])
    assert pool.refcount(b) == 0
    with pytest.raises(ValueError):
        pool.free([b])
    with pytest.raises(ValueError):
        pool.share(99)


def test_indexed_block_parks_in_cache_and_revives():
    idx = PrefixIndex(8)
    pool = BlockPool(8, index=idx)
    (b,) = pool.alloc(1)
    key = idx.keys(np.arange(8))[0]
    assert idx.register(key, b)
    pool.free([b])
    assert pool.cached == 1 and pool.refcount(b) == 0
    assert idx.match([key]) == [b]
    pool.share(b)
    assert pool.cached == 0 and pool.refcount(b) == 1
    pool.free([b])
    assert pool.flush_cached() == 1
    assert len(idx) == 0 and pool.available == 7


def test_eviction_takes_only_refcount_zero_lru_oldest_first():
    idx = PrefixIndex(4)
    pool = BlockPool(8, index=idx)
    live = pool.alloc(3)
    parked = pool.alloc(4)
    keys = idx.keys(np.arange(16))
    for k, b in zip(keys, parked):
        idx.register(k, b)
    for b in parked:
        pool.free([b])
    assert pool.cached == 4 and pool.available == 4
    got = pool.alloc(2)
    assert set(got) == set(parked[:2])       # oldest parked first
    assert all(pool.refcount(b) == 1 for b in live)
    assert idx.match(keys) == []             # chain broken at its root
    assert pool.evictions == 2
    assert pool.alloc(10) is None
    with pytest.raises(ValueError):
        pool.free([parked[2]])


def test_prefix_index_chain_semantics():
    idx = PrefixIndex(4)
    a = np.array([1, 2, 3, 4, 5, 6, 7, 8])
    b = np.array([1, 2, 3, 4, 9, 9, 9, 9])
    ka, kb = idx.keys(a), idx.keys(b)
    assert len(ka) == 2 and ka[0] == kb[0] and ka[1] != kb[1]
    assert idx.keys(np.array([5, 6, 7, 8]))[0] != ka[1]
    assert idx.keys(np.array([1, 2, 3])) == []
    assert idx.register(ka[0], 3)
    assert not idx.register(ka[0], 4)        # first writer wins
    assert not idx.register(kb[1], 3)        # block already keyed
    assert idx.match(ka) == [3]
    idx.forget(3)
    assert idx.match(ka) == []


def _drive(pool_cls, index_cls, seed):
    """One random op sequence (alloc / share / free / register / match)
    on a fresh pool; returns every observable result in order."""
    rng = np.random.default_rng(seed)
    idx = index_cls(4)
    pool = pool_cls(24, index=idx)
    held, log = [], []
    prompts = [rng.integers(0, 50, size=int(rng.integers(4, 20)))
               for _ in range(6)]
    for step in range(120):
        op = rng.integers(0, 5)
        if op == 0:
            got = pool.alloc(int(rng.integers(0, 5)))
            log.append(("alloc", got))
            if got:
                held.append(got)
        elif op == 1 and held:
            blocks = held.pop(int(rng.integers(0, len(held))))
            pool.free(blocks)
            log.append(("free", blocks))
        elif op == 2 and held:
            blocks = held[int(rng.integers(0, len(held)))]
            keys = idx.keys(prompts[int(rng.integers(0, len(prompts)))])
            log.append(("register", [idx.register(k, b)
                                     for k, b in zip(keys, blocks)]))
        elif op == 3:
            keys = idx.keys(prompts[int(rng.integers(0, len(prompts)))])
            log.append(("keys", keys))
            hit = idx.match(keys)
            log.append(("match", hit))
            for b in hit:
                pool.share(b)
            if hit:
                held.append(hit)
        log.append(("state", pool.available, pool.in_use, pool.cached,
                    pool.evictions, len(idx)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_ops_same_blocks_and_keys_as_jax_package(seed):
    assert (_drive(BlockPool, PrefixIndex, seed)
            == _drive(JaxBlockPool, JaxPrefixIndex, seed))
