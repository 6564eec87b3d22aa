"""Packed-panel cache: content-hash -> GenoMatrix, small LRU.

The reference keeps its direct-PLINK kernel precisely to avoid paying the
conversion cost on every call (src/miraculix/plink256.cc:54-61); our
equivalent is to cache the (expensive) pack by content hash so repeated
R-API / ``dgemm_plink`` / ``sparse_times_plink`` calls on the same buffer
hit the device-resident panel.  The keys that the facades build name the
resolved device, so a panel is served only to calls for the device it
lives on.  blake2b hashes ~1 GB/s on one core, two orders of magnitude
cheaper than decode+pack+transfer.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Callable, Tuple

_MAX_ENTRIES = 4
_cache: "OrderedDict[Tuple, Any]" = OrderedDict()

# instrumentation for tests / the benchmark suite
hits = 0
misses = 0


def digest_array(arr) -> bytes:
    """Content hash of a numpy array's raw bytes (C-order view)."""
    import numpy as np

    a = np.ascontiguousarray(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update(a.view(np.uint8).reshape(-1).data)
    return h.digest()


def get_or_build(key: Tuple, builder: Callable[[], Any]) -> Any:
    """Return the cached value for ``key`` or build, cache, and return it."""
    global hits, misses
    if key in _cache:
        _cache.move_to_end(key)
        hits += 1
        return _cache[key]
    misses += 1
    val = builder()
    _cache[key] = val
    while len(_cache) > _MAX_ENTRIES:
        _cache.popitem(last=False)
    return val


def evict_value(value: Any) -> None:
    """Drop every entry holding ``value`` (panels freed via the C-API's
    ``free_compressed`` must not be served from cache afterwards)."""
    for k in [k for k, v in _cache.items() if v is value]:
        del _cache[k]


def clear() -> None:
    global hits, misses
    _cache.clear()
    hits = misses = 0
