"""Cross-call cache of the port's captured programs (the counterpart of
bayes_drt_tpu/progcache.py).

The JAX package caches jitted programs so that a second call with the
same structure skips Python tracing. The port's counterpart of a program
is a set of CUDA graphs, and capturing them is what a fit pays before
its first draw: seconds for an `Inverter` NUTS md10 fit (7.46 s of one
fit's first draw, NVIDIA H100 80GB HBM3, 700 W, `chip_smoke.py`). A
graph reads fixed addresses, so what is cached is a *runner*: static
buffers for everything its graphs read (``Bound``), the function built
over those buffers, and the graphs captured against them. A call copies
its values into the buffers and replays; a hit gives, bit for bit, the
results of a miss on the same data and seed.

Callers key an entry on everything that shapes a capture: the model
configuration, ``data_shapes`` of the data, dtype, device and row count,
the solver settings a graph bakes in as constants (tree depth, leapfrog
count, L-BFGS history and cap, a tolerance), the metric's form and the
density function. Budgets that only set how many times a graph replays
(warmup, samples) stay out of the key.

Eviction is in insertion order, as in the JAX package, but a graph pool
holds device memory where a jitted function holds none, so the cap is
smaller (``MAX_ENTRIES``, not 128) and the pools' bytes are capped too
(``MAX_POOL_BYTES``). On an NVIDIA H100 80GB HBM3 at 700 W
(`chip_smoke.py`) the largest pool is the default NUTS md10 tree at
4,096 rows of D=211 in float32, 0.73 GB, and the whole smoke leaves 30
entries holding 2.74 GB of pools: 8 GiB, about three times that and a
tenth of the card, keeps a dozen such trees and evicts well before the
fits' own tensors run short; 64 entries bound the runners' host-side
buffers. Evicting an entry drops its graphs and returns their pools to
the card. On the CPU the runners hold buffers and no graphs.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_ENTRIES = 64
MAX_POOL_BYTES = 8 << 30

_CACHE: dict = {}
_COUNTS = {"hits": 0, "misses": 0, "evictions": 0}


def cached_program(key, builder):
    """The entry under ``key``, built by ``builder()`` on a miss. Before a
    new entry goes in, the oldest are evicted while the cache holds
    ``MAX_ENTRIES`` entries or its graph pools more than
    ``MAX_POOL_BYTES``."""
    entry = _CACHE.get(key)
    if entry is not None:
        _COUNTS["hits"] += 1
        return entry
    _COUNTS["misses"] += 1
    while _CACHE and (len(_CACHE) >= MAX_ENTRIES
                      or pool_bytes() > MAX_POOL_BYTES):
        _evict(next(iter(_CACHE)))
    entry = builder()
    _CACHE[key] = entry
    return entry


def _evict(key):
    entry = _CACHE.pop(key)
    _COUNTS["evictions"] += 1
    release = getattr(entry, "release", None)
    if release is not None:
        release()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def clear():
    """Drop every entry (their graph pools go back to the card) and zero
    the counters."""
    while _CACHE:
        _evict(next(iter(_CACHE)))
    for k in _COUNTS:
        _COUNTS[k] = 0


def _entry_pools(entry):
    pools = getattr(entry, "pools", None)
    return pools() if pools is not None else []


def pool_bytes(entries=None) -> int:
    """Device bytes of the segments owned by the graph pools of
    ``entries`` (default: every entry), from the allocator's snapshot."""
    entries = list(_CACHE.values()) if entries is None else entries
    ids = {tuple(p) for e in entries for p in _entry_pools(e)}
    if not ids or not torch.cuda.is_initialized():
        return 0
    total = 0
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is not None and tuple(pid) in ids:
            total += int(seg["total_size"])
    return total


def stats() -> dict:
    """entries, hits, misses, evictions and the bytes the entries' graph
    pools hold on the device."""
    return dict(entries=len(_CACHE), **_COUNTS, pool_bytes=pool_bytes())


def _leaves(tree):
    """The leaves of a tree of tuples (NamedTuples too), lists and dicts
    (by sorted key), in the JAX package's order; None has none."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def data_shapes(tree):
    """Shape and dtype signature of a tree of tensors, numpy arrays and
    Python scalars, for cache keys (a tensor's dtype by its numpy name, so
    that the signature equals the JAX package's for the same arrays)."""
    out = []
    for a in _leaves(tree):
        if isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), str(a.dtype).removeprefix("torch.")))
        else:
            out.append((np.shape(a), str(np.result_type(a))))
    return tuple(out)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    return fn(tree)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape:
            raise ValueError(f"buffer {tuple(dst.shape)} cannot take "
                             f"{tuple(src.shape)}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class Bound:
    """A runner's static buffers and the function built over them.

    ``inputs`` is a tree of tensors (tuples, NamedTuples, lists, dicts;
    any other leaf is static and belongs in the key). The buffers are
    clones of it, ``fn = make(buffers)``, and ``bind(inputs)`` copies a
    call's values in, so every graph captured over ``fn`` reads them.
    ``graphs`` holds the captured pieces (each with a ``pool_id`` where it
    owns a graph pool), by a sub-key of what shapes them."""

    def __init__(self, inputs, make):
        self.buffers = _map(lambda t: t.clone()
                            if isinstance(t, torch.Tensor) else t, inputs)
        self.fn = make(self.buffers)
        self.graphs = {}

    def bind(self, inputs):
        _copy_into(self.buffers, inputs)
        return self.fn

    def pools(self):
        ids = []
        for g in self.graphs.values():
            pid = getattr(g, "pool_id", None)
            if pid is not None and pid not in ids:
                ids.append(pid)
        return ids

    def release(self):
        self.graphs.clear()


def bound(key, inputs, make):
    """The cached ``Bound`` under ``key`` (built over ``inputs`` on a
    miss), with ``inputs`` copied into its buffers."""
    entry = cached_program(key, lambda: Bound(inputs, make))
    entry.bind(inputs)
    return entry
