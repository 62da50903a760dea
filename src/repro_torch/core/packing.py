"""The packed-constant store and the block a GEMM dispatch would run (a
partial port of ``repro.core.packing``).

Ported here: :class:`PackedStore` and its process-global :data:`STORE`,
with the ``COUNTERS`` it records into, which ``kernels.blas3``
keys its DFT twiddles in; and :func:`plan_gemm_block`, the freshness key of
such a constant.  ``PackedOperand``, the layout registry, the refresh and
demotion logic and ``prepack_params_for_serving`` (kernel-native prepacked
weights, K1d) come with ROADMAP slice C4.
"""

from __future__ import annotations

import collections
import dataclasses

from repro_torch.core import precision, tiling

Ger = precision.Ger

# The store's events ("store_build", "store_hit").
COUNTERS: collections.Counter = collections.Counter()


def plan_gemm_block(kind: Ger, m: int, n: int, k: int, *,
                    b: int = 1) -> tuple:
    """The configuration a kernel-backend GEMM at (b, m, n, k) would run,
    as ``(path, *config)`` from ``tiling.choose_gemm_path`` (there is no
    autotune yet, ROADMAP slice C5).  ``m`` is the caller's hint for the
    rows the operand will meet.  Operands are taken as contiguous with
    16-byte pitches where K and N allow it.  An expansion hook
    (F32GER_3XBF16) plans as the family it runs on."""
    if kind == Ger.F32GER_3XBF16:
        kind = Ger.BF16GER2
    pitch = precision.policy(kind).in_bytes
    aligned = (k * pitch) % 16 == 0 and (n * pitch) % 16 == 0
    path, cfg = tiling.choose_gemm_path(m, n, k, kind, b, aligned)
    return (path, *dataclasses.astuple(cfg))


class PackedStore:
    """Process-global store for packed constant operands, keyed by the
    caller's (name, shape, dtype, block-config) tuple -- the facility-wide
    replacement for per-module private caches.  ``invalidate`` drops
    entries when a key's configuration changes, so the constant is
    re-derived, never read stale."""

    def __init__(self):
        self._entries: dict[tuple, object] = {}

    def get_or_build(self, key: tuple, make):
        hit = self._entries.get(key)
        if hit is None:
            COUNTERS["store_build"] += 1
            hit = make()
            self._entries[key] = hit
        else:
            COUNTERS["store_hit"] += 1
        return hit

    def invalidate(self, key: tuple | None = None) -> int:
        """Drop one entry (or every entry whose key starts with ``key``);
        ``None`` clears the store.  Returns the number dropped."""
        if key is None:
            n = len(self._entries)
            self._entries.clear()
            return n
        drop = [k for k in self._entries
                if k == key or k[:len(key)] == key]
        for k in drop:
            del self._entries[k]
        return len(drop)

    def keys(self):
        return list(self._entries)


STORE = PackedStore()
