"""Autotuned dispatch for the port's kernels (port of ``repro.core.autotune``).

``core/tiling.py`` picks each call's kernel path and tile by a fixed
heuristic (``choose_gemm_path``, ``choose_conv_path``, the attention
wrapper's q tile and split).  The best choice depends on the shape, the
family and the card, and is cheapest to find by search, once per shape:

  1. *Enumerate* the candidates: exactly the compiled configurations the
     call can take (:func:`candidate_blocks`), the heuristic's pick always
     among them.  For the 16-bit families and F32GER at M <= 64, the
     weight stream at each column tile (64, 128) and split of K on a
     ladder (1, 2, 4, ..., 32, and the heuristic's split) plus the WMMA or
     fp32 tiles of ``tiling.GEMM_TILES``; at M > 64 with 16-byte pitches,
     the wgmma tiles (128, 128) and (128, 256) plus the WMMA tiles for
     the 16-bit families, F32GER's two fp32 tiles; the integer families
     their compiled tile, F64GER both DMMA tiles.  A tile the kernels
     were not built for is never a candidate, so the reference's "fails
     to lower" weeding has no counterpart, and a candidate that raises on
     the card raises (it is not skipped).
  2. *Rank* them by the H100 roofline prior
     (``roofline.analysis.gemm_projected_time``).
  3. *Score*: on the card (backend ``"cuda"``) the top :data:`TOP_K` and
     the heuristic are launched and timed with CUDA events, each launch
     after a 256 MB write that flushes the 50 MB L2 (source
     ``"measured"``).  On the CPU the wrappers run their plain versions,
     which ignore the path and the tile, so no launch can time or validate
     a candidate: the prior is the score (source ``"prior"``, where the
     reference's interpret-mode run gave ``"traced"``).
  4. *Persist* the winner in a JSON cache that every GEMM, conv and
     attention dispatch consults (``core.lowering.resolve_block``,
     :func:`lookup_attn`), so a tuned shape never pays the search again.

Cache file (the reference's schema, a file of its own)::

    {"version": 1,
     "entries": {"<ger>|<M>x<N>x<K>|<epilogue>|<backend>":
                 {"block": [bm, bn, bk], "path": "stream" | "wgmma" |
                  "wmma" | "imma" | "dmma", "split": s (stream only),
                  "source": "measured" | "prior", "score": <seconds>},
                 "<ger>|attn<H>x<Sq>x<Sk>x<D>|<epilogue>|<backend>":
                 {"block": [bq, 64], "split": n_split, ...}}}

Batched shapes key as ``b<B>x<M>x<N>x<K>``; ``<backend>`` is ``cuda`` or
``cpu`` (the operands' device).  Where the port departs from the reference
(each pinned in ``tests/test_torch_autotune.py``):

  * an entry names its kernel: ``path``, and the stream's ``split``
    (``block`` holds [rows, bn, 32] for the stream, [128, bn, 64] for the
    wgmma tile);
  * the 16-bit families and F32GER key M <= 64 by the weight stream's
    row bucket (``tiling.row_bucket``: 8, 16, 32, 64), not by M, so a
    row's sum runs in one order at batch 1 and at batch 4, as
    ``tiling.stream_plan`` keeps it;
  * attention keys by heads, not by batch x heads: a winner's split must
    not depend on the batch (the split-KV fault fixed in ROADMAP queue 3).
    Like the reference's, the key holds no mask and no KV-head count, so
    one winner serves every mask at a shape (only its speed may differ);
  * a winner changes a call's path, never a packed operand's panel
    (``core/packing.py``), so a tuned prepacked serve repacks nothing.

The default cache lives at ``$REPRO_TORCH_AUTOTUNE_CACHE``, else
``~/.cache/repro_torch/autotune.json`` (``$XDG_CACHE_HOME`` for
``~/.cache``), apart from the reference's.  A stray file there changes
dispatch; a missing, corrupt or unreadable one reads as empty (the
heuristic runs) and heals on the next save.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time

import numpy as np
import torch

from repro_torch.core import precision, tiling
from repro_torch.roofline import analysis as _roofline
from repro_torch.runtime import faults as _faults

Ger = precision.Ger

DEFAULT_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
DEFAULT_CACHE_PATH = pathlib.Path(
    os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
) / "repro_torch" / "autotune.json"
CACHE_VERSION = 1
TOP_K = 4
MEASURED, PRIOR = "measured", "prior"
# The weight stream's splits of K a search tries (the heuristic's too).
SPLIT_LADDER = (1, 2, 4, 8, 16, 32)
_STREAM_TILES = (64, 128)


def _backend(backend: str | None) -> str:
    if backend is not None:
        return backend
    return "cuda" if torch.cuda.is_available() else "cpu"


def tune_rows(kind: Ger, m: int) -> int:
    """The M a GEMM winner is keyed by: the weight stream's row bucket
    where the family may take the stream (bf16/f16 and F32GER at M <= 64),
    else M."""
    if kind in tiling.STREAM_GERS and m <= tiling.STREAM_MAX_M:
        return tiling.row_bucket(m)
    return m


def cache_key(kind: Ger, m: int, n: int, k: int,
              epilogue_key: str = "none", backend: str | None = None,
              b: int = 1) -> str:
    """Winner-store key, the reference's format: batched shapes (b > 1)
    as ``b<B>x<M>x<N>x<K>``; ``backend`` the operands' device type."""
    shape = f"b{b}x{m}x{n}x{k}" if b > 1 else f"{m}x{n}x{k}"
    return f"{kind.value}|{shape}|{epilogue_key}|{_backend(backend)}"


def block_of(winner: tuple) -> tuple[int, int, int]:
    """The (bm, bn, bk) a winner's kernel runs: the weight stream's
    (64-row bucket, bn, 32) stage, the wgmma tile's (128, bn, 64), a
    tile's own."""
    path, cfg = winner
    if path == "stream":
        return tiling.STREAM_MAX_M, cfg.bn, tiling.STREAM_BK
    if path == "wgmma":
        return cfg.bm, cfg.bn, _roofline.WG_BK
    return cfg.bm, cfg.bn, cfg.bk   # IMMA's forms carry their own


def _entry_of(winner: tuple) -> tuple[list[int], dict]:
    """(block, extra fields) of a winner's cache entry."""
    path, cfg = winner
    fields = {"path": path}
    if path == "imma":
        fields["form"] = tiling.imma_form(cfg)
    if path == "stream" or isinstance(cfg, tiling.ImmaStreamConfig):
        fields["split"] = cfg.split
    return list(block_of(winner)), fields


def _winner_of(ent: dict | None) -> tuple | None:
    """The (path, config) an entry names, or None (absent, malformed, an
    attention winner, or a reference-format entry with no path)."""
    if not isinstance(ent, dict):
        return None
    path, blk = ent.get("path"), ent.get("block")
    if not isinstance(blk, list) or len(blk) != 3 \
            or not all(isinstance(v, int) for v in blk):
        return None
    if path == "stream":
        split = ent.get("split")
        return (("stream", tiling.StreamConfig(blk[1], split))
                if isinstance(split, int) else None)
    if path == "wgmma":
        return "wgmma", tiling.WgmmaConfig(blk[0], blk[1])
    if path == "imma" and ent.get("form") == "tile":
        return "imma", tiling.ImmaTileConfig(blk[1], blk[0], blk[2])
    if path == "imma" and ent.get("form") == "stream":
        split = ent.get("split")
        return (("imma", tiling.ImmaStreamConfig(blk[1], split, blk[0],
                                                 blk[2]))
                if isinstance(split, int) else None)
    if path in ("wmma", "imma", "dmma"):
        return path, tiling.BlockConfig(*blk)
    return None


class AutotuneCache:
    """JSON-backed winner store, loaded lazily, written atomically."""

    # Transient-IO retry policy for cache loads: a one-off OSError on a
    # contended filesystem is retried with exponential backoff before the
    # store degrades to empty; the fault point is consulted per attempt.
    LOAD_RETRIES = 3
    LOAD_BACKOFF_S = 0.001

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = pathlib.Path(path) if path is not None \
            else DEFAULT_CACHE_PATH
        self._entries: dict[str, dict] | None = None
        self._winners: dict[str, tuple | None] = {}
        self._lock = threading.Lock()

    def _load(self) -> dict[str, dict]:
        """Lazy read.  A missing file, garbage JSON (ValueError) or a
        persistent OSError degrades to an empty store -- dispatch takes
        the heuristic -- and heals on the next :meth:`put_raw`.  A
        transient OSError is retried up to ``LOAD_RETRIES`` attempts with
        ``LOAD_BACKOFF_S * 2**attempt`` backoff; nothing broader is
        swallowed."""
        if self._entries is None:
            for attempt in range(self.LOAD_RETRIES):
                try:
                    fault = _faults.fire(_faults.AUTOTUNE_LOAD)
                    if fault is not None and fault.kind == _faults.RAISE:
                        raise OSError("injected autotune.load failure")
                    blob = json.loads(self.path.read_text())
                    if not isinstance(blob, dict):
                        raise ValueError(
                            f"cache blob is {type(blob).__name__}")
                    if blob.get("version") == CACHE_VERSION:
                        entries = blob.get("entries", {})
                        if not isinstance(entries, dict):
                            raise ValueError(
                                "cache entries is not a mapping")
                        self._entries = dict(entries)
                    else:
                        self._entries = {}
                except (FileNotFoundError, ValueError):
                    self._entries = {}
                except OSError:
                    if attempt + 1 < self.LOAD_RETRIES:
                        time.sleep(self.LOAD_BACKOFF_S * (2 ** attempt))
                        continue
                    self._entries = {}
                break
        return self._entries

    def get(self, key: str) -> tuple | None:
        """The GEMM winner (path, config) stored under ``key``, or None."""
        return _winner_of(self._load().get(key))

    def put(self, key: str, winner: tuple, *, source: str,
            score: float) -> None:
        block, fields = _entry_of(winner)
        self.put_raw(key, block, source=source, score=score, **fields)

    def get_raw(self, key: str) -> dict | None:
        return self._load().get(key)

    def put_raw(self, key: str, block: list[int], *, source: str,
                score: float, **fields) -> None:
        """Record a winner and persist the store atomically: the whole
        blob to a same-directory, pid-unique temp file, then
        ``os.replace``, so a reader (or a crash, the ``autotune.save``
        torn-write fault) never sees a half-written cache; a corrupt file
        on disk is healed by the first save after it.  A failed save
        (read-only filesystem, an injected failure) keeps the winner in
        memory and leaves no temp file."""
        with self._lock:
            entries = self._load()
            entries[key] = {"block": list(block), **fields,
                            "source": source, "score": score}
            self._winners.clear()
            tmp = self.path.with_name(
                f"{self.path.name}.{os.getpid()}.tmp")
            try:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                tmp.write_text(json.dumps(
                    {"version": CACHE_VERSION, "entries": entries},
                    indent=1, sort_keys=True))
                fault = _faults.fire(_faults.AUTOTUNE_SAVE)
                if fault is not None and fault.kind == _faults.TORN:
                    _faults.tear(tmp)      # crash mid-write: never publish
                    tmp.unlink(missing_ok=True)
                    return
                if fault is not None and fault.kind == _faults.RAISE:
                    raise OSError("injected autotune.save failure")
                os.replace(tmp, self.path)
            except OSError:
                tmp.unlink(missing_ok=True)

    def winner(self, key: str, m: int, n: int, k: int, kind: Ger,
               b: int) -> tuple | None:
        """:meth:`get`, memoized per key and held to what the shape can
        take (``tiling.takes`` with 16-byte pitches): the dispatch-time
        consult.  A stale entry -- a tile the kernels are not built for,
        a split past K's stages -- reads as a miss."""
        try:
            return self._winners[key]
        except KeyError:
            pass
        entries = self._load()
        got = _winner_of(entries.get(key)) if entries else None
        if got is not None and not tiling.takes(got, m, n, k, kind):
            got = None
        self._winners[key] = got
        return got

    def __len__(self) -> int:
        return len(self._load())


_DEFAULT_CACHE: AutotuneCache | None = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> AutotuneCache:
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        with _DEFAULT_LOCK:
            if _DEFAULT_CACHE is None:
                _DEFAULT_CACHE = AutotuneCache(
                    os.environ.get(DEFAULT_CACHE_ENV) or None)
    return _DEFAULT_CACHE


def lookup(kind: Ger, m: int, n: int, k: int, epilogue_key: str = "none",
           backend: str | None = None, cache: AutotuneCache | None = None,
           b: int = 1) -> tuple | None:
    """Cache-only consult (what dispatch does): the winner (path, config)
    for this shape, or None on a miss or a stale entry (the heuristic
    runs).  Never searches."""
    cache = cache if cache is not None else default_cache()
    key = cache_key(kind, tune_rows(kind, m), n, k, epilogue_key, backend,
                    b)
    return cache.winner(key, m, n, k, kind, b)


# ----------------------------------------------------------------------
# Candidates and the prior
# ----------------------------------------------------------------------

def candidate_blocks(m: int, n: int, k: int, kind: Ger, b: int = 1,
                     aligned: bool = True) -> list[tuple]:
    """The (path, config) pairs a product at (b, m, n, k) can run on:
    every compiled configuration of the paths the call can take (module
    docstring), the heuristic's pick among them (so the tuned winner is
    never ranked below it under the shared prior).  ``aligned``: both
    operands have 16-byte bases and pitches (the wgmma tile's rule).  The
    integer families' candidates are the IMMA kernel's compiled
    configurations (``tiling.imma_configs``): each wgmma tile width, the
    weight stream's plan and the mma.sync kernel's tile."""
    heur = tiling.choose_gemm_path(m, n, k, kind, b, aligned)
    if kind in tiling.IMMA_GERS:
        out = [("imma", c) for c in tiling.imma_configs(m, n, k, kind, b,
                                                        aligned)]
        return out if heur in out else out + [heur]
    out: list[tuple] = []
    if kind in tiling.STREAM_GERS and k >= tiling.MIN_K:
        if m <= tiling.STREAM_MAX_M:
            stages = -(-k // tiling.STREAM_BK)
            out += [("stream", tiling.StreamConfig(bn, s))
                    for bn in _STREAM_TILES for s in SPLIT_LADDER
                    if s <= stages]
        elif aligned and kind in tiling.WGMMA_GERS:
            out += [("wgmma", cfg) for cfg in tiling.WGMMA_TILES]
    path = "dmma" if heur[0] == "dmma" else "wmma"
    out += [(path, cfg) for cfg in tiling.tiles_for(kind)]
    if heur not in out:
        out.append(heur)
    return out


def predicted_time(m: int, n: int, k: int, cand: tuple, kind: Ger,
                   b: int = 1) -> float:
    """The ranking prior: the H100 roofline seconds of ``cand``'s path."""
    return _roofline.gemm_projected_time(m, n, k, cand[1],
                                         precision.policy(kind), b=b)


# ----------------------------------------------------------------------
# Measurement on the card
# ----------------------------------------------------------------------

def _timer(iters: int):
    """A function timing a callable on the card: the median of ``iters``
    launches, each between two CUDA events after a 256 MB write (the L2
    flushed) and a ~300 us spin that lets the host's enqueue run ahead,
    so the time is the device's."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    hold = int(300e-6 * 1.98e9)         # cycles at the boost clock

    def timed(fn) -> float:
        fn()                            # builds and warms
        pairs = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(hold)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        ms = sorted(a.elapsed_time(c) for a, c in pairs)
        return ms[len(ms) // 2] * 1e-3
    return timed


def _operands(m: int, n: int, k: int, kind: Ger, b: int = 1):
    """Seeded operands on the card in the family's input dtypes."""
    pol = precision.policy(kind)
    rng = np.random.default_rng(0)
    lead = (b,) if b > 1 else ()
    if pol.packed_int4:
        x = rng.integers(-128, 128, lead + (m, k // 2))
        y = rng.integers(-128, 128, lead + (k // 2, n))
    elif pol.is_integer:
        lo, hi = (0, 256) if pol.y_dtype == torch.uint8 else (-100, 100)
        x = rng.integers(-100, 100, lead + (m, k))
        y = rng.integers(lo, hi, lead + (k, n))
    else:
        x = rng.standard_normal(lead + (m, k)) * k ** -0.5
        y = rng.standard_normal(lead + (k, n))
    return (torch.from_numpy(x).to("cuda", pol.x_dtype),
            torch.from_numpy(y).to("cuda", pol.y_dtype))


def _measure_gemm(m, n, k, kind, cands, b, iters=5) -> dict:
    """{candidate: device seconds} of one launch each, on the card."""
    from repro_torch.kernels import mma_gemm as _gemm
    x, y = _operands(m, n, k, kind, b)
    timed = _timer(iters)
    out = {}
    for cand in cands:
        before = _gemm.mma_gemm.tuned_fallbacks
        out[cand] = timed(lambda c=cand: _gemm.mma_gemm(x, y, kind=kind,
                                                        tuned=c))
        if _gemm.mma_gemm.tuned_fallbacks != before:
            raise ValueError(f"candidate {cand} fell back to the "
                             f"heuristic at {(b, m, n, k)}: it is not "
                             f"one the call can take")
    return out


def autotune(kind: Ger, m: int, n: int, k: int, *, b: int = 1,
             epilogue_key: str = "none", backend: str | None = None,
             cache: AutotuneCache | None = None, top_k: int = TOP_K,
             force: bool = False, scores: dict | None = None) -> tuple:
    """Find (or recall) the winner (path, config) for one GEMM shape.

    Returns the cached winner where there is one (unless ``force``).
    Otherwise ranks :func:`candidate_blocks` by the prior; on the card it
    times the top ``top_k`` and the heuristic and keeps the fastest
    (``"measured"``), on the CPU the prior's first is the winner
    (``"prior"``).  ``scores``, where given, receives {candidate:
    seconds} of what was scored.  The winner is stored under the key
    :func:`lookup` reads."""
    backend = _backend(backend)
    cache = cache if cache is not None else default_cache()
    key = cache_key(kind, tune_rows(kind, m), n, k, epilogue_key, backend,
                    b)
    if not force:
        hit = cache.winner(key, m, n, k, kind, b)
        if hit is not None:
            return hit
    cands = candidate_blocks(m, n, k, kind, b)
    prior = {c: predicted_time(m, n, k, c, kind, b) for c in cands}
    ranked = sorted(cands, key=prior.get)
    if backend == "cuda":
        heur = tiling.choose_gemm_path(m, n, k, kind, b)
        timed = ranked[:top_k] + ([heur] if heur not in ranked[:top_k]
                                  else [])
        got = _measure_gemm(m, n, k, kind, timed, b)
        source = MEASURED
    else:
        got = {ranked[0]: prior[ranked[0]]}
        source = PRIOR
    best = min(got, key=got.get)
    if scores is not None:
        scores.update(got)
    cache.put(key, best, source=source, score=float(got[best]))
    return best


# ----------------------------------------------------------------------
# Attention: the q tile and, for short queries, the split of KV
# ----------------------------------------------------------------------
# A winner is (bq, n_split): the q tile (BLOCK_Q 128 or BLOCK_Q_SHORT 64)
# and the blocks KV is split over (1: the tile mode).  Stored as
# {"block": [bq, 64], "split": n_split}, keyed by heads, not by batch.

def attn_cache_key(kind: Ger, h: int, sq: int, sk: int, d: int,
                   epilogue_key: str = "none",
                   backend: str | None = None) -> str:
    return (f"{kind.value}|attn{h}x{sq}x{sk}x{d}|{epilogue_key}|"
            f"{_backend(backend)}")


def lookup_attn(kind: Ger, h: int, sq: int, sk: int, d: int,
                epilogue_key: str = "none", backend: str | None = None,
                cache: AutotuneCache | None = None
                ) -> tuple[int, int] | None:
    """Cache-only consult (what the attention lowering does): the winner
    (bq, n_split), or None on a miss or an entry the kernel cannot run at
    this shape (``mma_attention.attn_takes``)."""
    from repro_torch.kernels import mma_attention as _attn
    cache = cache if cache is not None else default_cache()
    ent = cache.get_raw(attn_cache_key(kind, h, sq, sk, d, epilogue_key,
                                       backend))
    if not isinstance(ent, dict):
        return None
    blk, split = ent.get("block"), ent.get("split")
    if not isinstance(blk, list) or len(blk) != 2 \
            or not isinstance(split, int) or not isinstance(blk[0], int):
        return None
    if not _attn.attn_takes((blk[0], split), sq, sk, d,
                            kind == Ger.F32GER):
        return None
    return blk[0], split


def attn_candidate_blocks(h: int, sq: int, sk: int, d: int, kind: Ger
                          ) -> list[tuple[int, int]]:
    """Every (bq, n_split) the kernel runs at this shape: the q tiles it
    is compiled for and, for queries of at most 64 rows, KV splits on
    :data:`SPLIT_LADDER` up to the KV blocks (and the heuristic's)."""
    from repro_torch.kernels import mma_attention as _attn
    f32 = kind == Ger.F32GER
    nk = -(-sk // _attn.BLOCK_K)
    splits = {1}
    if sq <= _attn.BLOCK_Q_SHORT:
        splits |= {s for s in SPLIT_LADDER if s <= nk}
        splits.add(_attn.split_kv_plan(h, sq, sk)[0])
    # a split runs as the one its per-split block count gives
    splits = {-(-max(nk, 1) // -(-max(nk, 1) // s)) for s in splits}
    return [(bq, s) for s in sorted(splits)
            for bq in (_attn.BLOCK_Q, _attn.BLOCK_Q_SHORT)
            if _attn.attn_takes((bq, s), sq, sk, d, f32)]


def autotune_attn(kind: Ger, h: int, sq: int, sk: int, d: int, *,
                  b: int = 1, kvh: int | None = None, causal: bool = True,
                  q_offset: int = 0, window: int | None = None,
                  epilogue_key: str = "none", backend: str | None = None,
                  cache: AutotuneCache | None = None, top_k: int = TOP_K,
                  force: bool = False, scores: dict | None = None
                  ) -> tuple[int, int]:
    """Find (or recall) the winner (bq, n_split) for one attention shape:
    the candidates ranked by the roofline prior
    (``roofline.analysis.attn_projected_time`` with the split's merge
    traffic); on the card the top ``top_k`` and the heuristic timed at
    batch ``b`` with ``kvh`` KV heads (default ``h``) and the call's
    causal/window/q_offset, on the CPU the prior's first.  No epilogue
    operands are launched: the key's epilogue names the deprime the
    winner serves, which the search leaves out of the timing."""
    from repro_torch.kernels import mma_attention as _attn
    backend = _backend(backend)
    cache = cache if cache is not None else default_cache()
    key = attn_cache_key(kind, h, sq, sk, d, epilogue_key, backend)
    if not force:
        hit = lookup_attn(kind, h, sq, sk, d, epilogue_key, backend, cache)
        if hit is not None:
            return hit
    pol = precision.policy(kind)
    cands = attn_candidate_blocks(h, sq, sk, d, kind)
    prior = {c: _roofline.attn_projected_time(
        b * h, sq, sk, d, c[0], _attn.BLOCK_K, pol, causal=causal,
        q_offset=q_offset, window=window, n_split=c[1]) for c in cands}
    ranked = sorted(cands, key=prior.get)
    if backend == "cuda":
        heur = _attn.attn_plan(b, h, sq, sk, d, kind == Ger.F32GER)[:2]
        timed = ranked[:top_k] + ([heur] if heur not in ranked[:top_k]
                                  else [])
        rng = np.random.default_rng(0)
        q, k = (torch.from_numpy(rng.standard_normal((b, s, nh, d))).to(
            "cuda", pol.x_dtype) for s, nh in ((sq, h), (sk, kvh or h)))
        tick = _timer(5)
        got = {}
        for cand in timed:
            before = _attn.mma_flash_attention.tuned_fallbacks
            got[cand] = tick(lambda c=cand: _attn.mma_flash_attention(
                q, k, k, causal=causal, q_offset=q_offset, window=window,
                tuned=c))
            if _attn.mma_flash_attention.tuned_fallbacks != before:
                raise ValueError(f"attention candidate {cand} fell back "
                                 f"to the heuristic")
        source = MEASURED
    else:
        got = {ranked[0]: prior[ranked[0]]}
        source = PRIOR
    best = min(got, key=got.get)
    if scores is not None:
        scores.update(got)
    cache.put_raw(key, [best[0], _attn.BLOCK_K], source=source,
                  score=float(got[best]), split=best[1])
    return best
