"""Synthetic batches (port of ``repro.data.pipeline``: ``synthetic_batch``
and the host-to-device step).

``synthetic_batch`` is a pure function of (cfg, shape, step, seed) that
gives the reference's values bit for bit: the same numpy generator, seeded
the same way, drawn in the same order.  Beside the tokens it makes each
family's model inputs: mel ``frames`` and the fixed-length decoder
``tokens``/``labels`` for the encoder-decoder (audio) kind, raw ``images``
(or precomputed ``vision_embeds`` for stub configs) and the M-RoPE
``positions`` for the vision-language kind.  ``Prefetcher`` makes the
batches of consecutive steps on a background thread and puts each on the
model's device as it is taken.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def synthetic_batch(cfg, *, batch: int, seq: int, step: int,
                    seed: int = 0) -> dict:
    """Pure function (cfg, shape, step) -> host batch dict of numpy
    arrays."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    # Zipf-ish distribution over the vocab, clipped.
    toks = rng.zipf(1.3, size=(batch, seq + 1)) % cfg.vocab_size
    toks = toks.astype(np.int32)
    out = {"tokens": toks[:, :seq], "labels": toks[:, 1:seq + 1]}
    if cfg.is_enc_dec:
        frame_dim = cfg.d_model if cfg.frontend_stub else cfg.n_mels
        out["frames"] = rng.normal(
            size=(batch, seq, frame_dim)).astype(np.float32)
        dl = cfg.decoder_len
        dtoks = rng.integers(0, cfg.vocab_size, (batch, dl + 1),
                             dtype=np.int64).astype(np.int32)
        out["tokens"], out["labels"] = dtoks[:, :dl], dtoks[:, 1:]
    if cfg.vision_prefix:
        if cfg.frontend_stub or not cfg.patch_size:
            out["vision_embeds"] = rng.normal(
                size=(batch, cfg.vision_prefix,
                      cfg.d_model)).astype(np.float32)
        else:  # real frontend: raw images into the patch-embed conv stem
            gh, gw = cfg.vision_grid()
            ps = cfg.patch_size
            out["images"] = rng.normal(
                size=(batch, gh * ps, gw * ps,
                      cfg.image_channels)).astype(np.float32)
        pos = np.broadcast_to(np.arange(seq)[None, None], (3, batch, seq))
        out["positions"] = pos.astype(np.int32)
    return out


def device_batch(host_batch: dict, device) -> dict:
    """Put a host batch on ``device`` (one copy per array, dtypes kept)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host_batch.items()}


class Prefetcher:
    """Background-thread prefetch of step-addressable batches: iterating
    yields ``(step, device batch)`` for ``start_step``, ``start_step + 1``,
    ... with ``depth`` host batches made ahead.  An error in the worker is
    raised by the ``next()`` that reaches it; ``close()`` stops and joins
    the worker."""

    def __init__(self, cfg, *, batch: int, seq: int, device,
                 start_step: int = 0, seed: int = 0, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._device = device
        self._err: BaseException | None = None

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            step = start_step
            try:
                while put((step, synthetic_batch(cfg, batch=batch, seq=seq,
                                                 step=step, seed=seed))):
                    step += 1
            except BaseException as e:  # repro: allow(overbroad-except)
                # the producer thread: the consumer's next() re-raises it
                put((None, e))

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._err is not None:
            raise self._err
        step, b = self._q.get()
        if step is None:
            self._err = b
            raise b
        return step, device_batch(b, self._device)

    def close(self):
        self._stop.set()
        self._t.join()
