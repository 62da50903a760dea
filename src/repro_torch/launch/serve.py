"""Batched serving loop on a paged KV pool (port of ``repro.launch.serve``,
base loop).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --batch 4 --prompt-len 256 --gen 32 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --batch 4 --prompt-len 256 --gen 32

Runs on the card (``--device cuda``, the default; it raises where CUDA is
absent) with random bf16 weights drawn from ``--seed``.  Continuous
batching at step granularity:

  * **Paged-KV admission control**: a request reserves its worst-case
    footprint (``ceil((prompt + gen) / page_size)`` pages) at admission;
    when the pool cannot cover it the request queues, and requests whose
    footprint exceeds the whole pool are rejected up front.  Pages are
    reclaimed exactly once, and every run ends with ``assert_quiescent()``.
  * **Prefill**: admission runs the prompt through a batch=1 prefill; the
    first generated token is the argmax of its logits.  For ssm-kind archs
    (per-slot ``ssm``/``conv`` state) the prefill state is scattered into
    the admitted slot of the batched decode cache, exactly.  Dense and
    hybrid ring caches share ``pos``/``cur`` across slots, so (as in the
    reference) their scatter is skipped: the prefill's logits seed the
    slot and decode continues from the shared cache.
  * **Decode**: one greedy batched ``decode_step`` per tick over all slots.
  * ``--prepack``: after the model is built, its weights are packed once,
    in place, into the panels the kernels read
    (``core.packing.prepack_params_for_serving``, ``min_size=1024``; the
    stats are printed); every projection, MoE bank and conv stem then
    streams its panels with no per-call relayout, and the tokens are the
    natural run's.  The SSM archs' 2-D conv taps are packed too and
    demoted at every depthwise call, as in the reference (ROADMAP queue
    3): serve them unpacked.

Deadlines, preemption, fault injection, ``--abft`` and ``--fault-matrix``
come with later slices (ROADMAP slices D1, D2).
Accounting: ``tokens_per_s`` counts live-slot decode tokens only; prefill
tokens are reported separately.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs import get as get_arch
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.core import facility, packing
from repro_torch.models import model as M
from repro_torch.runtime.kv_pages import PagePool, PagesExhausted
from repro_torch.train import steps as S


@dataclasses.dataclass
class Request:
    """One serving request and its lifecycle bookkeeping."""

    rid: int
    prompt: np.ndarray          # (1, prompt_len) int32
    gen_len: int
    submit_step: int = 0
    generated: int = 0
    done_step: int = -1

    @property
    def tokens_needed(self) -> int:
        return self.prompt.shape[1] + self.gen_len


class ServeError(RuntimeError):
    """The serving loop violated its own exactly-once contract."""


def _make_requests(cfg, n_requests, prompt_len, gen_len, seed):
    """The same prompts and generation lengths as the reference's."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        prompt = rng.integers(0, cfg.vocab_size, (1, max(1, prompt_len)),
                              dtype=np.int32)
        g = int(rng.integers(max(1, gen_len // 2), gen_len + 1))
        reqs.append(Request(rid=i, prompt=prompt, gen_len=g))
    return reqs


def _scatter_prefill(cache, pre, slot):
    """Copy a batch=1 prefill cache into ``slot`` of the batched decode
    cache, in place.  Exact for ssm-kind archs (fully per-slot state);
    other kinds keep their cold cache (a shared ring ``pos``/``cur`` makes
    a per-slot scatter unsound, as in the reference)."""
    if "ssm" in pre and "ssm" in cache and "k" not in cache:
        cache["ssm"][:, slot] = pre["ssm"][:, 0]
        cache["conv"][:, slot] = pre["conv"][:, 0].to(cache["conv"].dtype)
    return cache


@torch.inference_mode()
def serve_loop(cfg, model, *, batch: int, prompt_len: int, gen_len: int,
               n_requests: int, seed: int = 0, page_size: int = 16,
               total_pages: int | None = None,
               max_steps: int | None = None) -> dict:
    """Serve ``n_requests`` synthetic prompts through a ``batch``-slot
    continuous-batching decode loop, on the device that holds ``model``.
    Returns a stats dict.  Every request ends either ``completed`` or
    ``rejected``; a duplicate raises :class:`ServeError` and the page
    ledger is proven quiescent before returning.

    The loop admits token-only prompts, as the reference's does: an
    encoder-decoder config (whisper, whose prefill needs ``frames``) or a
    vision-prefix config (qwen2-vl, whose prefill needs ``images`` and
    M-RoPE ``positions``) raises ``ValueError`` up front; drive those with
    ``models.model.prefill`` and ``decode_step``.

    It runs under ``torch.inference_mode()``: a trained model, whose
    parameters require gradients, is served without building an autograd
    graph."""
    if cfg.is_enc_dec or cfg.vision_prefix:
        raise ValueError(
            f"{cfg.name}: serve_loop admits token-only prompts, and this "
            f"config's prefill needs "
            f"{'mel frames' if cfg.is_enc_dec else 'images and positions'}"
            f"; drive it with models.model.prefill and decode_step")
    device = next(model.parameters()).device
    decode = S.make_serve_step(cfg)
    prefill = S.make_prefill_step(cfg)

    # Pool sized so the default run never queues: full footprint x batch.
    worst = max(1, -(-(prompt_len + gen_len) // page_size))
    if total_pages is None:
        total_pages = worst * batch
    pool = PagePool(total_pages, page_size)

    requests = _make_requests(cfg, n_requests, prompt_len, gen_len, seed)
    queue = collections.deque(requests)
    cache = M.init_cache(cfg, batch=batch,
                         seq_len=max(prompt_len * 4, gen_len * 2, 8),
                         device=device)
    slot_req: list[Request | None] = [None] * batch
    tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)

    done_counts: collections.Counter = collections.Counter()
    completed: list[Request] = []
    rejected: list[Request] = []
    steps = decode_tokens = prefill_tokens = 0
    if max_steps is None:
        max_steps = n_requests * (gen_len + prompt_len) * 2 + 200
    t0 = time.perf_counter()

    def finish(req: Request, bucket: list, step: int):
        done_counts[req.rid] += 1
        if done_counts[req.rid] > 1:
            raise ServeError(f"request {req.rid} finished twice")
        req.done_step = step
        bucket.append(req)

    def retire_finished(step: int):
        for s in range(batch):
            req = slot_req[s]
            if req is not None and req.generated >= req.gen_len:
                pool.free(req.rid)         # reclaim exactly once
                finish(req, completed, step)
                slot_req[s] = None

    while queue or any(r is not None for r in slot_req):
        if steps > max_steps:
            raise ServeError(
                f"serve loop did not converge in {max_steps} steps "
                f"({len(completed)}/{n_requests} done)")
        # ---- admission: fill idle slots from the queue ----
        for s in range(batch):
            if slot_req[s] is not None or not queue:
                continue
            req = queue[0]
            if not pool.fits(req.tokens_needed):
                queue.popleft()
                finish(req, rejected, steps)
                continue
            try:
                pool.alloc(req.rid, req.tokens_needed)
            except PagesExhausted:
                break                  # FIFO: wait for reclaims
            queue.popleft()
            prompt = torch.from_numpy(req.prompt).to(device)
            logits_last, pre = prefill(model, {"tokens": prompt})
            prefill_tokens += req.prompt.shape[1]
            cache = _scatter_prefill(cache, pre, s)
            tokens[s, 0] = torch.argmax(logits_last[0]).to(torch.int32)
            req.generated = 1          # prefill emitted the first token
            slot_req[s] = req
            decode_tokens += 1
        # a request whose prefill already satisfied gen_len completes
        # without ever taking a decode tick
        retire_finished(steps)
        active = [s for s in range(batch) if slot_req[s] is not None]
        if active:
            tokens, _, cache = decode(model, cache, tokens)
            for s in active:
                slot_req[s].generated += 1
                decode_tokens += 1
        steps += 1
        retire_finished(steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = max(time.perf_counter() - t0, 1e-9)
    pool.assert_quiescent()
    if len(completed) + len(rejected) != n_requests:
        raise ServeError(f"{len(completed)} completed + {len(rejected)} "
                         f"rejected != {n_requests} submitted")
    lat = sorted(r.done_step - r.submit_step for r in completed) or [0]
    return {
        "steps": steps, "completed": len(completed),
        "rejected": len(rejected),
        "tokens_per_s": decode_tokens / dt,
        "decode_tokens": decode_tokens, "prefill_tokens": prefill_tokens,
        "wall_s": dt,
        "latency_p50_steps": lat[len(lat) // 2],
        "latency_p99_steps": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
        "pages": pool.stats(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config (configs.base.reduced)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=None)
    ap.add_argument("--prepack", action="store_true",
                    help="pack the weights once into the kernels' panel "
                         "layouts (core/packing.py); the kernels then "
                         "stream the packed panels with no per-call "
                         "relayout")
    args = ap.parse_args(argv)

    device = facility.resolve_device(args.device)
    if device.type == "cuda":
        # true-fp32 F32GER: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = M.init_params(cfg, seed=args.seed, device=device,
                          dtype=torch.bfloat16)
    with facility.configure(facility.FacilityConfig(device=device)):
        if args.prepack:
            stats = packing.prepack_params_for_serving(model, min_size=1024)
            print(f"prepacked params: {stats}")
        out = serve_loop(cfg, model, batch=args.batch,
                         prompt_len=args.prompt_len, gen_len=args.gen,
                         n_requests=args.requests, seed=args.seed,
                         page_size=args.page_size, total_pages=args.pages)
    print(f"served {out['completed']} requests in {out['steps']} steps, "
          f"{out['tokens_per_s']:.1f} live tok/s "
          f"({out['decode_tokens']} decode + {out['prefill_tokens']} "
          f"prefill tokens, pages hw={out['pages']['high_water_pages']}"
          f"/{out['pages']['total_pages']})")
    return out


if __name__ == "__main__":
    main()
