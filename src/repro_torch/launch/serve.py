"""Fault-tolerant batched serving on a paged KV pool (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --batch 4 --prompt-len 256 --gen 32 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --batch 4 --prompt-len 256 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --abft
    PYTHONPATH=src python -m repro_torch.launch.serve --fault-matrix

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

  * **Deadlines -> preempt -> requeue** (``--deadline``): per-request
    deadlines in loop ticks; a slot that ages past its deadline is
    preempted (pages freed, slot cleared) and requeued with exponential
    backoff; after ``max_retries`` requeues the request is *failed*
    (counted, never silently dropped).
  * **Guards** (``--guards``): guarded contract dispatch (the kernel ->
    torch -> ref ladder, ``core/lowering.py``) and the per-tick NaN check
    on the logits; the ``serve.step`` and ``kv.alloc`` fault points are
    consulted every tick and admission (``runtime/faults.py``).
  * **ABFT** (``--abft``, implies ``--guards``): checksum-verified contract
    calls (``core/abft.py``; the GEMM kernels' sidecar, K1e); a tick or a
    prefill whose corruption survived the ladder is discarded and its
    requests requeued.
  * ``--fault-matrix``: :func:`run_fault_matrix`, one seeded scenario per
    fault kind, each held to the exactly-once contract.

Accounting: ``tokens_per_s`` counts live-slot decode tokens only (idle
slots and faulted or discarded ticks contribute nothing); prefill tokens
are reported separately.
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
from repro_torch.core import abft as _abft
from repro_torch.core import facility, lowering, packing
from repro_torch.models import model as M
from repro_torch.runtime import faults as _faults
from repro_torch.runtime.kv_pages import PagePool, PagesExhausted
from repro_torch.train import steps as S


@dataclasses.dataclass
class Request:
    """One serving request and its lifecycle bookkeeping."""

    rid: int
    prompt: np.ndarray          # (1, prompt_len) int32
    gen_len: int
    submit_step: int = 0
    max_retries: int = 2
    # mutable lifecycle state
    retries: int = 0
    generated: int = 0
    admit_step: int = -1
    done_step: int = -1

    @property
    def tokens_needed(self) -> int:
        return self.prompt.shape[1] + self.gen_len


class ServeError(RuntimeError):
    """The serving loop violated its own exactly-once contract."""


def _make_requests(cfg, n_requests, prompt_len, gen_len, seed,
                   max_retries=2):
    """The same prompts and generation lengths as the reference's."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        prompt = rng.integers(0, cfg.vocab_size, (1, max(1, prompt_len)),
                              dtype=np.int32)
        g = int(rng.integers(max(1, gen_len // 2), gen_len + 1))
        reqs.append(Request(rid=i, prompt=prompt, gen_len=g,
                            max_retries=max_retries))
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


# The cache entries a decode step overwrites in place and does not rewrite
# on its next try: the SSM state and conv history.  A discarded tick puts
# them back (the ring's k/v slot at ``cur`` is rewritten by the retry).
_STATE_KEYS = ("ssm", "conv")


@torch.inference_mode()
def serve_loop(cfg, model, *, batch: int, prompt_len: int, gen_len: int,
               n_requests: int, seed: int = 0, page_size: int = 16,
               total_pages: int | None = None,
               deadline_steps: int | None = None, max_retries: int = 2,
               backoff_steps: int = 2, guards: bool | None = None,
               abft: bool | None = None,
               max_steps: int | None = None) -> dict:
    """Serve ``n_requests`` synthetic prompts through a ``batch``-slot
    continuous-batching decode loop, on the device that holds ``model``.
    Returns a stats dict (the reference's keys).  Every request ends in
    exactly one of ``completed`` / ``rejected`` / ``failed``; a duplicate
    raises :class:`ServeError` and the page ledger is proven quiescent
    before returning.

    The loop admits token-only prompts, as the reference's does: an
    encoder-decoder config (whisper, whose prefill needs ``frames``) or a
    vision-prefix config (qwen2-vl, whose prefill needs ``images`` and
    M-RoPE ``positions``) raises ``ValueError`` up front; drive those with
    ``models.model.prefill`` and ``decode_step``.

    Fault tolerance, the reference's: ``deadline_steps`` preempts a slot
    that ages past it (pages freed, requeued with exponential backoff of
    ``backoff_steps``; failed after ``max_retries`` requeues); the
    ``serve.step`` point is consulted every tick (raise: the tick crashed
    and produced nothing; latency: a straggler; nan: poisoned logits,
    discarded by the guard); a ``kv.alloc`` fault requeues the request
    with backoff.  ``guards`` (default: the ambient
    ``FacilityConfig.guards``) turns on the per-tick NaN check.  ``abft``
    (default: the ambient ``FacilityConfig.abft``; True arms guarded
    dispatch too) verifies every eligible contract call and drains
    ``abft.VERDICTS``: an unrecovered verdict in a decode tick discards it
    and preempts and requeues its slots; one in a prefill frees that
    request's pages once and requeues it.  A discarded tick keeps the
    previous tokens and puts back the SSM state it overwrote.

    Prefill runs under an empty fault plan: the reference's prefill is
    jitted and visits no hook once traced, so injected faults land in
    decode ticks here as there.  Unlike the reference (whose traced
    prefill is never checksum-verified), the port verifies prefill under
    ABFT too: every port call is concrete.

    It runs under ``torch.inference_mode()``: a trained model, whose
    parameters require gradients, is served without building an autograd
    graph."""
    fac = facility.current()
    if guards is None:
        guards = fac.guards
    if abft is None:
        abft = fac.abft
    if abft and not (fac.guards and fac.abft):
        # ABFT lives in guarded dispatch, which reads the ambient config
        with facility.configure(dataclasses.replace(
                fac, guards=True, abft=True)):
            return serve_loop(
                cfg, model, batch=batch, prompt_len=prompt_len,
                gen_len=gen_len, n_requests=n_requests, seed=seed,
                page_size=page_size, total_pages=total_pages,
                deadline_steps=deadline_steps, max_retries=max_retries,
                backoff_steps=backoff_steps, guards=True, abft=True,
                max_steps=max_steps)
    if cfg.is_enc_dec or cfg.vision_prefix:
        raise ValueError(
            f"{cfg.name}: serve_loop admits token-only prompts, and this "
            f"config's prefill needs "
            f"{'mel frames' if cfg.is_enc_dec else 'images and positions'}"
            f"; drive it with models.model.prefill and decode_step")
    device = next(model.parameters()).device
    decode = S.make_serve_step(cfg)
    prefill = S.make_prefill_step(cfg)
    if abft:
        _abft.clear_verdicts()

    # Pool sized so the default run never queues: full footprint x batch.
    worst = max(1, -(-(prompt_len + gen_len) // page_size))
    if total_pages is None:
        total_pages = worst * batch
    pool = PagePool(total_pages, page_size)

    requests = _make_requests(cfg, n_requests, prompt_len, gen_len, seed,
                              max_retries)
    queue = collections.deque(requests)
    waiting: list[tuple[int, Request]] = []   # (eligible_at_step, request)
    cache = M.init_cache(cfg, batch=batch,
                         seq_len=max(prompt_len * 4, gen_len * 2, 8),
                         device=device)
    slot_req: list[Request | None] = [None] * batch
    slot_age = [0] * batch
    tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)

    done_counts: collections.Counter = collections.Counter()
    completed: list[Request] = []
    rejected: list[Request] = []
    failed: list[Request] = []
    st = collections.Counter()
    verdict_log: list[dict] = []
    steps = decode_tokens = prefill_tokens = 0
    if max_steps is None:
        max_steps = (n_requests * (gen_len + prompt_len) * (max_retries + 2)
                     + 200)
    t0 = time.perf_counter()

    def finish(req: Request, bucket: list, step: int):
        done_counts[req.rid] += 1
        if done_counts[req.rid] > 1:
            raise ServeError(f"request {req.rid} finished twice")
        req.done_step = step
        bucket.append(req)

    def requeue(req: Request, at: int):
        """Preempted (its pages already freed): failed past the retry
        budget, else back in line at step ``at``."""
        st["preemptions"] += 1
        req.retries += 1
        req.generated = 0
        if req.retries > req.max_retries:
            finish(req, failed, steps)
        else:
            st["requeues"] += 1
            waiting.append((at, req))

    def drain() -> bool:
        """Count this dispatch window's checksum verdicts; True when one
        went unrecovered (the values are untrustworthy)."""
        verdicts = _abft.drain_verdicts()
        verdict_log.extend(verdicts)
        good = sum(1 for v in verdicts if v["recovered"])
        st["abft_detections"] += len(verdicts)
        st["abft_recoveries"] += good
        return good < len(verdicts)

    def outstanding() -> bool:
        return bool(queue or waiting or any(r is not None for r in slot_req))

    while outstanding():
        if steps > max_steps:
            raise ServeError(f"serve loop did not converge in {max_steps} "
                             f"steps ({len(completed)}/{n_requests} done)")
        # ---- release backoff waiters whose turn has come ----
        queue.extend(req for at, req in waiting if at <= steps)
        waiting = [(at, req) for at, req in waiting if at > steps]
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
            except _faults.InjectedFault:
                # transient allocator failure: requeue to the tail with
                # backoff instead of crashing the loop
                queue.popleft()
                st["alloc_faults"] += 1
                st["requeues"] += 1
                waiting.append((steps + backoff_steps, req))
                continue
            queue.popleft()
            prompt = torch.from_numpy(req.prompt).to(device)
            with _faults.install(_faults.FaultPlan()):
                logits_last, pre = prefill(model, {"tokens": prompt})
            prefill_tokens += req.prompt.shape[1]
            if abft and drain():
                # an unrecovered checksum in this prefill: its state is
                # untrustworthy; pages back once, the request back in line
                st["abft_discards"] += 1
                pool.free(req.rid)
                requeue(req, steps + backoff_steps)
                continue
            cache = _scatter_prefill(cache, pre, s)
            tokens[s, 0] = torch.argmax(logits_last[0]).to(torch.int32)
            req.generated = 1          # prefill emitted the first token
            req.admit_step = steps
            slot_req[s] = req
            slot_age[s] = 0
            decode_tokens += 1
        # a request whose prefill already satisfied gen_len completes
        # without ever taking a decode tick
        for s in range(batch):
            req = slot_req[s]
            if req is not None and req.generated >= req.gen_len:
                pool.free(req.rid)
                finish(req, completed, steps)
                slot_req[s] = None
        active = [s for s in range(batch) if slot_req[s] is not None]
        if active:
            # ---- one decode tick, under the serve.step fault point ----
            try:
                fault = _faults.maybe_inject(_faults.SERVE_STEP, step=steps)
            except _faults.InjectedFault:
                # the tick crashed: no tokens; the slots still age so that
                # deadlines can fire
                st["step_faults"] += 1
                fault = None
                step_ok = unrecovered = False
            else:
                saved = ({k: cache[k].clone() for k in _STATE_KEYS
                          if k in cache} if guards else {})
                nxt, logits, new_cache = decode(model, cache, tokens)
                if fault is not None and fault.kind == _faults.NAN:
                    logits = _faults.poison(logits)
                step_ok = True
                unrecovered = abft and drain()
                if unrecovered:
                    # SDC survived the whole ladder: discard the tick and
                    # requeue its slots rather than serve corruption
                    step_ok = False
                    st["abft_discards"] += 1
                if guards and step_ok and not bool(
                        torch.isfinite(logits[active]).all()):
                    # poisoned output: discard the tick (no tokens
                    # emitted, the previous sampler state kept)
                    step_ok = False
                    st["nan_steps"] += 1
                if step_ok:
                    cache, tokens = new_cache, nxt
                    for s in active:
                        slot_req[s].generated += 1
                        decode_tokens += 1
                else:
                    for k, v in saved.items():
                        cache[k].copy_(v)
            steps += 1
            for s in active:
                slot_age[s] += 1
            if unrecovered:
                # every slot that decoded through the corrupt tick: pages
                # reclaimed exactly once, requeued with backoff (a new
                # prefill rebuilds clean state)
                for s in active:
                    pool.free(slot_req[s].rid)
                    requeue(slot_req[s], steps + backoff_steps)
                    slot_req[s] = None
        else:
            # nothing decodable this tick (everyone in backoff or blocked
            # on pages): the clock must still advance so waiters drain
            steps += 1
        # ---- retire / preempt ----
        for s in range(batch):
            req = slot_req[s]
            if req is None:
                continue
            if req.generated >= req.gen_len:
                pool.free(req.rid)         # reclaim exactly once
                finish(req, completed, steps)
                slot_req[s] = None
            elif deadline_steps is not None and slot_age[s] > deadline_steps:
                pool.free(req.rid)
                slot_req[s] = None
                requeue(req, steps + backoff_steps * 2 ** req.retries)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = max(time.perf_counter() - t0, 1e-9)
    pool.assert_quiescent()
    if len(completed) + len(rejected) + len(failed) != n_requests:
        raise ServeError(
            f"{len(completed)} completed + {len(rejected)} rejected + "
            f"{len(failed)} failed != {n_requests} submitted")
    lat = sorted(r.done_step - r.submit_step for r in completed) or [0]
    return {
        "steps": steps, "completed": len(completed),
        "rejected": len(rejected), "failed": len(failed),
        # live-slot decode tokens only: idle slots and faulted or
        # discarded ticks contribute nothing
        "tokens_per_s": decode_tokens / dt,
        "decode_tokens": decode_tokens, "prefill_tokens": prefill_tokens,
        "wall_s": dt,
        **{k: st[k] for k in ("preemptions", "requeues", "step_faults",
                              "nan_steps", "alloc_faults", "abft_detections",
                              "abft_recoveries", "abft_discards")},
        "latency_p50_steps": lat[len(lat) // 2],
        "latency_p99_steps": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
        "pages": pool.stats(),
        # every checksum verdict drained (core/abft.py's records)
        "abft_verdicts": verdict_log,
    }


# ----------------------------------------------------------------------
# Fault matrix: one seeded scenario per fault kind, each holding the
# exactly-once serving contract end to end (the reference's table).
# ----------------------------------------------------------------------

def _matrix_scenarios():
    F = _faults.FaultSpec
    return (
        # a kernel raise during dispatch: guarded dispatch must demote down
        # the ladder within the step, serving continues
        ("kernel-raise", [F(point=_faults.CONTRACT_DISPATCH,
                            kind=_faults.RAISE, max_fires=2)], {}),
        # poisoned logits the NaN guard must discard
        ("nan-poison", [F(point=_faults.SERVE_STEP, kind=_faults.NAN,
                          every=2, max_fires=3)], {}),
        # page exhaustion: a pool smaller than the offered load — requests
        # queue at admission and drain as pages are reclaimed
        ("page-exhaustion", [], {"total_pages_factor": 0.5}),
        # straggler tick: injected latency the loop must absorb
        ("latency-spike", [F(point=_faults.SERVE_STEP, kind=_faults.LATENCY,
                             every=2, max_fires=2, latency_s=0.02)], {}),
        # crashed decode ticks: no tokens produced, slots age, the loop
        # retries the tick and every request still completes
        ("step-crash", [F(point=_faults.SERVE_STEP, kind=_faults.RAISE,
                          every=3, max_fires=3)], {}),
        # transient allocator failure: admission requeues with backoff
        ("alloc-fault", [F(point=_faults.KV_ALLOC, kind=_faults.RAISE,
                           max_fires=2)], {}),
        # silent data corruption: a finite single-element flip on contract
        # outputs that only ABFT sees; the burst (3 fires) spans one
        # dispatch's retry and demotion, so it recovers within the tick
        ("sdc", [F(point=_faults.CONTRACT_DISPATCH, kind=_faults.FLIP,
                   every=1, max_fires=3)], {"abft": True}),
    )


def run_fault_matrix(cfg, model, *, batch=2, prompt_len=8, gen_len=6,
                     n_requests=4, seed=0) -> list[dict]:
    """Run every fault scenario; each must serve all requests exactly once
    with the page pool fully reclaimed (serve_loop raises otherwise).  Each
    row carries the scenario's stats (the checksum verdicts among them),
    the faults fired and the demotions."""
    results = []
    for name, specs, opts in _matrix_scenarios():
        page_size = 4
        worst = -(-(prompt_len + gen_len) // page_size)
        total = worst * batch
        if "total_pages_factor" in opts:
            total = max(worst, int(total * opts["total_pages_factor"]))
        plan = _faults.FaultPlan(specs, seed=seed)
        lowering.clear_guard_state()
        with facility.configure(dataclasses.replace(
                facility.current(), guards=True,
                abft=bool(opts.get("abft", False)))):
            with _faults.install(plan):
                out = serve_loop(
                    cfg, model, batch=batch, prompt_len=prompt_len,
                    gen_len=gen_len, n_requests=n_requests, seed=seed,
                    page_size=page_size, total_pages=total,
                    deadline_steps=gen_len * 6, max_retries=3)
        ok = (out["completed"] == n_requests and out["rejected"] == 0
              and out["failed"] == 0)
        if opts.get("abft"):
            # the sdc scenario must actually *detect* the corruption, not
            # merely survive it
            ok = ok and out["abft_detections"] > 0
        results.append({"scenario": name, "ok": ok,
                        "fired": len(plan.events),
                        "demotions": len(lowering.GUARD_EVENTS), **out})
    return results


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
    ap.add_argument("--deadline", type=int, default=None,
                    help="preempt and requeue a request whose slot ages "
                         "past this many ticks")
    ap.add_argument("--guards", action="store_true",
                    help="guarded dispatch (kernel -> torch -> ref) and the "
                         "per-tick NaN check")
    ap.add_argument("--abft", action="store_true",
                    help="checksum-verified contract calls (core/abft.py); "
                         "corrupted ticks are discarded and their slots "
                         "requeued (implies --guards)")
    ap.add_argument("--fault-matrix", action="store_true",
                    help="run the seeded fault-injection matrix instead "
                         "of a plain serving run")
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
    guards = args.guards or args.abft
    with facility.configure(facility.FacilityConfig(
            device=device, guards=guards, abft=args.abft)):
        if args.prepack:
            stats = packing.prepack_params_for_serving(model, min_size=1024)
            print(f"prepacked params: {stats}")
        if args.fault_matrix:
            results = run_fault_matrix(cfg, model, batch=args.batch,
                                       prompt_len=args.prompt_len,
                                       gen_len=args.gen,
                                       n_requests=args.requests,
                                       seed=args.seed)
            for r in results:
                print(f"[{'ok' if r['ok'] else 'FAIL'}] "
                      f"{r['scenario']:16s} completed={r['completed']} "
                      f"faults={r['fired']} demotions={r['demotions']} "
                      f"abft={r['abft_detections']} "
                      f"preempt={r['preemptions']} "
                      f"requeue={r['requeues']} "
                      f"pages_hw={r['pages']['high_water_pages']}")
            bad = [r["scenario"] for r in results if not r["ok"]]
            if bad:
                raise SystemExit(f"fault matrix failed: {bad}")
            print(f"fault matrix clean: {len(results)} scenarios, every "
                  f"request served exactly once, pages fully reclaimed")
            return results
        out = serve_loop(cfg, model, batch=args.batch,
                         prompt_len=args.prompt_len, gen_len=args.gen,
                         n_requests=args.requests, seed=args.seed,
                         page_size=args.page_size, total_pages=args.pages,
                         deadline_steps=args.deadline)
    print(f"served {out['completed']} requests in {out['steps']} steps, "
          f"{out['tokens_per_s']:.1f} live tok/s "
          f"({out['decode_tokens']} decode + {out['prefill_tokens']} "
          f"prefill tokens, pages hw={out['pages']['high_water_pages']}"
          f"/{out['pages']['total_pages']})")
    return out


if __name__ == "__main__":
    main()
