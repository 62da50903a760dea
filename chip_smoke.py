#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits nonzero:

  1. card and build: print the card's name and power limit (nvidia-smi),
     build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
     with nvcc for sm_90a (one nvcc per source, in parallel) and print the
     build time and ptxas's register/spill report;
  2. kernels: hold each kernel (each of the GEMM's three paths, the
     attention tile and its split-KV form, K3's wgmma and WMMA kernels,
     K4's vector and scalar paths) against its plain PyTorch version, on
     the card, at the main paths' shapes (the SSD's batched
     products, mamba2's causal conv, whisper's conv stem and encoder and
     cross attention, qwen2-vl's patch embed and GQA prefill included)
     and on edge cases
     (ragged fringes, batch, accumulate forms, every epilogue, GQA, window,
     q_offset, valid, fully-masked rows, conv strides, ragged channels, F
     and K fringes, f16/f32 conv inputs); print each case's worst error
     and tolerance (K4 also bit for bit at mamba2's four shapes with no
     epilogue; K3's stems launched three times for the same bits), and
     time each kernel (CUDA events, L2 flushed between
     launches) beside its plain version, one PyTorch library call as a
     yardstick, and the bound from bytes and flops at the card's published
     peaks;
  3. serve, through ``repro_torch.launch.serve.serve_loop`` with random
     bf16 weights from a seed: deepseek-7b at full width (the GEMM and
     flash-attention kernels), zamba2-1.2b at full width and depth (GEMM,
     attention, depthwise conv), mamba2-130m at full width (GEMM and
     depthwise conv) and deepseek-moe-16b at full width and depth (GEMM,
     its expert banks batched products on the weight stream, and
     attention); then generate, through ``models.model.prefill`` and
     ``decode_step`` (the serving loop admits token-only prompts), with
     whisper-small (4 clips of 3000 mel frames, a 4-token decoder prompt)
     and qwen2-vl-7b (4 requests of one 448 x 448 image and 64 text
     tokens) at full width and depth: a batch-4 prefill, the cache
     handoff, 32 greedy decode steps (GEMM, attention and the dense conv).
     Every kernel's launch count is reset just before each run and read
     just after, and must match the per-call model (each kernel of that
     path > 0); then each model's prefill and decode logits on the kernel
     backend against the eager torch backend (for deepseek-moe-16b also
     the share of (token, choice) pairs the two backends routed alike),
     mamba2-130m's exact per-slot prefill handoff, and a profile of one
     prefill and one decode step of deepseek-7b, zamba2, deepseek-moe-16b,
     whisper-small and qwen2-vl-7b.  Each run also
     records the GEMM's and the two convs' launches by path and the shapes
     it gave the GEMM, the attention kernel and the depthwise conv; every
     decode product and every expert-bank product must have taken the
     weight stream, every other deepseek-7b, qwen2-vl-7b and
     deepseek-moe-16b prefill product the wgmma tile, every one-query
     attention split-KV, every dense conv K3's wgmma kernel and every
     depthwise conv K4's vector path;
  4. the runs' shapes: each distinct GEMM, attention and depthwise conv
     shape of the runs held against its plain version and timed (kernel,
     path, torch.matmul, SDPA or cuDNN, bound; the split-KV decode
     kernel's whisper shapes also with the parent kernel's PERF.md time
     and its aim, ``SPLIT_AIMS``);
  5. train, through ``repro_torch.launch.train.build`` with random fp32
     weights from seed 0 and the default BF16GER2 facility: deepseek-7b at
     full width with its depth cut to 4 layers (fp32 parameters, gradients
     and both moments of all 30 layers, ~110 GB, do not fit the card),
     zamba2-1.2b at full width and depth, deepseek-moe-16b at full width
     cut to 3 layers (one dense, two MoE) and whisper-small at full width
     and depth (4 clips of 3000 mel frames, 448 decoder tokens), each 6
     steps of AdamW (lr 3e-5, whisper-small 1e-3; no weight decay) on one
     repeated batch of 4 x 512 tokens.  Step 1's
     loss and every parameter's gradient on the kernel backend are held
     against the eager torch backend (the same rule as the logits); the
     loss must be finite, fall at every step after the first update (at
     full width it rises after Adam's first update) and by 20% or more
     from step 1 to step 6; each kernel's launches must match the
     per-call model (the forward's, two more GEMMs per GEMM in the
     backward and one recompute per GEMM with a fused activation;
     attention and the depthwise conv launch in the forward only); the
     same steps on the eager torch backend must give each step's loss
     within 2e-2 relative; step time, a profiled step's device busy time
     and idle share, tokens/s, model TFLOP/s and peak memory are printed;
     the state goes through a ``Checkpointer`` save and restore and must
     come back bit for bit.  Then, as in phase 4, each distinct shape the
     train steps gave the GEMM (forward, dX, dW, the recompute of Z),
     attention and the depthwise conv is held against its plain version
     and timed;
  6. the family table and its paths: the IMMA kernel (I8GER4, I4GER8,
     I16GER2) and the DMMA kernel (F64GER) against their plain versions
     at edge cases (ragged fringes, batch, every accumulate form with a
     full-range int32 seed, bias/relu/residual, gelu/silu for F64GER, out
     dtypes, I16GER2's wrap), integers bit for bit and F64GER within
     1e-15 * K * max|x| * max|y|; then, each run's launches reset just
     before and read just after and held to its path, the integer
     families (8192^2, 4096^2) through ``facility.contract``,
     ``quant.qdot`` at deepseek-7b's MLP shapes (M = 4 and 1024, 4096 ->
     11008; the two operand copies its spec makes counted and timed),
     ``blas3.complex_gemm`` at 4096^2 in complex64 and a batched
     ``blas3.dft`` (N = 1024, 64 x 128 columns) in f32 (four GEMM
     launches a call), against complex ``torch.matmul`` and a float64
     fft (F64GER's DGEMM, complex128 and f64 runs are phase 14's),
     ``blas3.trsm`` (N = 4096, 1024 right-hand sides, relative residual)
     and the saturating forms bit for bit against the ref lowering; each
     timed beside its plain version, a library yardstick and its bound
     (the integer runs' IMMA launches held to their form: the wgmma tile,
     and I8GER4's weight stream at qdot's M = 4); then ``IMMA_TARGETS``
     through the kernel wrapper: the integer families at 8192^3 and
     4096^3, the packed and masked 4096^3 forms and the kernel at qdot's
     decode (M = 1-64, natural and on X panels), each on the form
     ``tiling.imma_plan`` picks, bit for bit its plain version and the
     mma.sync kernel (an explicit block), timed beside that kernel,
     ``torch._int_mm`` (B row-major and column-major), the bound, the
     parent's PERF.md time and its aim, met or missed;
  7. prepacked serving (``core.packing``: K1d, the GEMM's packed panel
     stream, and K3's packed filter stream), each model reused right
     after its phase-3 run: a copy of deepseek-7b packed in place
     (``prepack_params_for_serving``, min_size 1024) and served with
     phase 3's settings in turn with the natural model (natural, packed,
     packed, natural, natural, packed), every prefill and decode output (token ids and
     logits) of the first packed serve bit for bit phase 3's, each packed
     serve's launches by path phase 3's, and no pack, repack or demote
     while serving (pack time, each serve's decode tok/s, 5 batch-1
     prefills and 15 decode steps of each model in turn, host clock, and
     one decode step profiled, printed natural beside packed);
     deepseek-moe-16b (its expert banks as batched Y panels),
     whisper-small (conv1_w, conv2_w) and qwen2-vl-7b (patch_w and the
     dense stack) run one prefill and 4 decode steps on phase 3's inputs
     before and after packing, bit for bit, with no demote; then
     ``quant.qdot`` on X-side int8 panels at M = 4 and 1024 through the
     entry point (bit for bit, the IMMA kernel on packed panels), and each
     packed kernel mode (the weight stream at 4 x 4096 x 11008 and at an
     expert bank 64 x 1 x 2048 x 1408, the wgmma tile at 1024 x 4096 x
     11008, K3 at whisper's conv2, the IMMA kernel under qdot) bit for bit
     against its natural launch and within tolerance of its plain
     version, timed beside both, the library call and the bound, the
     host time of one call, natural beside packed, of the wrapper and of
     ``facility.contract`` at decode and prefill M, and ``qdot``'s whole
     call packed (no W^T copy) beside natural;
  8. the pm* masked forms (K1b) and the tight-parity config,
     ``FacilityConfig(ger=F32GER, out_dtype=float32)`` (K2e: f32
     attention on the attention kernel's fp32 tile): deepseek-7b served
     at full width and depth through ``serve_loop`` and whisper-small
     generating at full width and depth, each right after its phase-3 run
     (before phase 7 packs it), and two train steps of deepseek-7b at 4
     layers through ``launch.train.build(..., ger=F32GER,
     out_dtype=float32)``: each run's launches held to the per-call model,
     every GEMM on its fp32 path (the wrapper's trace: the fp32 weight
     stream at M <= 64, the fp32 SIMT tile above, never the tensor cores)
     and every attention on the fp32 tile (tile or split-KV, counted by
     mode), the logits (and step-1 loss and gradients) against the eager
     torch backend in the same config within ``F32_TOL``, and one more
     train step profiled, split into GEMM, other device work and host;
     then F32GER's two GEMM kernels at the runs' shapes (each row bucket,
     deepseek-7b's decode and prefill products and logits, whisper's
     unaligned logits, fringes, forms, a batch): each against the plain
     version of its path with TF32 off and the TF32 control refused (the
     plain version on TF32-rounded operands outside the tolerance), a
     decode row bit for bit at batch 1 and 4, packed Y bit for bit,
     timed beside the plain version, ``torch.matmul`` f32 and the bound;
     then masked products through ``facility.contract(masks=)``
     and ``kernels.ops.mma_pm_dot`` at deepseek-7b's MLP shapes (and
     F32GER, I8GER4, F64GER and a batched F32GER product with a seed),
     launches counted by path, each held against its plain version with
     NaN and Inf in every disabled lane (integers bit for bit) and timed
     beside the same kernel unmasked, the unmasked default path, the plain
     version, a ``torch.where`` + library yardstick and its bound; and K2e
     (the fp32 tile and the decode kernel on f32 operands) at the F32GER
     runs' attention shapes (``F32_ATTENTION``) with the TF32 control, a
     split row at batch 1 bit for bit the same row in the batch, timed
     beside SDPA on f32 inputs, the bound, the parent kernel's PERF.md
     time and its aim (a miss is reported, not failed);
  9. guarded serving and ABFT (``runtime/faults.py``, the guarded kernel
     -> torch -> ref ladder, ``core/abft.py``) and K1e, the GEMM kernels'
     checksum sidecar, its serving runs right after deepseek-7b's phase-3
     run, at full width and depth, each run's counts zeroed just before
     and read just after: a guards-on serve (ABFT off) whose every prefill
     and decode output is phase 3's bit for bit, with no guard event and
     every contract dispatch on the kernel rung; an ABFT serve
     (``serve_loop(..., abft=True)``, phase 3's settings) with no verdict
     and no demotion, each prefill's logits within phase 3's logits bound
     (relative L2) of phase 3's, the sidecar launched on the weight stream
     and the wgmma tile and attention at the padded depth 129;
     ``run_fault_matrix``
     (batch 2, 8-token prompts, 6 new tokens, 4 requests): all 7
     scenarios ok, ``sdc`` detected by a kernel-rung check that read the
     sidecar, and recovered; decode tok/s of each beside phase 3's and
     the matrix's wall time.  Then ABFT runs through ``facility.contract``
     of what that serve does not reach (F32GER and an unaligned pitch on
     the WMMA tile, a DGEMM on DMMA, whisper's conv2 with its 769th
     checksum filter on K3's WMMA tile, attention at D + 1 in every mode),
     each the unguarded call's (GEMMs bit for bit, the rest within 2e-2)
     with no verdict; then each sidecar kernel at the runs' shapes (decode
     4 x 4096 x 11008, split, and the 102400-column logits, unsplit, on
     the weight stream; 1024 x 4096 x 11008 on the wgmma tile; F32GER and
     an unaligned 1024 x 768 x 51865 on the WMMA tile; DGEMM 2048^3 on
     DMMA): ``out`` bit for bit ``checksum=False``'s, the sums within
     ABFT's tolerance of the plain version's, timed on and off beside the
     plain version, ``torch.matmul`` and the bound; and K2 at D = 129 and
     65 in every mode against its plain version, timed at deepseek's
     prefill beside D = 128 and SDPA;
 10. autotuned dispatch (``core/autotune.py``, ``roofline/analysis.py``),
     K1d on the WMMA and fp32 tiles and K3's packed filters on its WMMA
     and fp32 tiles.  The script points ``REPRO_TORCH_AUTOTUNE_CACHE`` at
     a fresh temporary file, so phases 1-9 dispatch on an empty cache as
     they did before.  Its runs, each counts zeroed just before and read
     just after: right after phase 8's F32GER serve, deepseek-7b in the
     tight-parity config served prepacked (fp32 panels): every output bit
     for bit that serve's, no pack, repack or demote, every GEMM reading
     panels on its fp32 path (decode's on the fp32 stream, prefill's on
     the fp32 tile), decode tok/s of both, and one decode step profiled,
     split into GEMM, other device work and host; right after
     phase 8's whisper-small generation, the same prepacked: prefill and
     8 steps bit for bit, the stem's convs on K3's fp32 tile reading
     packed filters; after phase 7's serves of deepseek-7b, every GEMM and
     attention shape its serve consults tuned on the card into a cache of
     its own (the winner beside the heuristic, both timed), then phase
     3's serve under it, natural and a packed copy: each GEMM launch on
     its consult's winner with no fallback, the two bit for bit, no pack,
     repack or demote, prefill and decode logits within phase 3's bound
     against the eager backend, decode tok/s beside phase 3's, and the
     host us of one ``contract`` call on the empty cache beside the full
     one.  Then every packed WMMA/fp32 mode through ``facility.contract``
     (explicit tiles at decode 4 x 4096 x 11008 and prefill 1024 x 4096 x
     11008, F32GER at both (decode on the fp32 weight stream), the
     unaligned 1024 x 768 x 51865, masked bf16
     and F32GER with NaN and Inf in disabled lanes, M/N/K fringes; K3's
     WMMA and fp32 tiles at whisper's conv2 and qwen2-vl's patch embed):
     packed bit for bit natural and against the plain version, the
     sidecar on a packed WMMA launch bit for bit, timed beside the natural
     launch, the plain version, the library call and the bound;
 11. the last TPU kernel forms: K1d's packed panels on every GEMM path and
     K2d's full-grid attention.  One main-path run, counts zeroed just
     before and read just after: every mode of ``K1D_MODES`` natural and
     packed through ``facility.contract`` (DGEMM 2048^3 with Y, X and both
     packed and masked on DMMA; I8GER4 4096^3 with Y and both packed,
     masked too, and I16GER2 4096^3 with X and Y packed on IMMA; X panels
     on the weight stream at decode 4 x 4096 x 11008, on the wgmma tile
     at prefill 1024 x 4096 x 11008 (X and X+Y), on the WMMA tile (an
     explicit (128, 128, 32) block and a masked call) and the fp32 tile
     there, and the weight on the X side at 11008 x 4096 x 4), and
     ``mma_flash_attention`` bounded and with ``bound_grid=False`` at
     ``K2D_CASES``: packed launches by path as the modes want, every
     full-grid launch counted, 0 packs, repacks and demotes.  Each packed
     result bit for bit the natural one (NaN/Inf in disabled float lanes
     giving exact zeros) and held against the plain version (integers
     bit for bit, DGEMM within 1e-15 K max|x| max|y|); the sidecar on the
     packed DMMA, stream and wgmma launches bit for bit; each full grid bit
     for bit the bounded launch and within its rounding budget of the
     plain version; every mode timed beside its natural launch (the
     bounded one for K2d, with both step counts), the plain version, the
     library call (``torch.matmul`` in the operands' dtype,
     ``torch._int_mm`` s8 x s8 for the integer families, not the same
     function; SDPA) and the bound.
 12. the 16-bit WMMA tile's forms (``WMMA_CASES``) and K3's WMMA conv
     (``WMMA_CONV_CASES``) through ``facility.contract``, each against its
     plain version and timed beside the library call, the bound and the
     parent kernel's PERF.md time;
 13. K2's 16-bit tile mode (``flash_tile_kernel``: persistent blocks,
     ping-ponged consumers, 128-key steps) at the main path's prefill and
     train shapes (``ATTN_TARGETS``) through ``facility.contract``, counts
     zeroed just before and read just after (every launch the tile mode's),
     each result within its rounding budget of the plain version, each
     timed beside SDPA, the bound and the parent kernel's PERF.md time,
     its target met or missed (reported, not failed);
 14. F64GER's DMMA kernel (``gemm_dmma.cu``: a 128 x 128 or 64 x 64 fp64
     tensor-core tile on an mbarrier ``cp.async`` ring) at
     ``DMMA_TARGETS`` through ``facility.contract`` (DGEMM 2048^3
     natural, on X+Y panels, masked with NaN and Inf in the disabled
     lanes and under ABFT with the sidecar; 8192^3; the batched f64
     ``dft`` and the complex128 ``complex_gemm`` through their entry
     points, the family table's F64GER runs; a skinny and a ragged
     product on the 64 x 64 tile), counts
     zeroed just before and read just after (every launch DMMA's); each
     within 1e-15 K max|x| max|y| of the plain version, both tiles bit for
     bit, packed bit for bit natural, the sidecar's ``out`` bit for bit
     ``checksum=False``'s; each timed beside ``torch.matmul`` f64, the
     bound, the parent kernel's PERF.md time and its aim (``time dmma
     ...`` lines; an aim missed is reported, not failed).
 15. K1's wgmma tile at ``WGMMA_TARGETS`` (deepseek-7b's M = 256
     prefill products, 1024 x 4096 x 11008 natural, on X panels and with
     the sidecar, whisper-small's encoder, deepseek-7b's train forward
     and dW, f16, packed Y; bf16 out) and K3's fp32 conv at
     ``CONV_F32_TARGETS`` through the kernel wrappers, counts zeroed just
     before and read just after; each against its plain version, the
     same bits twice and the parent's output hash, timed beside
     ``torch.matmul`` / cuDNN, the bound, the parent's time and its aim
     (``time wgmma ...``, ``time conv ...``; K3's bf16 conv targets on
     its wgmma kernel at the wave plan's tile, whisper's conv2 held to
     cuDNN in the same run);
 16. the 16-bit weight stream (``gemm_stream.cu``'s TMA kernel, or its
     cp.async kernel where TMA cannot read a row) at ``STREAM_TARGETS``
     (deepseek-7b's decode products and logits, deepseek-moe-16b's expert
     banks at decode and at a prefill's cap of 30, the row buckets 16/32/
     64, whisper's decoder MLP and unaligned logits, mamba2's in_proj, the
     SSD's batched M = 1 product, packed X and Y, a shared Y, the sidecar,
     f16) through the kernel wrapper, counts zeroed just before and read
     just after (every launch on the stream); each against its split-K
     plain version, the same bits twice, packed bit for bit natural, its
     hash against the parent's (``PHASE16_PARENT_SHA``), each b = 64 bank
     bit for bit its 64 experts run one at a time; timed beside
     ``torch.matmul``, the bound, the parent's PERF.md time and its aim
     (``time stream ...``);
 17. elastic training (``runtime/elastic.py``): mamba2-130m at full width
     and depth (24 layers, d_model 768, fp32 parameters) through
     ``launch.train.build`` and ``ElasticTrainer`` on phase 5's batch (4 x
     512 tokens, lr 3e-5), step-addressable batches from seed 0 through
     ``data.pipeline.Prefetcher``, checkpoints in a temporary directory:
     ``run(10)``, a checkpoint every 4 steps, under a ``FaultPlan`` of a
     ``train.step`` raise at step 5, a 2 s ``train.step`` latency at step 9
     (the watchdog at patience 1) and a ``checkpoint.save`` raise at step
     10 (the final sync save): 2 restarts, the steps run 0-4, 4-9, 8-9,
     step 9 a straggler (any other flagged step printed with its time),
     ``latest_step()`` 10, every loss finite; then the same 10 steps with
     no fault into another directory; each run's counts zeroed just
     before and read just after and held to ``expected_train_launches``
     times the steps it ran; each step's loss and every leaf of the final
     state of the faulted run bit for bit the clean run's (or within 1e-4,
     said so); the faulted run's peak device memory at most half the
     state above the clean run's (a restart frees the failed attempt's
     state before building the next); each save's, snapshot's and
     restore's seconds and GiB/s, the host-clock step time (the sync on
     the loss); then, as in phase 5,
     each new GEMM and depthwise conv shape of the two runs held against
     its plain version and timed; the runs' launches are added to the
     GEMM's and the depthwise conv's entries.
 18. the mesh (``parallel/api.py``, ``core/lowering.py``'s per-shard
     dispatch): 4 spawned ranks that all bind cuda:0 over gloo (NCCL
     refuses two ranks on one GPU: the compute is the card's, the
     collectives gloo's through host memory), a 2 x 2 (data, model) mesh;
     every kernel library built before the spawn.  First: gloo takes
     CUDA tensors for the four c10d collectives ``parallel/api.py``
     calls.  (a) deepseek-7b's prefill products
     (``MESH_GEMMS``), causal GQA attention (1, 256, 32, 128), a
     sequence-parallel causal case, whisper's conv2 and zamba2's
     depthwise conv through ``contract`` under the mesh's rules, each
     output's sha256 on every rank equal to the parent's unsharded call,
     the ``collective`` probe fired; an indivisible product and
     ``Plan(mesh=False)`` fire nothing and equal it too.  (b)
     deepseek-moe-16b at 3 layers, phase 3's first 4 prompts, forward with
     ``EXCHANGE_DISPATCH`` over 2- and 4-way expert axes, logits bit for
     bit the parent's, the banks on the stream or wgmma kernels.  (c)
     deepseek-7b at 4 layers, one step through ``launch.train.build
     (mesh=)`` (TP + FSDP) on 4 x 512 tokens: loss within 1e-3 and every
     parameter within rtol/atol 2e-3 of the parent's step, each leaf's
     first moment within ``MESH_MOMENT_TOL`` and the gradient norm
     within ``MESH_NORM_TOL``, and the same step with the data axis's
     gradient sum skipped failing those two; each rank's peak memory
     beside its share of the state.  (d) mamba2-130m at full width and
     depth under ``ElasticTrainer(state_shardings=)`` on 4 x 512 tokens:
     6 steps with a ``collective`` raise in step 3 (one restart), each
     loss the clean run's bit for bit or within 1e-4, said so.  Launches by path
     and collective bytes per rank; the runs' launches go to the
     entries' ``launches_by_run``.

Phase 1 also launches one instance above 48 KB of shared memory of each
library on a fresh ``threading.Thread`` after the main thread has
launched it (a failure fails the run); phase 3 prints deepseek-moe-16b's
decode step's expert-bank device time (``bank_time``).

The line before the last is ``{"kernels": [...]}`` (one entry per kernel,
``launches`` summed over the runs and ``launches_by_run``; the GEMM's
and the convs' ``launches_by_path``; the GEMM's ``host_us`` per call and,
with the attention kernel's and the depthwise conv's, ``run_shapes``;
phase 6's IMMA entries (``mma_gemm.imma``, the wgmma tile, and
``mma_gemm.imma_stream``, the weight stream; the mma.sync kernel is phase 8's
``mma_gemm masked (imma)``) their ``shapes`` and ``targets``, the GEMM's entry
``phase6_shapes``, its runs on the WMMA tile or on no kernel; phase 7's
packed modes their ``natural_ms`` and ``launches_by_run`` over its runs,
the packed stream's ``host_us`` natural beside packed; phase 8's masked
entries their ``unmasked_ms``, ``default_ms`` and ``timed`` cases, its
f32 attention entries and its F32GER GEMM entries (the fp32 stream, the
fp32 tile: ``timed`` cases with their TF32 control readings)
``launches_by_run`` over the F32GER runs;
``max_abs_err`` covers the runs' shapes, training's included; phase 9's
sidecar entries their ``off_ms``, ``timed`` shapes and
``launches_by_run`` over its runs, its padded attention entry its
``d128_ms`` and ``launches_by_mode``; phase 10's packed WMMA/fp32
entries their ``natural_ms``, ``timed`` cases and ``launches_by_run``
over its runs; phase 11's packed entries, one a path, their
``natural_ms``, ``timed`` modes and ``packed_launches_by_path``, the
first of them the phase's packed launches by path, full-grid launches
and demotes under ``phase11``; its full-grid attention entry its
``bounded_ms``, step counts and ``full_grid_launches``; phase 12's two
entries their ``timed`` forms; phase 13's tile entry its ``timed``
shapes and ``targets_met``; phase 14's DMMA entry its ``timed`` targets,
their tiles and ``aims_met``; phase 16's stream entry its ``timed``
targets, their plans and ``aims_met``; the phase-2 attention entry names
the tile kernel under ``tile_kernel``); the last is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX and nothing
of the JAX package.  Exits nonzero, printing no result, where CUDA
is absent or where ``src/repro_torch`` is not beside this file.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (dense, no sparsity) at the full 700 W limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12,
              "f64": 67e12,            # the fp64 tensor cores (DMMA)
              "int8": 1979e12}         # the int8 tensor cores (IMMA), TOP/s

# The serving runs, each at full width: deepseek-7b (slice 1: the GEMM and
# flash-attention kernels), zamba2-1.2b at full depth (slice 2: all three
# kernels, mamba2 layers with a shared attention block) and mamba2-130m
# (slice 2: the pure-SSM kind and its exact per-slot prefill handoff).
ARCH = "deepseek-7b"
SERVE = dict(batch=4, prompt_len=256, gen_len=32, n_requests=8)
NUM_LAYERS = None        # None = the config's full depth; an int cuts depth
SSM_RUNS = (("zamba2-1.2b", SERVE),
            ("mamba2-130m", dict(batch=4, prompt_len=256, gen_len=16,
                                 n_requests=4)))
# The MoE serving run (ROADMAP B1): deepseek-moe-16b at full width and depth
# (28 layers: one dense, 27 of 64 routed top-6 experts and 2 shared; 16.4
# B parameters, 32.8 GB in bf16), its expert banks batched products on the
# GEMM's batch axis.
MOE_RUN = ("deepseek-moe-16b", SERVE)
# The generation runs of the multimodal kinds (slice 3), at full width and
# depth: whisper-small over 30 s clips (3000 mel frames, its fixed input
# window) with a 4-token decoder prompt; qwen2-vl-7b with one 448 x 448
# image (its 32 x 32 patch grid feeds the 1024 vision positions) and 64
# text tokens a request, a 1088-token prompt.
MM_RUNS = {"whisper-small": dict(batch=4, frames=3000, prompt_len=4,
                                 gen_len=32),
           "qwen2-vl-7b": dict(batch=4, text_len=64, gen_len=32)}
# The training runs (slice 6): (arch, depth cut or None), each at full
# width; deepseek-7b at 4 of its 30 layers (1.65 B parameters: ~26 GB of
# fp32 parameters, gradients and moments, where full depth needs ~110 GB).
# The launcher's schedule takes its first update at the peak rate, and
# Adam's first update moves every weight by about lr: at full width the
# loss rises after it at every rate from 1e-5 to 1e-3 for deepseek-7b, as
# the reference's does at d_model 2048 at 1e-4 and 1e-3
# (scripts/train_lr_witness.py; PERF.md, section 6).  At 3e-5 both
# losses fall at every step after that, by 36% (deepseek-7b) and 72%
# (zamba2) over 6 steps; ``fall`` is the least fall from step 1 to the
# last that the check accepts.
# deepseek-moe-16b at 3 of its 28 layers (the dense layer and 2 MoE layers,
# 1.68 B parameters; full depth needs ~260 GB of fp32 state) and
# whisper-small at full depth over 4 clips of 3000 mel frames, its fixed
# 30 s input window (``seq`` is the frame count for the audio kind; its
# decoder takes its fixed 448 tokens).
TRAIN_RUNS = (("deepseek-7b", 4), ("zamba2-1.2b", None),
              ("deepseek-moe-16b", 3), ("whisper-small", None))
TRAIN = dict(batch=4, seq=512, steps=6, lr=3e-5, fall=0.2)
TRAIN_SEQ = {"whisper-small": 3000}
# whisper-small's decoder labels are uniformly random tokens, with no
# unigram statistics to learn: over 6 steps its loss falls at every rate
# from 1e-5 to 1e-3, but by 20% only at 1e-3 (26%; 12% at 3e-4, 5.6% at
# 3e-5: scripts/train_lr_witness.py --card, PERF.md section 6).
TRAIN_LR = {"whisper-small": 1e-3}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# Timing
# ----------------------------------------------------------------------

class Timer:
    """Median device time of a callable over ``iters`` launches (after
    ``warmup`` untimed ones), each timed with its own CUDA event pair after
    a write of ``flush_bytes`` (larger than the 50 MB L2), so every launch
    starts from a cold cache, and a spin of ``hold_us`` on the card, so
    that the callable's host work is done before its first kernel may
    start and its launches are timed back to back: the time is the
    device's, not the wrapper's."""

    def __init__(self, torch, flush_bytes: int = 256 << 20,
                 hold_us: float = 300.0):
        self.torch = torch
        self.flush = torch.empty(flush_bytes, dtype=torch.uint8,
                                 device="cuda")
        # cycles at the H100's 1.98 GHz boost clock (a slower clock only
        # holds longer)
        self.hold_cycles = int(hold_us * 1e-6 * 1.98e9)

    def __call__(self, fn, iters: int = 10, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.hold_cycles)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bf16_ulp(torch, v):
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    mag = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# ----------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def check_gemm(torch, timer, failures):
    from repro_torch.core import precision
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_gemm as G

    Ger = precision.Ger
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    p = SERVE["prompt_len"]
    cases = []
    # The serving path's products: (name, M, K, N, epilogue, out dtype).
    for m in (4, p):
        cases += [
            (f"qkvo M={m}", m, 4096, 4096, None, torch.bfloat16),
            (f"wo+res M={m}", m, 4096, 4096, "residual", torch.bfloat16),
            (f"w1+silu M={m}", m, 4096, 11008, "silu", torch.bfloat16),
            (f"w3 M={m}", m, 4096, 11008, None, torch.bfloat16),
            (f"w2+res M={m}", m, 11008, 4096, "residual", torch.bfloat16),
            (f"logits M={m}", m, 4096, 102400, None, torch.float32),
        ]
    worst = 0.0
    for name, m, k, n, epi, od in cases:
        x = randn(m, k)
        y = randn(k, n, scale=k ** -0.5)
        res = randn(m, n) if epi == "residual" else None
        ep = E.Epilogue(activation="silu") if epi == "silu" else (
            E.Epilogue(residual=True) if epi == "residual" else None)
        kw = dict(kind=Ger.BF16GER2, ep=ep, residual=res, out_dtype=od)
        got = G.mma_gemm(x, y, **kw).float()
        want = G.mma_gemm_plain(x, y, **kw).float()
        worst = max(worst, _report_close(
            torch, f"gemm {name}", got, want, od, failures))
    # The SSD's batched products (models/mamba2.py) at zamba2's widths
    # (H = 64 heads of P = 64, N = 64) and mamba2-130m's (H = 24, N = 128),
    # prefill chunk L = 256, decode batch B = 4: (batch, M, K, N, out).
    b = SERVE["batch"]
    for arch, h, n_st in (("zamba2", 64, 64), ("mamba2", 24, 128)):
        hp = h * 64
        for name, bb, m, k, n, od in (
                ("scores", 1, p, n_st, p, torch.float32),
                ("y_intra", h, p, p, 64, torch.bfloat16),
                ("states", 1, n_st, p, hp, torch.float32),
                ("y_inter", 1, p, n_st, hp, torch.bfloat16),
                ("decode outer K=1", b, n_st, 1, hp, torch.float32),
                ("decode y M=1", b, 1, n_st, hp, torch.bfloat16)):
            x, y = randn(bb, m, k), randn(bb, k, n, scale=k ** -0.5)
            kw = dict(kind=Ger.BF16GER2, out_dtype=od)
            got = G.mma_gemm(x, y, **kw).float()
            want = G.mma_gemm_plain(x, y, **kw).float()
            worst = max(worst, _report_close(
                torch, f"gemm {arch} ssd {name} ({bb},{m},{k})x({bb},{k},{n})",
                got, want, od, failures))

    # Edge cases: ragged fringes, batch, accumulate forms, epilogues, tiles,
    # F32GER and F16GER2.
    edge = []
    x = randn(5, 999)
    edge.append(("ragged M/K, N%8!=0", x, randn(999, 1001, scale=0.03),
                 None, dict(kind=Ger.BF16GER2, out_dtype=torch.float32)))
    edge.append(("batched B=3 77x200x130", randn(3, 77, 200),
                 randn(3, 200, 130, scale=0.07), None,
                 dict(kind=Ger.BF16GER2, out_dtype=torch.float32)))
    edge.append(("seed neg/neg alpha/beta", randn(70, 256),
                 randn(256, 90, scale=0.06),
                 randn(70, 90, dtype=torch.float32),
                 dict(kind=Ger.BF16GER2, neg_product=True, neg_acc=True,
                      alpha=0.5, beta=-2.0, out_dtype=torch.float32)))
    edge.append(("bias+gelu+res tile 128", randn(300, 512),
                 randn(512, 260, scale=0.04), None,
                 dict(kind=Ger.BF16GER2, block=(128, 128, 32),
                      ep=E.Epilogue(bias=True, activation="gelu",
                                    residual=True),
                      bias=randn(260, dtype=torch.float32),
                      residual=randn(300, 260), out_dtype=torch.bfloat16)))
    edge.append(("relu tile 64 f16", randn(130, 384, dtype=torch.float16),
                 randn(384, 200, dtype=torch.float16, scale=0.05), None,
                 dict(kind=Ger.F16GER2, block=(64, 64, 64),
                      ep=E.Epilogue(activation="relu"),
                      out_dtype=torch.float16)))
    edge.append(("F32GER 256x1024x1000", randn(256, 1024,
                                               dtype=torch.float32),
                 randn(1024, 1000, dtype=torch.float32, scale=0.03),
                 randn(256, 1000, dtype=torch.float32),
                 dict(kind=Ger.F32GER, beta=0.5, out_dtype=torch.float32)))
    # the weight stream and the wgmma tile at their own fringes and forms
    edge.append(("seed neg/neg alpha/beta M=40 (stream)", randn(40, 768),
                 randn(768, 520, scale=0.04),
                 randn(40, 520, dtype=torch.float32),
                 dict(kind=Ger.BF16GER2, neg_product=True, neg_acc=True,
                      alpha=0.5, beta=-2.0, out_dtype=torch.float32)))
    edge.append(("bias+gelu+res M=16 (stream)", randn(16, 768),
                 randn(768, 1000, scale=0.04), None,
                 dict(kind=Ger.BF16GER2,
                      ep=E.Epilogue(bias=True, activation="gelu",
                                    residual=True),
                      bias=randn(1000, dtype=torch.float32),
                      residual=randn(16, 1000), out_dtype=torch.bfloat16)))
    edge.append(("f16 silu M=7 (stream)", randn(7, 512, dtype=torch.float16),
                 randn(512, 300, dtype=torch.float16, scale=0.05), None,
                 dict(kind=Ger.F16GER2, ep=E.Epilogue(activation="silu"),
                      out_dtype=torch.float16)))
    edge.append(("seed neg alpha/beta 130x96x72 (wgmma)", randn(130, 96),
                 randn(96, 72, scale=0.1),
                 randn(130, 72, dtype=torch.float32),
                 dict(kind=Ger.BF16GER2, neg_product=True, alpha=-1.5,
                      beta=0.25, out_dtype=torch.float32)))
    edge.append(("batched B=3 77x200x136 (wgmma)", randn(3, 77, 200),
                 randn(3, 200, 136, scale=0.07), None,
                 dict(kind=Ger.BF16GER2, out_dtype=torch.float32)))
    edge.append(("bias+relu+res 257x384x200 f16 (wgmma)",
                 randn(257, 384, dtype=torch.float16),
                 randn(384, 200, dtype=torch.float16, scale=0.05), None,
                 dict(kind=Ger.F16GER2,
                      ep=E.Epilogue(bias=True, activation="relu",
                                    residual=True),
                      bias=randn(200, dtype=torch.float32),
                      residual=randn(257, 200, dtype=torch.float16),
                      out_dtype=torch.float16)))
    for name, xe, ye, ce, kw in edge:
        before = dict(G.mma_gemm.launches_by_path)
        got = G.mma_gemm(xe, ye, ce, **kw).float()
        path = [p for p, n in G.mma_gemm.launches_by_path.items()
                if n != before[p]]
        plain_kw = {k: v for k, v in kw.items() if k != "block"}
        want = G.mma_gemm_plain(xe, ye, ce, **plain_kw).float()
        worst = max(worst, _report_close(
            torch, f"gemm {name} -> {path}", got, want, kw["out_dtype"],
            failures))

    # Timing at the decode MLP's product (M = batch, 4096 -> 11008).
    m, k, n = SERVE["batch"], 4096, 11008
    x, y = randn(m, k), randn(k, n, scale=k ** -0.5)
    kw = dict(kind=Ger.BF16GER2, out_dtype=torch.bfloat16)
    times = {name: timer(fn) for name, fn in (
        ("ms", lambda: G.mma_gemm(x, y, **kw)),
        ("plain_ms", lambda: G.mma_gemm_plain(x, y, **kw)),
        ("library_ms", lambda: torch.matmul(x, y)))}
    b_ms, b_by = bound_ms((m * k + k * n + m * n) * 2, 2 * m * n * k, "bf16")
    print(f"  time gemm {m}x{k}x{n}: kernel {times['ms']:.4f} ms, plain "
          f"{times['plain_ms']:.4f} ms, torch.matmul "
          f"{times['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # Host time of one call at decode M (the weight stream), beside
    # torch.matmul's, and of one at prefill M (the wgmma tile, whose
    # tensor maps are encoded on every call).
    xw, yw = randn(p, 4096), randn(4096, 4096, scale=4096 ** -0.5)
    host = {"mma_gemm decode (stream)": host_us(
                torch, lambda: G.mma_gemm(x, y, **kw)),
            "torch.matmul decode": host_us(torch, lambda: torch.matmul(x, y)),
            "mma_gemm prefill (wgmma)": host_us(
                torch, lambda: G.mma_gemm(xw, yw))}
    print("  host us per call: " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in host.items()))
    return {"name": "mma_gemm", "route": "cuda",
            "source": "src/repro_torch/csrc/gemm_stream.cu, "
                      "src/repro_torch/csrc/gemm_wgmma.cu, "
                      "src/repro_torch/csrc/mma_gemm.cu",
            "replaces": "src/repro/kernels/mma_gemm.py:197",
            "max_abs_err": worst, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"M={m} K={k} N={n} bf16 (stream)", **times,
            "host_us": host}


def host_us(torch, fn, n: int = 200) -> float:
    """Host time of one call (enqueue only), over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _report_close(torch, name, got, want, out_dtype, failures) -> float:
    err = (got - want).abs()
    scale = want.abs().max().item()
    if out_dtype == torch.float32:
        # fp32 sums in another order: rtol 2e-5, atol 2e-5 * max|ref|
        tol = 2e-5 * want.abs() + 2e-5 * scale
        how = "rtol 2e-5 + 2e-5*max|ref|"
    else:
        # one ulp of the 16-bit output, plus fp32 sum-order noise
        ulp = (bf16_ulp(torch, want) if out_dtype == torch.bfloat16
               else bf16_ulp(torch, want) / 8)
        tol = ulp + 1e-4 * scale
        how = "1 ulp + 1e-4*max|ref|"
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    e = err.max().item()
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: max|err| {e:.3e} "
          f"(tol {how}, max|ref| {scale:.3e})")
    if not ok:
        failures.append(name)
    return e


def check_attention(torch, timer, failures):
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_attention as A

    g = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    p = SERVE["prompt_len"]
    cases = [
        (f"prefill causal (1,{p},32,128)", (1, p, 32, 128), (1, p, 32, 128),
         dict(causal=True)),
        ("GQA 32/4 ragged S=200 B=2", (2, 200, 32, 128), (2, 200, 4, 128),
         dict(causal=True)),
        ("window 100 S=300", (1, 300, 8, 128), (1, 300, 8, 128),
         dict(causal=True, window=100)),
        ("q_offset 256 (64 on 320)", (1, 64, 8, 128), (1, 320, 8, 128),
         dict(causal=True, q_offset=256)),
        ("full, no mask, D=64", (2, 96, 4, 64), (2, 130, 4, 64),
         dict(causal=False)),
        (f"zamba2 shared block causal (1,{p},32,64)", (1, p, 32, 64),
         (1, p, 32, 64), dict(causal=True)),
        ("decode GQA 32/8 over 4096 (4,1,32,128)", (4, 1, 32, 128),
         (4, 4096, 8, 128), dict(causal=True, q_offset=4095)),
    ] + [(name, qs, ks, kw) for name, qs, ks, kw in MM_ATTENTION]
    worst = 0.0
    for name, qs, ks, kw in cases:
        q, k, v = randn(*qs), randn(*ks), randn(*ks)
        e, got = check_attn_case(torch, f"attn {name}", q, k, v, kw,
                                 failures)
        worst = max(worst, e)
        if A.split_kv_plan(qs[2], qs[1], ks[1])[0] > 1 and qs[0] > 1:
            one = A.mma_flash_attention(q[:1], k[:1], v[:1], **kw)
            _check(failures, f"attn {name} split row at batch 1",
                   torch.equal(one[0], got[0]),
                   "bit for bit the same row in the batch")
    # valid slots, with fully-masked rows (rows 0-2 see only invalid keys)
    q, k, v = randn(2, 70, 8, 128), randn(2, 70, 2, 128), randn(2, 70, 2, 128)
    valid = torch.ones((2, 70), dtype=torch.bool, device="cuda")
    valid[:, :3] = False
    valid[1, 40:] = False
    e, got = check_attn_case(torch, "attn valid + masked rows", q, k, v,
                             dict(causal=True, valid=valid), failures)
    worst = max(worst, e)
    zero_ok = bool((got[:, :3] == 0).all())
    print(f"  [{'ok' if zero_ok else 'FAIL'}] attn fully-masked rows are "
          f"exact zeros")
    if not zero_ok:
        failures.append("attn masked rows")
    # the epilogue on the normalised output, f32 store
    ep = E.Epilogue(bias=True, activation="silu", residual=True)
    bias = randn(128, dtype=torch.float32)
    res = randn(1, 130, 8, 128)
    q, k, v = randn(1, 130, 8, 128), randn(1, 130, 8, 128), randn(1, 130, 8, 128)
    kw = dict(causal=True, ep=ep, bias=bias, residual=res,
              out_dtype=torch.float32)
    e, _ = check_attn_case(torch, "attn bias+silu+res f32", q, k, v, kw,
                           failures)
    worst = max(worst, e)

    # Timing at the prefill shape.
    q, k, v = randn(1, p, 32, 128), randn(1, p, 32, 128), randn(1, p, 32, 128)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {name: timer(fn) for name, fn in (
        ("ms", lambda: A.mma_flash_attention(q, k, v, causal=True)),
        ("plain_ms", lambda: A.flash_attention_plain(q, k, v, causal=True)),
        ("library_ms", lambda: sdpa(qt, kt, vt, is_causal=True)))}
    pairs = A.attn_live_pairs(p, p, causal=True)
    b_ms, b_by = bound_ms(4 * p * 32 * 128 * 2, 4 * 128 * pairs * 32, "bf16")
    extra = {}   # causal prefill at lengths the runs do not reach
    for s, d in ((1024, 128), (4096, 128)):
        q2, k2, v2 = (randn(1, s, 32, d) for _ in range(3))
        qt2, kt2, vt2 = (t.transpose(1, 2) for t in (q2, k2, v2))
        t = timer(lambda: A.mma_flash_attention(q2, k2, v2, causal=True),
                  iters=5)
        tl = timer(lambda: sdpa(qt2, kt2, vt2, is_causal=True), iters=5)
        bb, by = bound_ms(4 * s * 32 * d * 2,
                          4 * d * A.attn_live_pairs(s, s, causal=True) * 32,
                          "bf16")
        extra[f"S={s} D={d}"] = dict(ms=t, library_ms=tl, bound_ms=bb,
                                     bound_by=by)
        print(f"  time attn causal (1,{s},32,{d}): kernel {t:.4f} ms, "
              f"sdpa {tl:.4f} ms, bound {bb:.4f} ms ({by})")
    print(f"  time attn causal (1,{p},32,128): kernel {times['ms']:.4f} ms, "
          f"plain {times['plain_ms']:.4f} ms, sdpa "
          f"{times['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "mma_flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/mma_attention.cu",
            "tile_kernel": "flash_tile_kernel (persistent blocks, "
                           "ping-ponged wgmma consumers, 128-key steps)",
            "replaces": "src/repro/kernels/mma_attention.py:193",
            "max_abs_err": worst, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"(1,{p},32,128) causal bf16", **times,
            "other_shapes": extra}


def _mm_attention():
    """(name, q shape, k/v shape, flags) at the generation runs' shapes:
    whisper's encoder self attention (non-causal over the frames / 2
    encoder positions, 12 x 64 heads) and its decode cross attention (one
    query over those positions), and qwen2-vl's causal GQA prefill (28
    query heads over 4 kv heads of 128, 1024 vision + text positions)."""
    wb = MM_RUNS["whisper-small"]["batch"]
    enc = MM_RUNS["whisper-small"]["frames"] // 2
    qb = MM_RUNS["qwen2-vl-7b"]["batch"]
    qs = 1024 + MM_RUNS["qwen2-vl-7b"]["text_len"]
    return (
        (f"whisper encoder ({wb},{enc},12,64)", (wb, enc, 12, 64),
         (wb, enc, 12, 64), dict(causal=False)),
        (f"whisper decode cross Sq 1 x Sk {enc}", (wb, 1, 12, 64),
         (wb, enc, 12, 64), dict(causal=False)),
        (f"qwen2-vl prefill GQA 28/4 ({qb},{qs},28,128)", (qb, qs, 28, 128),
         (qb, qs, 4, 128), dict(causal=True)),
    )


MM_ATTENTION = _mm_attention()


def check_attn_case(torch, name, q, k, v, kw, failures):
    """One attention call against flash_attention_plain and, where it
    splits KV, against flash_attention_splitkv_plain too, each output
    within 2^-7 * max|v| and within its rounding budget (_report_attn);
    (max|err|, the kernel's output)."""
    from repro_torch.kernels import mma_attention as A

    got = A.mma_flash_attention(q, k, v, **kw)
    out_dtype = kw.get("out_dtype") or q.dtype
    budget = A.rounding_budget(q, k, v, **{
        f: kw[f] for f in ("causal", "q_offset", "window", "valid", "ep")
        if f in kw})
    want = A.flash_attention_plain(q, k, v, **kw)
    e = _report_attn(torch, name, got, want, v, budget, out_dtype,
                     failures)
    n_split, per = A.split_kv_plan(q.shape[2], q.shape[1], k.shape[1])
    if n_split > 1:
        want = A.flash_attention_splitkv_plain(q, k, v, n_split=n_split,
                                               per=per, **kw)
        e = max(e, _report_attn(
            torch, f"{name} vs split-KV plain ({n_split} x {per} blocks)",
            got, want, v, budget, out_dtype, failures))
    return e, got


def _report_attn(torch, name, got, want, v, budget, out_dtype, failures):
    # Two bounds, both must hold.  The kernel rounds the unnormalised P to
    # bf16 block by block, the plain version the normalised P once: each
    # weight differs by up to a bf16 half-ulp either way, so |err| <=
    # 2^-7 * max|v| per output, plus one ulp of a 16-bit store.  Tighter,
    # per output: its own rounding budget (mma_attention.rounding_budget:
    # 2u * sum p|v| and fp32 slack), plus one ulp of a 16-bit store at
    # |ref| and 2^-20 * max|ref| for the epilogue's fp32 arithmetic in
    # another order.
    got, want = got.float(), want.float()
    err = (got - want).abs()
    old = 2.0 ** -7 * v.float().abs().max() + bf16_ulp(torch, want)
    tol = budget + 2.0 ** -20 * want.abs().max()
    if out_dtype != torch.float32:
        tol = tol + (bf16_ulp(torch, want) if out_dtype == torch.bfloat16
                     else bf16_ulp(torch, want) / 8)
    ok = (bool(torch.isfinite(got).all()) and bool((err <= tol).all())
          and bool((err <= old).all()))
    e = err.max().item()
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: max|err| {e:.3e}, "
          f"max err/tol {(err / tol).max().item():.3f} (tol rounding "
          f"budget + 1 ulp, max budget {budget.max().item():.3e}); max "
          f"err/tol {(err / old).max().item():.3f} (tol 2^-7*max|v| + 1 "
          f"bf16 ulp)")
    if not ok:
        failures.append(name)
    return e


def _path_taken(wrapper, before) -> str:
    """The path(s) a wrapper's launches took since ``before`` (a copy of
    its ``launches_by_path``)."""
    return ",".join(p for p, n in wrapper.launches_by_path.items()
                    if n > before[p])


def check_depthwise_conv(torch, timer, failures):
    """K4 against its plain version: mamba2's causal conv at zamba2's and
    mamba2-130m's widths (conv_dim 4224 and 1792; prefill over the 256 + 3
    padded frames, decode over the 3-frame history + 1), then edge cases:
    strides, 2-D taps, a C that no vector width divides, bf16/f16 inputs
    and every epilogue."""
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K

    g = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    p, b = SERVE["prompt_len"], SERVE["batch"]
    silu = E.Epilogue(bias=True, activation="silu")
    # (name, image NHWC, KH, KW, stride, in dtype, epilogue, out dtype)
    cases = []
    for arch, c in (("zamba2", 4224), ("mamba2-130m", 1792)):
        cases += [(f"{arch} prefill", (1, 1, p + 3, c), 1, 4, (1, 1),
                   torch.float32, silu, torch.bfloat16),
                  (f"{arch} decode", (b, 1, 4, c), 1, 4, (1, 1),
                   torch.float32, silu, torch.bfloat16)]
    cases += [
        ("stride (2,3) 3x5 C=130 none f32", (2, 9, 37, 130), 3, 5, (2, 3),
         torch.float32, None, torch.float32),
        ("stride (1,2) C=77 bias bf16-in", (3, 1, 50, 77), 1, 4, (1, 2),
         torch.bfloat16, E.Epilogue(bias=True), torch.float32),
        ("2x3 C=33 bias+gelu f16", (2, 5, 20, 33), 2, 3, (1, 1),
         torch.float16, E.Epilogue(bias=True, activation="gelu"),
         torch.float16),
        ("C=4227 residual f32", (2, 1, 30, 4227), 1, 4, (1, 1),
         torch.float32, E.Epilogue(residual=True), torch.float32),
        ("C=131 bias+relu+res bf16", (2, 3, 11, 131), 2, 2, (1, 1),
         torch.bfloat16, E.Epilogue(bias=True, activation="relu",
                                    residual=True), torch.bfloat16),
    ]
    worst = 0.0
    for name, shape, kh, kw, stride, idt, ep, od in cases:
        n, h, w, c = shape
        oh, ow = (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
        x = randn(*shape, dtype=idt)
        taps = randn(kh, kw, c, dtype=idt, scale=0.3)
        bias = randn(c) if ep is not None and ep.bias else None
        res = randn(n, oh, ow, c) if ep is not None and ep.residual else None
        kw_ = dict(stride=stride, out_dtype=od, ep=ep, bias=bias,
                   residual=res)
        before = dict(K.mma_depthwise_conv2d.launches_by_path)
        got = K.mma_depthwise_conv2d(x, taps, **kw_).float()
        want = K.mma_depthwise_conv2d_plain(x, taps, **kw_).float()
        taken = _path_taken(K.mma_depthwise_conv2d, before)
        worst = max(worst, _report_close(
            torch, f"depthwise {name} [{taken}]", got, want, od, failures))
    # Bit for bit at the main path's four shapes with no epilogue and an
    # f32 store: the same products and sums, each rounded on its own, in
    # the plain version's order.
    for name, shape, kh, kw, *_ in cases[:4]:
        x = randn(*shape)
        taps = randn(kh, kw, shape[-1], scale=0.3)
        before = dict(K.mma_depthwise_conv2d.launches_by_path)
        same = torch.equal(K.mma_depthwise_conv2d(x, taps),
                           K.mma_depthwise_conv2d_plain(x, taps))
        print(f"  [{'ok' if same else 'FAIL'}] depthwise {name} {shape} "
              f"[{_path_taken(K.mma_depthwise_conv2d, before)}], no "
              f"epilogue, f32 store: bit for bit equal to the plain version")
        if not same:
            failures.append(f"depthwise {name} not bit for bit")

    # Timing at zamba2's prefill conv: f32 frames (the F32GER policy cast)
    # in, bias + silu, bf16 out.  The library yardstick is cuDNN's
    # depthwise conv1d with bias (one call; silu is not part of it).
    c = 4224
    x = randn(1, 1, p + 3, c)
    taps, bias = randn(1, 4, c, scale=0.3), randn(c)
    kw_ = dict(out_dtype=torch.bfloat16, ep=silu, bias=bias)
    xc = x[:, 0].transpose(1, 2).contiguous()              # (N, C, L + 3)
    wc = taps[0].t().contiguous()[:, None]                  # (C, 1, 4)
    conv1d = torch.nn.functional.conv1d
    times = {name: timer(fn) for name, fn in (
        ("ms", lambda: K.mma_depthwise_conv2d(x, taps, **kw_)),
        ("plain_ms", lambda: K.mma_depthwise_conv2d_plain(x, taps, **kw_)),
        ("library_ms", lambda: conv1d(xc, wc, bias, groups=c)))}
    nbytes = x.numel() * 4 + taps.numel() * 4 + c * 4 + p * c * 2
    b_ms, b_by = bound_ms(nbytes, 2 * p * c * 4 + 4 * p * c, "f32")
    extra = {}
    for name, shape in (("zamba2 decode", (b, 1, 4, c)),
                        ("mamba2-130m prefill", (1, 1, p + 3, 1792)),
                        ("mamba2-130m decode", (b, 1, 4, 1792))):
        cc = shape[-1]
        x2, t2, b2 = randn(*shape), randn(1, 4, cc, scale=0.3), randn(cc)
        xc2 = x2[:, 0].transpose(1, 2).contiguous()
        wc2 = t2[0].t().contiguous()[:, None]
        kw2 = dict(out_dtype=torch.bfloat16, ep=silu, bias=b2)
        t = timer(lambda: K.mma_depthwise_conv2d(x2, t2, **kw2))
        tp = timer(lambda: K.mma_depthwise_conv2d_plain(x2, t2, **kw2))
        tl = timer(lambda: conv1d(xc2, wc2, b2, groups=cc))
        lo = shape[2] - 3
        bb, by = bound_ms(x2.numel() * 4 + t2.numel() * 4 + cc * 4
                          + shape[0] * lo * cc * 2,
                          shape[0] * lo * cc * 12, "f32")
        extra[name] = dict(ms=t, plain_ms=tp, library_ms=tl, bound_ms=bb,
                           bound_by=by)
        print(f"  time depthwise {name} {shape}: kernel {t:.4f} ms, plain "
              f"{tp:.4f} ms, cuDNN conv1d {tl:.4f} ms, bound {bb:.4f} ms "
              f"({by})")
    print(f"  time depthwise zamba2 prefill (1,1,{p + 3},{c}): kernel "
          f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, cuDNN "
          f"conv1d {times['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    return {"name": "mma_depthwise_conv2d", "route": "cuda",
            "source": "src/repro_torch/csrc/mma_conv.cu",
            "replaces": "src/repro/kernels/mma_conv.py:242",
            "max_abs_err": worst, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"(1,1,{p + 3},{c}) x (1,4,{c}) f32 bias+silu -> bf16",
            **times, "other_shapes": extra}


def _report_conv(torch, name, got, want, out_dtype, failures) -> float:
    # The kernel sums its fp32 products in another order than the plain
    # version's single fp32 matmul: a 16-bit store is within one ulp of the
    # output dtype at |ref|, plus 1e-5*max|ref| where that sum-order noise
    # exceeds the tiny ulp of an output near zero; an f32 store within
    # 1e-4*max|ref|.
    err = (got - want).abs()
    scale = want.abs().max().item()
    if out_dtype == torch.float32:
        tol = torch.full_like(want, 1e-4 * scale)
        how = "1e-4*max|ref|"
    else:
        bits = 7 if out_dtype == torch.bfloat16 else 10
        mag = want.abs().clamp_min(torch.finfo(torch.float32).tiny)
        tol = torch.exp2(torch.floor(torch.log2(mag)) - bits) + 1e-5 * scale
        how = "1 ulp of the output dtype + 1e-5*max|ref|"
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    e = err.max().item()
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: max|err| {e:.3e} "
          f"(tol {how}, max|ref| {scale:.3e})")
    if not ok:
        failures.append(name)
    return e


def check_conv2d(torch, timer, failures):
    """K3 against its plain version: the main path's three stems at their
    full shapes (whisper's conv1 and conv2 over 4 clips of 3000 mel
    frames, SAME-padded, bias + gelu; qwen2-vl's 14 x 14 stride-14 patch
    embed over 4 images of 448 x 448, bias), then edge cases: ragged F and
    OW, K fringes, a 3 x 3 stride-1 2-D conv, a residual epilogue, f16
    inputs, f32 (F32GER) inputs and a filter bank narrower than the
    tile; and times the three stems beside the plain version, one cuDNN
    conv2d on the same operands (channels-last, TF32 off) and the bound."""
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K

    g = torch.Generator(device="cuda").manual_seed(7)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    gelu = E.Epilogue(bias=True, activation="gelu")
    bias_only = E.Epilogue(bias=True)
    b, fr = MM_RUNS["whisper-small"]["batch"], MM_RUNS["whisper-small"][
        "frames"]
    qb = MM_RUNS["qwen2-vl-7b"]["batch"]
    # (name, image NHWC, filters HWIO, stride, in dtype, epilogue, out
    # dtype)
    path = [
        ("whisper conv1", (b, 1, fr + 2, 80), (1, 3, 80, 768), (1, 1), bf16,
         gelu, bf16),
        ("whisper conv2", (b, 1, fr + 1, 768), (1, 3, 768, 768), (1, 2),
         bf16, gelu, bf16),
        ("qwen2-vl patch embed", (qb, 448, 448, 3), (14, 14, 3, 3584),
         (14, 14), bf16, bias_only, bf16),
    ]
    edge = [
        ("ragged F=200 OW=37", (2, 1, 39, 64), (1, 3, 64, 200), (1, 1),
         bf16, gelu, bf16),
        ("K fringe C=3 5x5 stride 3, f32 out", (2, 31, 29, 3),
         (5, 5, 3, 100), (3, 3), bf16, bias_only, f32),
        ("3x3 stride 1 2-D + residual", (2, 20, 17, 32), (3, 3, 32, 96),
         (1, 1), bf16, E.Epilogue(residual=True), bf16),
        ("f16 inputs 2x2 stride 2 bias+relu", (2, 12, 12, 24),
         (2, 2, 24, 130), (2, 2), f16,
         E.Epilogue(bias=True, activation="relu"), f16),
        ("F32GER f32 inputs stride (1,2) bias+gelu+res", (2, 1, 300, 80),
         (1, 3, 80, 144), (1, 2), f32,
         E.Epilogue(bias=True, activation="gelu", residual=True), f32),
        ("F=64 C=5 scalar gather", (3, 1, 50, 5), (1, 4, 5, 64),
         (1, 1), bf16, None, bf16),
    ]
    worst = 0.0
    operands = {}
    for i, (name, shape, fshape, stride, idt, ep, od) in enumerate(
            path + edge):
        n, h, w, c = shape
        kh, kw, _, f = fshape
        oh, ow = (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
        x = randn(*shape, dtype=idt)
        filt = randn(*fshape, dtype=idt, scale=(kh * kw * c) ** -0.5)
        bias = randn(f, dtype=f32) if ep is not None and ep.bias else None
        res = (randn(n, oh, ow, f, dtype=od)
               if ep is not None and ep.residual else None)
        kw_ = dict(stride=stride, out_dtype=od, ep=ep, bias=bias,
                   residual=res)
        before = dict(K.mma_conv2d.launches_by_path)
        got = K.mma_conv2d(x, filt, **kw_)
        taken = _path_taken(K.mma_conv2d, before)
        want = K.mma_conv2d_plain(x, filt, **kw_).float()
        worst = max(worst, _report_conv(
            torch, f"conv2d {name} {shape}x{fshape} s{stride} [{taken}]",
            got.float(), want, od, failures))
        if i < len(path):
            # A gathered panel read before it landed shows as a difference
            # between launches.
            same = all(torch.equal(K.mma_conv2d(x, filt, **kw_), got)
                       for _ in range(2))
            print(f"  [{'ok' if same else 'FAIL'}] conv2d {name}: three "
                  f"launches give the same bits")
            if not same:
                failures.append(f"conv2d {name} differs between launches")
        operands[name] = (x, filt, bias, kw_, od)

    def stem_times(name):
        x, filt, bias, kw_, od = operands[name]
        xc = x.permute(0, 3, 1, 2)                 # NCHW, channels-last
        wc = filt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = bias.to(x.dtype)
        conv2d = torch.nn.functional.conv2d
        times = {key: timer(fn, iters=5) for key, fn in (
            ("ms", lambda: K.mma_conv2d(x, filt, **kw_)),
            ("plain_ms", lambda: K.mma_conv2d_plain(x, filt, **kw_)),
            ("library_ms", lambda: conv2d(xc, wc, bc, stride=kw_["stride"])))}
        n, h, w, c = x.shape
        kh, kw, _, f = filt.shape
        m = n * ((h - kh) // kw_["stride"][0] + 1) * (
            (w - kw) // kw_["stride"][1] + 1)
        nbytes = (x.numel() * x.element_size() + filt.numel()
                  * filt.element_size() + f * 4 + m * f * od.itemsize)
        bb, by = bound_ms(nbytes, 2 * m * kh * kw * c * f, "bf16")
        print(f"  time conv2d {name} {tuple(x.shape)}x{tuple(filt.shape)}: "
              f"kernel {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} "
              f"ms, cuDNN conv2d {times['library_ms']:.4f} ms, bound "
              f"{bb:.4f} ms ({by})")
        return dict(times, bound_ms=bb, bound_by=by)

    main = stem_times("whisper conv2")
    extra = {name: stem_times(name) for name in ("whisper conv1",
                                                 "qwen2-vl patch embed")}
    return {"name": "mma_conv2d", "route": "cuda",
            "source": "src/repro_torch/csrc/mma_conv.cu",
            "replaces": "src/repro/kernels/mma_conv.py:110",
            "max_abs_err": worst, **main,
            "shape": f"({b},1,{fr + 1},768) x (1,3,768,768) stride (1,2) "
                     f"bf16, bias+gelu -> bf16",
            "other_shapes": extra}


# ----------------------------------------------------------------------
# Phase 3: serve
# ----------------------------------------------------------------------

def expected_launches(cfg) -> dict:
    """Kernel launches per prefill and per decode step, from the code:
    dense layers run 4 attention GEMMs (q, k, v, o; in decode the new k/v
    projections take the place of apply_attention's) and 3 MLP GEMMs (2
    for whisper's plain MLP), and one flash attention in prefill only
    (decode attends over the ring on the eager path); qwen2-vl adds the
    vision projection GEMM and one dense conv (the patch embed) per
    prefill; whisper's 12 encoder layers add 6 GEMMs and one attention
    each and its stem two dense convs per prefill, and each decoder layer
    adds cross-attention's q and o GEMMs (its k and v in prefill) and one
    flash attention over the encoder positions, in prefill and in every
    decode step; mamba2 layers run in_proj, the four SSD products and
    out_proj in prefill, in_proj, the two decode products and out_proj in
    a decode step, and one depthwise conv in each; zamba2's shared block
    runs 8 GEMMs (in_proj, q, k, v, o, w1, w3, w2) after each group of
    ``shared_attn_every`` layers, and one flash attention in prefill only;
    the moe kind's leading dense layers run a dense layer's GEMMs, and
    each MoE layer 4 attention GEMMs, the router, the expert banks (w1,
    w3, w2: one batched product each) and the shared experts' MLP;
    plus the logits GEMM."""
    n = cfg.num_layers
    block = 4 + (3 if cfg.gated_mlp else 2)
    if cfg.family == "moe":
        fd = cfg.first_dense_layers
        mlp = 3 if cfg.gated_mlp else 2
        per_moe = 4 + 1 + mlp + (mlp if cfg.num_shared_experts else 0)
        gemm = block * fd + per_moe * (n - fd) + 1
        return {"prefill": {"mma_gemm": gemm, "mma_flash_attention": n},
                "decode": {"mma_gemm": gemm}}
    if cfg.family in ("dense", "vlm"):
        prefill = {"mma_gemm": block * n + 1, "mma_flash_attention": n}
        if cfg.vision_prefix:
            prefill["mma_gemm"] += 1
            prefill["mma_conv2d"] = 1
        return {"prefill": prefill, "decode": {"mma_gemm": block * n + 1}}
    if cfg.family == "audio":
        e = cfg.encoder_layers
        return {"prefill": {"mma_gemm": block * e + (block + 4) * n + 1,
                            "mma_flash_attention": e + 2 * n,
                            "mma_conv2d": 2},
                "decode": {"mma_gemm": (block + 2) * n + 1,
                           "mma_flash_attention": n}}
    groups = -(-n // cfg.shared_attn_every) if cfg.shared_attn_every else 0
    prefill = {"mma_gemm": 6 * n + 8 * groups + 1,
               "mma_depthwise_conv2d": n}
    if groups:
        prefill["mma_flash_attention"] = groups
    return {"prefill": prefill,
            "decode": {"mma_gemm": 4 * n + 8 * groups + 1,
                       "mma_depthwise_conv2d": n}}


def kernel_wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G
    return {"mma_gemm": G.mma_gemm,
            "mma_flash_attention": A.mma_flash_attention,
            "mma_depthwise_conv2d": K.mma_depthwise_conv2d,
            "mma_conv2d": K.mma_conv2d}


# Per run: the GEMM's launches by path, and the distinct shapes the run
# gave the GEMM, the attention kernel and the depthwise conv (their
# wrappers' traces).
RECORDS: dict[str, dict] = {}


# The kernels whose wrappers count their launches by path.
BY_PATH = ("mma_gemm", "mma_conv2d", "mma_depthwise_conv2d")


def reset_counts(kernels):
    """Zero every launch count, and start the GEMM's, attention's and
    depthwise conv's traces, just before a run."""
    for fn in kernels.values():
        fn.launches = 0
    for name in BY_PATH:
        kernels[name].launches_by_path = dict.fromkeys(
            kernels[name].launches_by_path, 0)
    for name in TRACED:
        kernels[name].trace = []


# The kernels whose wrappers record the shapes they launch at.
TRACED = ("mma_gemm", "mma_flash_attention", "mma_depthwise_conv2d")


def take_records(arch, kernels):
    """Read the run's launches by path and shapes, just after it, and stop
    tracing."""
    RECORDS[arch] = {"by_path": {name: dict(kernels[name].launches_by_path)
                                 for name in BY_PATH}}
    for key, name in zip(("gemm", "attn", "dw"), TRACED):
        RECORDS[arch][key] = sorted(set(kernels[name].trace), key=str)
        kernels[name].trace = None


def check_main_paths(failures):
    """Every decode product (M = batch) with K >= 768 on the weight stream,
    every expert-bank product of deepseek-moe-16b (b = E experts of M <=
    64 capacity slots, in prefill and in decode) on the weight stream,
    every other prefill product of deepseek-7b, qwen2-vl-7b and
    deepseek-moe-16b on the wgmma tile, every one-query attention
    (whisper's decode cross-attention) on split-KV, every dense conv
    (whisper's and qwen2-vl's stems) on K3's wgmma kernel and every
    depthwise conv (mamba2's) on K4's vector path."""
    for arch, rec in RECORDS.items():
        bad = []
        for name, path in (("mma_conv2d", "wgmma"),
                           ("mma_depthwise_conv2d", "vector")):
            off = {p: v for p, v in rec["by_path"][name].items()
                   if p != path and v}
            if off:
                bad.append((name, off))
        banks = arch == MOE_RUN[0]
        for b, m, k, n, _, _, path in rec["gemm"]:
            if b == 1 and m <= 16 and k >= 768 and path != "stream":
                bad.append((m, k, n, path))
            if banks and b > 1 and path != "stream":
                bad.append((b, m, k, n, path))
            if (arch in ("deepseek-7b", "qwen2-vl-7b", MOE_RUN[0])
                    and b == 1 and m > 64 and path != "wgmma"):
                bad.append((m, k, n, path))
        if banks and not any(b > 1 for b, *_ in rec["gemm"]):
            bad.append("no expert-bank product")
        for shape in rec["attn"]:
            if shape[1] == 1 and shape[-1] < 2:
                bad.append(("attention", shape))
        print(f"  [{'ok' if not bad else 'FAIL'}] {arch}: launches by "
              f"path {rec['by_path']}; {len(rec['gemm'])} GEMM and "
              f"{len(rec['attn'])} attention shapes on the expected paths"
              + (f"; off path: {bad}" if bad else ""))
        if bad:
            failures.append(f"{arch} products off their path: {bad}")


# The split-KV decode kernel (flash_decode_kernel) at whisper-small's bf16
# generation shapes: (B, Sq, H, D, Sk) -> (the parent kernel's time in
# PERF.md (NVIDIA H100 80GB HBM3 at 700 W: printed for the reader, never
# put in the kernels line), the aim: ("ms", t) or ("sdpa", a factor of
# SDPA's time in the same run)).
SPLIT_AIMS = {
    (4, 1, 12, 64, 1500): (0.0310, ("sdpa", 1.0)),
    (4, 4, 12, 64, 1500): (0.0313, ("ms", 0.0313)),
}


def time_run_shapes(torch, entries, failures, runs):
    """Each distinct GEMM, attention and depthwise conv shape that the runs
    ``runs`` (keys of RECORDS) gave the kernels: the kernel held against
    its plain version at that shape (the GEMM and the depthwise conv at
    _report_close's tolerance, attention within its rounding budget,
    split-KV also against its own plain version), then its time, its
    path, the library call's time and the bound.  A shape an earlier call
    held and timed only gains the runs' names."""
    from repro_torch.core import precision
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kind = {torch.bfloat16: "bf16", torch.float16: "f16",
            torch.float32: "f32"}
    ger = {torch.bfloat16: precision.Ger.BF16GER2,
           torch.float16: precision.Ger.F16GER2,
           torch.float32: precision.Ger.F32GER}
    shapes = {"gemm": {}, "attn": {}, "dw": {}}
    for arch in runs:
        for what, found in shapes.items():
            for s in RECORDS[arch][what]:
                found.setdefault(s, []).append(arch)
    by_name = {e["name"]: e for e in entries}
    done = {name: by_name[name].setdefault("run_shapes", {}) for name in
            ("mma_gemm", "mma_flash_attention", "mma_depthwise_conv2d")}
    errs = dict.fromkeys(done, 0.0)

    def seen(name, key, archs):
        if key in done[name]:
            done[name][key]["runs"] += archs
            return True
        return False

    gemm_out = done["mma_gemm"]
    for (b, m, k, n, dt, od, path), archs in sorted(shapes["gemm"].items(),
                                                    key=str):
        key = f"{b}x{m}x{k}x{n} {str(dt)[6:]} -> {str(od)[6:]}"
        if seen("mma_gemm", key, archs):
            continue
        lead = (b,) if b > 1 else ()
        x = torch.randn(lead + (m, k), generator=g, device="cuda").to(dt)
        y = (torch.randn(lead + (k, n), generator=g, device="cuda")
             * k ** -0.5).to(dt)
        kw = dict(kind=ger[dt], out_dtype=od)
        errs["mma_gemm"] = max(errs["mma_gemm"], _report_close(
            torch, f"gemm {key} [{path}]", G.mma_gemm(x, y, **kw).float(),
            G.mma_gemm_plain(x, y, **kw).float(), od, failures))
        t = timer(lambda: G.mma_gemm(x, y, **kw), iters=5)
        tl = timer(lambda: torch.matmul(x, y), iters=5)
        bb, by = bound_ms(b * ((m * k + k * n) * dt.itemsize
                               + m * n * od.itemsize),
                          2 * b * m * n * k, kind[dt])
        gemm_out[key] = dict(path=path, ms=t, library_ms=tl, bound_ms=bb,
                             bound_by=by, runs=archs)
        print(f"  time gemm {key} [{path}] ({', '.join(archs)}): kernel "
              f"{t:.4f} ms, torch.matmul {tl:.4f} ms, bound {bb:.4f} ms "
              f"({by}), {bb / t:.2f} of bound")
        del x, y
    attn_out = done["mma_flash_attention"]
    for shape, archs in sorted(shapes["attn"].items(), key=str):
        b, sq, sk, h, kvh, d, dt, causal, q_off, window, has_valid, ns = shape
        key = (f"({b},{sq},{h},{d}) over ({sk},{kvh}) causal={causal} "
               f"q_offset={q_off} window={window} valid={has_valid}")
        if seen("mma_flash_attention", key, archs):
            continue
        q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dt)
        k = torch.randn((b, sk, kvh, d), generator=g, device="cuda").to(dt)
        v = torch.randn((b, sk, kvh, d), generator=g, device="cuda").to(dt)
        valid = (torch.ones((b, sk), dtype=torch.bool, device="cuda")
                 if has_valid else None)
        kw = dict(causal=causal, q_offset=q_off, window=window, valid=valid)
        e, _ = check_attn_case(torch, f"attn {key}", q, k, v, kw, failures)
        errs["mma_flash_attention"] = max(errs["mma_flash_attention"], e)
        t = timer(lambda: A.mma_flash_attention(q, k, v, **kw), iters=5)
        qt, kt, vt = (z.transpose(1, 2) for z in (
            q, k.repeat_interleave(h // kvh, 2),
            v.repeat_interleave(h // kvh, 2)))
        # SDPA's flash path where is_causal says it all, else its mask
        mask, is_causal = None, causal and q_off == 0 and sq == sk \
            and window is None
        if (causal or window is not None) and not is_causal:
            qp = torch.arange(sq, device="cuda")[:, None] + q_off
            kp = torch.arange(sk, device="cuda")[None, :]
            mask = torch.ones((sq, sk), dtype=torch.bool, device="cuda")
            if causal:
                mask &= qp >= kp
            if window is not None:
                mask &= qp - kp < window
        tl = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                is_causal=is_causal), iters=5)
        pairs = A.attn_live_pairs(sq, sk, causal=causal, q_offset=q_off,
                                  window=window)
        bb, by = bound_ms(2 * (2 * b * sq * h * d + 2 * b * sk * kvh * d),
                          4 * d * b * h * pairs, kind[dt])
        attn_out[key] = dict(path="split-kv" if ns > 1 else "tile", ms=t,
                             library_ms=tl, bound_ms=bb, bound_by=by,
                             runs=archs)
        goal = ""
        aim = SPLIT_AIMS.get((b, sq, h, d, sk)) if dt != torch.float32 \
            else None
        if aim is not None:
            parent, (how, x) = aim
            limit = x if how == "ms" else x * tl
            attn_out[key]["aim_met"] = t <= limit
            goal = (f"; parent in PERF.md {parent} ms, aim "
                    f"{'met' if t <= limit else 'MISSED'} "
                    f"(<= {limit:.4f} ms)")
        print(f"  time attn {key} [{attn_out[key]['path']}] "
              f"({', '.join(archs)}): kernel {t:.4f} ms, sdpa {tl:.4f} ms, "
              f"bound {bb:.4f} ms ({by}), {bb / t:.2f} of bound{goal}")
    dw_out = done["mma_depthwise_conv2d"]
    for shape, archs in sorted(shapes["dw"].items(), key=str):
        (n, h, w, c), (kh, kw_), stride, dt, od, act, has_b, has_r, path = \
            shape
        oh, ow = (h - kh) // stride[0] + 1, (w - kw_) // stride[1] + 1
        key = (f"({n},{h},{w},{c}) x ({kh},{kw_}) stride {stride} "
               f"{str(dt)[6:]} -> {str(od)[6:]} bias={has_b} act={act} "
               f"residual={has_r}")
        if seen("mma_depthwise_conv2d", key, archs):
            continue
        x = torch.randn((n, h, w, c), generator=g, device="cuda").to(dt)
        taps = (torch.randn((kh, kw_, c), generator=g, device="cuda")
                * 0.3).to(dt)
        bias = (torch.randn((c,), generator=g, device="cuda")
                if has_b else None)
        res = (torch.randn((n, oh, ow, c), generator=g, device="cuda")
               if has_r else None)
        ep = (E.Epilogue(bias=has_b, activation=act, residual=has_r)
              if has_b or act or has_r else None)
        kw = dict(stride=stride, out_dtype=od, ep=ep, bias=bias,
                  residual=res)
        errs["mma_depthwise_conv2d"] = max(
            errs["mma_depthwise_conv2d"], _report_close(
                torch, f"depthwise {key} [{path}]",
                K.mma_depthwise_conv2d(x, taps, **kw).float(),
                K.mma_depthwise_conv2d_plain(x, taps, **kw).float(), od,
                failures))
        t = timer(lambda: K.mma_depthwise_conv2d(x, taps, **kw), iters=5)
        tp = timer(lambda: K.mma_depthwise_conv2d_plain(x, taps, **kw),
                   iters=5)
        # cuDNN's grouped conv2d with bias (the activation and residual
        # are not part of it)
        xc = x.permute(0, 3, 1, 2).contiguous()
        wc = taps.permute(2, 0, 1)[:, None].contiguous()
        tl = timer(lambda: torch.nn.functional.conv2d(
            xc, wc, None if bias is None else bias.to(dt), stride=stride,
            groups=c), iters=5)
        outs = n * oh * ow * c
        bb, by = bound_ms(x.numel() * dt.itemsize + taps.numel()
                          * dt.itemsize + (c * 4 if has_b else 0)
                          + (outs * 4 if has_r else 0) + outs * od.itemsize,
                          2 * outs * kh * kw_ + (4 * outs if act else 0),
                          "f32")
        dw_out[key] = dict(path=path, ms=t, plain_ms=tp, library_ms=tl,
                           bound_ms=bb, bound_by=by, runs=archs)
        print(f"  time depthwise {key} [{path}] ({', '.join(archs)}): "
              f"kernel {t:.4f} ms, plain {tp:.4f} ms, cuDNN conv2d "
              f"{tl:.4f} ms, bound {bb:.4f} ms ({by}), {bb / t:.2f} of "
              f"bound")
    for name, e in errs.items():
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], e)
    del timer


def serve(torch, failures, arch, settings, num_layers=None, record=None):
    """Serve ``arch`` with random bf16 weights from seed 0 through
    ``serve_loop``, every kernel's launch count reset just before and read
    just after (and every step's outputs recorded into the list
    ``record``, where one is given); then the served model's prefill and
    decode logits on the kernel backend against the eager torch
    backend."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M

    cfg = get_arch(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
        print(f"  depth cut: num_layers {num_layers} (of "
              f"{get_arch(arch).num_layers}); widths unchanged")
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nparam = sum(t.numel() for t in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, ssm "
          f"state {cfg.ssm_state}, vocab {cfg.vocab_size}: "
          f"{nparam / 1e9:.3f} B params (projections bf16), init "
          f"{time.perf_counter() - t0:.1f} s")
    want = expected_launches(cfg)
    kernels = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    with facility.configure(facility.FacilityConfig(device="cuda")), \
            (recording_steps(record) if record is not None
             else contextlib.nullcontext()):
        reset_counts(kernels)
        stats = S.serve_loop(cfg, model, **settings)
        launches = {name: fn.launches for name, fn in kernels.items()}
        take_records(arch, kernels)
    print(f"  serve {settings}: {json.dumps(stats)}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches in the serving run: {launches}")
    print(f"  expected per prefill: {want['prefill']}; per decode step: "
          f"{want['decode']}")
    # The counts follow from the calls: every request is one prefill and
    # every step of the loop one decode step (serve_loop's own counts).
    pre, steps = stats["completed"], stats["steps"]
    model_counts = {k: pre * want["prefill"].get(k, 0)
                    + steps * want["decode"].get(k, 0) for k in kernels}
    print(f"  {pre} prefills + {steps} decode steps give {model_counts}: "
          f"{'matches' if model_counts == launches else 'DIFFERS FROM'} the "
          f"counts")
    if model_counts != launches:
        failures.append(f"{arch} launch counts {launches} differ from the "
                        f"per-call model {model_counts}")
    for name in want["prefill"]:
        if launches[name] <= 0:
            failures.append(f"{name} never launched while serving {arch}")
    if stats["completed"] != settings["n_requests"]:
        failures.append(f"served {stats['completed']} of "
                        f"{settings['n_requests']} {arch} requests")

    # The served model's output against the eager torch backend: a prompt
    # through prefill, then one decode step.  The bound is the larger of
    # 2e-2 and twice the model's own bf16 noise (the torch backend's bf16
    # logits against its F32GER/f32 ones): rounding flips compound over
    # the layers, and a wrong kernel gives a relative L2 of ~1.
    g = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, 64), generator=g,
                           device="cuda", dtype=torch.int32)
    modes = {"kernel": dict(backend="kernel"), "torch": dict(backend="torch"),
             "f32": dict(backend="torch", ger=facility.Ger.F32GER,
                         out_dtype=torch.float32)}
    outs, routes = {}, {}
    for mode, kw in modes.items():
        with facility.configure(facility.FacilityConfig(device="cuda", **kw)), \
                recording_routes(routes.setdefault(mode, [])):
            last, _ = M.prefill(model, {"tokens": prompt}, cfg)
            cache = M.init_cache(cfg, 2, 64, device="cuda",
                                 dtype=kw.get("out_dtype", torch.bfloat16))
            step, _ = M.decode_step(model, cache, prompt[:, :1].expand(2, 1),
                                    cfg)
        outs[mode] = (last.float(), step[:, -1].float())

    check_logits(torch, failures, arch, cfg, outs)
    if routes["kernel"]:
        print_routing(arch, routes)
    if cfg.family == "ssm":
        check_handoff(torch, failures, model, cfg, prompt)
    return stats, launches, (model, cfg)


@contextlib.contextmanager
def recording_routes(into):
    """Append each MoE layer's top-k expert ids (``models.moe.route``'s
    third output, (T, k)) to the list ``into`` while the block runs."""
    from repro_torch.models import moe as MOE

    real = MOE.route

    def route(p, xf, cfg):
        out = real(p, xf, cfg)
        into.append(out[2])
        return out

    MOE.route = route
    try:
        yield
    finally:
        MOE.route = real


def print_routing(arch, routes):
    """The share of (token, choice) pairs of the logits check's prefill
    and decode step that the kernel backend routed to an expert the torch
    backend also chose for that token (and the torch backend's bf16 to
    one its f32 chose), over every MoE layer, and in the first and the
    last MoE layer of the prefill.  The router's output is discontinuous:
    a near tie that two sums in another order break differently swaps an
    expert, and the layers' inputs drift apart with depth."""
    def alike(x, y):
        return (x[..., :, None] == y[..., None, :]).any(-1)

    def share(a, b, layers=None):
        pairs = list(zip(routes[a], routes[b]))
        pairs = pairs if layers is None else [pairs[i] for i in layers]
        return (sum(int(alike(x, y).sum()) for x, y in pairs)
                / sum(x.numel() for x, _ in pairs))

    total = sum(x.numel() for x in routes["kernel"])
    n_moe = len(routes["kernel"]) // 2       # the prefill's, then decode's
    print(f"  {arch} routing: kernel vs torch backend "
          f"{share('kernel', 'torch'):.6f} of {total} (token, choice) pairs "
          f"alike; first MoE layer {share('kernel', 'torch', [0]):.6f}, "
          f"last {share('kernel', 'torch', [n_moe - 1]):.6f}; torch bf16 vs "
          f"f32 {share('torch', 'f32'):.6f}")


# Each model's logits bound from its phase-3 check, by (arch, what).
LOGIT_TOLS: dict[tuple, float] = {}


def check_logits(torch, failures, arch, cfg, outs):
    """``outs[mode]`` = (prefill logits, decode logits) for the modes
    kernel, torch (bf16) and f32: the kernel backend's against the torch
    backend's, relative L2 below the larger of 2e-2 and twice the model's
    own bf16 noise (the torch backend's bf16 logits against its f32
    ones)."""
    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    for what, i in (("prefill logits", 0), ("decode logits", 1)):
        got, want = outs["kernel"][i], outs["torch"][i]
        noise = rel(want, outs["f32"][i])
        tol = LOGIT_TOLS[arch, what] = max(2e-2, 2 * noise)
        r = rel(got, want)
        ok = (bool(torch.isfinite(got).all())
              and got.shape == (want.shape[0], cfg.vocab_size) and r < tol)
        print(f"  [{'ok' if ok else 'FAIL'}] {arch} {what} "
              f"{tuple(got.shape)}: kernel vs torch backend rel L2 {r:.3e} "
              f"(tol {tol:.3e}; torch bf16 vs f32 {noise:.3e})")
        if not ok:
            failures.append(f"{arch} {what}")


def check_handoff(torch, failures, model, cfg, prompt):
    """The ssm kind's exact per-slot handoff: a slot's first decode logits
    after ``_scatter_prefill`` into a batch of 4 equal a batch-1 decode
    from the same prefill state (within 2^-8 of max|logit|, one bf16 ulp:
    each row's products are the same, only the batch around it differs)."""
    from repro_torch.core import facility
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M

    g = torch.Generator(device="cuda").manual_seed(6)
    b, slot = SERVE["batch"], 2
    with facility.configure(facility.FacilityConfig(device="cuda")):
        _, pre = M.prefill(model, {"tokens": prompt}, cfg)
        tok = prompt[:, -1:]
        many = torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                             device="cuda", dtype=torch.int32)
        many[slot] = tok[0]
        cache = S._scatter_prefill(M.init_cache(cfg, b, 64, device="cuda"),
                                   pre, slot)
        got, _ = M.decode_step(model, cache, many, cfg)
        one = S._scatter_prefill(M.init_cache(cfg, 1, 64, device="cuda"),
                                 pre, 0)
        want, _ = M.decode_step(model, one, tok, cfg)
    got, want = got[slot, -1].float(), want[0, -1].float()
    err = (got - want).abs().max().item()
    tol = 2.0 ** -8 * want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= tol
    print(f"  [{'ok' if ok else 'FAIL'}] {cfg.name} handoff: slot {slot} of "
          f"{b} after _scatter_prefill vs batch-1 decode: max|err| "
          f"{err:.3e} (tol 2^-8*max|ref| = {tol:.3e})")
    if not ok:
        failures.append(f"{cfg.name} prefill handoff")


def serve_steps(torch, model, cfg, settings):
    """A serving run's step closures: a batch-1 prefill of ``prompt_len``
    random tokens and a batch-``batch`` decode step on a fresh cache."""
    from repro_torch.models import model as M

    b, p = settings["batch"], settings["prompt_len"]
    g = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (1, p), generator=g,
                           device="cuda", dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                           device="cuda", dtype=torch.int32)
    state = {"cache": M.init_cache(cfg, b, p * 4, device="cuda")}

    def decode():
        _, state["cache"] = M.decode_step(model, state["cache"], tokens, cfg)

    return (lambda: M.prefill(model, {"tokens": prompt}, cfg), decode,
            f"prefill (1 x {p}), decode step (batch {b})")


def step_breakdown(torch, cfg, prefill, decode, what):
    """Where one prefill and one decode step spend their time: host-clock
    step times (synchronised, median), and a torch.profiler trace of each
    for device time by kernel and the device's idle share of the step."""
    from repro_torch.core import facility

    def host_ms(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    with facility.configure(facility.FacilityConfig(device="cuda")):
        prefill_ms = host_ms(prefill, 3)
        decode_ms = host_ms(decode, 5)
        print(f"  {cfg.name} {what}: {prefill_ms:.2f} ms, {decode_ms:.2f} ms "
              f"(host clock, median)")
        for step, fn, step_ms in (("prefill", prefill, prefill_ms),
                                  ("decode step", decode, decode_ms)):
            profile_step(torch, step, fn, step_ms)


# The __global__ functions of src/repro_torch/csrc, as the profiler names
# them.
PORT_KERNELS = ("gemm_stream_tma_kernel", "gemm_stream_kernel",
                "gemm_stream_f32_kernel",
                "gemm_wgmma_kernel",
                "gemm_wmma_kernel", "gemm_f32_kernel", "flash_tile_kernel",
                "flash_decode_kernel", "flash_f32_tile_kernel",
                "depthwise_vec_kernel",
                "depthwise_conv_kernel", "conv_wgmma_kernel",
                "conv_wmma_kernel", "conv_f32_kernel")


def profile_step(torch, step, fn, step_ms):
    """One call of ``fn`` under torch.profiler: device busy time by kernel
    and the device's idle share, against the unprofiled ``step_ms`` too
    (the profiler slows the host)."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an operator row (aten::copy_, ...) repeats the
    # device time of the kernels it launched.
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = max(getattr(ev, "device_time_total", 0),
                     getattr(ev, "self_device_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"  profiler: no device time recorded for the {step} (not "
              f"measured)")
        return None
    print(f"  profiled {step}: wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms; device idle share {max(0.0, 1 - busy / step_ms):.3f}"
          f" of the unprofiled {step} ({max(0.0, 1 - busy / wall_ms):.3f} of "
          f"the profiled one)")
    # the ten largest rows, then every other row of the port's own kernels
    rows.sort(reverse=True)
    shown = rows[:10] + [r for r in rows[10:] if re.split(r"[<(]", r[2])[
        0].split()[-1] in PORT_KERNELS]
    for ms, count, key in shown:
        print(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} "
              f"{key[:90]}")
    return busy, max(0.0, 1 - busy / step_ms)


def bank_time(torch, cfg, decode):
    """One decode step of a MoE model under torch.profiler: the expert
    banks' device time -- the GEMM kernels whose launch had the experts
    on its batch axis, matched in launch order to ``mma_gemm.trace`` (one
    stream: kernels run in the order they were launched) -- beside the
    step's device busy time."""
    from repro_torch.core import facility
    from repro_torch.kernels import mma_gemm as G
    act = torch.profiler.ProfilerActivity
    with facility.configure(facility.FacilityConfig(device="cuda")):
        decode()
        torch.cuda.synchronize()
        G.mma_gemm.trace = []
        try:
            with torch.profiler.profile(activities=[act.CPU,
                                                    act.CUDA]) as prof:
                decode()
                torch.cuda.synchronize()
            trace = G.mma_gemm.trace
        finally:
            G.mma_gemm.trace = None
    cuda = torch.autograd.DeviceType.CUDA
    kern = [ev for ev in prof.events() if ev.device_type == cuda]
    gemm = sorted((ev for ev in kern
                   if re.split(r"[<(]", ev.name)[0].split()[-1]
                   in GEMM_KERNELS), key=lambda ev: ev.time_range.start)
    busy = sum(ev.time_range.elapsed_us() for ev in kern) / 1e3
    if len(gemm) != len(trace) or not gemm:
        print(f"  {cfg.name} decode step banks: not measured ({len(gemm)} "
              f"GEMM kernel events for {len(trace)} launches)")
        return None
    banks = [ev.time_range.elapsed_us() / 1e3 for ev, rec in zip(gemm, trace)
             if rec[0] == cfg.num_experts]
    print(f"  {cfg.name} decode step: the expert banks' device time "
          f"{sum(banks):.2f} ms in {len(banks)} launches, of {busy:.2f} ms "
          f"device busy (profiled)", flush=True)
    return sum(banks)


# The GEMM's kernels, as the profiler names them.
GEMM_KERNELS = ("gemm_stream_tma_kernel", "gemm_stream_kernel",
                "gemm_stream_f32_kernel",
                "gemm_wgmma_kernel", "gemm_wmma_kernel", "gemm_f32_kernel",
                "gemm_imma_kernel", "gemm_dmma_kernel")


def gemm_split(torch, label, fn, step_ms):
    """One call of ``fn`` under torch.profiler, its unprofiled host-clock
    time ``step_ms`` split three ways: the GEMM kernels' device time
    (GEMM_KERNELS), the rest of the device's busy time, and the host (the
    step's time the device idles).  Returns the three in ms, or None where
    the profiler recorded no device time."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    gemm = other = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        ms = max(getattr(ev, "device_time_total", 0),
                 getattr(ev, "self_device_time_total", 0)) / 1e3
        name = re.split(r"[<(]", ev.key)[0].split()[-1]
        if name in GEMM_KERNELS:
            gemm += ms
        else:
            other += ms
    if gemm + other == 0:
        print(f"  profiler: no device time recorded for the {label} (not "
              f"measured)")
        return None
    host = max(0.0, step_ms - gemm - other)
    print(f"  split {label}: {step_ms:.2f} ms (host clock) = GEMM "
          f"{gemm:.2f} ms ({100 * gemm / step_ms:.1f}%) + other device "
          f"{other:.2f} ms ({100 * other / step_ms:.1f}%) + host (device "
          f"idle) {host:.2f} ms ({100 * host / step_ms:.1f}%)")
    return {"step_ms": step_ms, "gemm_ms": gemm, "other_device_ms": other,
            "host_ms": host}


def mm_batch(cfg, settings, batch):
    """A generation run's prefill batch from the port's synthetic_batch:
    whisper, ``batch`` clips of ``frames`` mel frames and the first
    ``prompt_len`` decoder tokens; qwen2-vl, ``batch`` images of its patch
    grid and ``text_len`` text tokens after the vision prefix, with their
    M-RoPE positions.  Returns (device batch, the decode cache's
    seq_len)."""
    from repro_torch.data import pipeline

    if cfg.is_enc_dec:
        host = pipeline.synthetic_batch(cfg, batch=batch,
                                        seq=settings["frames"], step=0)
        host["tokens"] = host["tokens"][:, :settings["prompt_len"]]
        seq_len = settings["frames"]
    else:
        seq = cfg.vision_prefix + settings["text_len"]
        host = pipeline.synthetic_batch(cfg, batch=batch, seq=seq, step=0)
        # room for the generated tokens and the profiled steps after them
        seq_len = seq + settings["gen_len"] + 16
    del host["labels"]
    return pipeline.device_batch(host, "cuda"), seq_len


def handoff(torch, cfg, pre, batch, seq_len, dtype):
    """The decode cache after a P-token prefill, on the reference's cache
    layout: prefill's k/v in ring slots [0, P), ``pos[:P] = arange(P)``,
    ``cur = P``; whisper's ``cross_kv`` in ``cross_k``/``cross_v``."""
    from repro_torch.models import model as M

    cache = M.init_cache(cfg, batch, seq_len, device="cuda", dtype=dtype)
    k, v = pre["kv"]
    p = k.shape[2]
    cache["k"][:, :, :p] = k
    cache["v"][:, :, :p] = v
    cache["pos"][:p] = torch.arange(p, dtype=torch.int32, device="cuda")
    cache["cur"] = p
    if "cross_kv" in pre:
        cache["cross_k"].copy_(pre["cross_kv"][0])
        cache["cross_v"].copy_(pre["cross_kv"][1])
    return cache


def generate(torch, failures, arch, settings):
    """Generate with ``arch`` (random bf16 weights from seed 0) through
    ``prefill`` and ``decode_step``: a batch prefill, the cache handoff and
    ``gen_len`` greedy decode steps, every kernel's launch count reset just
    before and read just after and held to the per-call model; then the
    prefill and decode logits of the first request on the kernel backend
    against the eager torch backend.  Returns the counts and the step
    closures for ``step_breakdown``."""
    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.models import model as M

    cfg = get_arch(arch)
    b, gen = settings["batch"], settings["gen_len"]
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nparam = sum(t.numel() for t in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers (+{cfg.encoder_layers} "
          f"encoder), d_model {cfg.d_model}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}: {nparam / 1e9:.3f} B params (projections "
          f"bf16, stems fp32), init {time.perf_counter() - t0:.1f} s")
    batch, seq_len = mm_batch(cfg, settings, b)
    print(f"  batch: {({k: tuple(v.shape) for k, v in batch.items()})}")
    want = expected_launches(cfg)
    kernels = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    with facility.configure(facility.FacilityConfig(device="cuda")):
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, pre = M.prefill(model, batch, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = handoff(torch, cfg, pre, b, seq_len, torch.bfloat16)
        del pre
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        out = [tok]
        finite = torch.isfinite(last).all()       # read once, after the run
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(gen):
            logits, cache = M.decode_step(model, cache, tok, cfg)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = {name: fn.launches for name, fn in kernels.items()}
        take_records(arch, kernels)
        finite = bool(finite)
    tokens = torch.cat(out, dim=1)
    print(f"  generated {tuple(tokens.shape)} tokens: prefill "
          f"{(t1 - t0) * 1e3:.2f} ms, {gen} decode steps "
          f"{(t3 - t2) * 1e3:.2f} ms ({(t3 - t2) * 1e3 / gen:.2f} ms a step, "
          f"{b * gen / (t3 - t2):.1f} tok/s), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first "
          f"request's tokens {tokens[0, :8].tolist()}...")
    model_counts = {k: want["prefill"].get(k, 0) + gen * want["decode"].get(
        k, 0) for k in kernels}
    print(f"  launches in the run: {launches}; 1 prefill + {gen} decode "
          f"steps give {model_counts}: "
          f"{'matches' if model_counts == launches else 'DIFFERS FROM'} the "
          f"counts")
    if model_counts != launches:
        failures.append(f"{arch} launch counts {launches} differ from the "
                        f"per-call model {model_counts}")
    for name in set(want["prefill"]) | set(want["decode"]):
        if launches[name] <= 0:
            failures.append(f"{name} never launched while generating {arch}")
    ok = (finite and tokens.shape == (b, gen + 1)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()))
    print(f"  [{'ok' if ok else 'FAIL'}] {arch}: every logit finite, "
          f"tokens in range")
    if not ok:
        failures.append(f"{arch} generation output")

    # The first request through the three modes: prefill, the handoff and
    # one decode step of the prompt's last token.
    one = {k: (v[:, :1] if k == "positions" else v[:1])
           for k, v in batch.items()}
    modes = {"kernel": dict(backend="kernel"), "torch": dict(backend="torch"),
             "f32": dict(backend="torch", ger=facility.Ger.F32GER,
                         out_dtype=torch.float32)}
    outs = {}
    for mode, kw in modes.items():
        with facility.configure(facility.FacilityConfig(device="cuda", **kw)):
            first, pre = M.prefill(model, one, cfg)
            c1 = handoff(torch, cfg, pre, 1, seq_len,
                         kw.get("out_dtype", torch.bfloat16))
            del pre
            step, _ = M.decode_step(model, c1, one["tokens"][:, -1:], cfg)
        outs[mode] = (first.float(), step[:, -1].float())
        del c1
    check_logits(torch, failures, arch, cfg, outs)
    del outs

    state = {"cache": cache, "tok": tok}

    def decode():
        _, state["cache"] = M.decode_step(model, state["cache"],
                                          state["tok"], cfg)

    steps = (lambda: M.prefill(model, batch, cfg), decode,
             f"prefill (batch {b}), decode step (batch {b})")
    return launches, (cfg, *steps), (model, batch, seq_len)


# ----------------------------------------------------------------------
# Phase 5: train
# ----------------------------------------------------------------------

def expected_train_launches(cfg) -> dict:
    """Kernel launches per train step, from the code: the forward's, which
    are a prefill's over the batch (``expected_launches``); then the
    backward: two GEMMs (dX, dY) per forward GEMM and one recompute of Z
    per GEMM with a fused activation (the w1 of each dense layer's MLP,
    of whisper's encoder and decoder MLPs, of each MoE layer's expert bank
    and shared MLP, or of the hybrid shared block's at each group);
    attention and both convs launch in the forward only (their backward
    recomputes through the torch lowering)."""
    fwd = dict(expected_launches(cfg)["prefill"])
    n = cfg.num_layers
    if cfg.family in ("dense", "vlm"):
        activated = n
    elif cfg.family == "audio":          # every encoder and decoder MLP
        activated = cfg.encoder_layers + n
    elif cfg.family == "moe":            # w1 of each MLP and expert bank
        fd = cfg.first_dense_layers
        activated = fd + (n - fd) * (2 if cfg.num_shared_experts else 1)
    else:
        activated = (-(-n // cfg.shared_attn_every)
                     if cfg.shared_attn_every else 0)
    return {"forward_gemm": fwd["mma_gemm"],
            **fwd, "mma_gemm": 3 * fwd["mma_gemm"] + activated}


def check_train_grads(torch, failures, arch, cfg, model, batch):
    """Step 1's loss and every parameter's gradient on the kernel backend
    against the eager torch backend: the loss within 2e-2 relative, each
    gradient's relative L2 below the larger of 5e-2 and twice that
    parameter's own bf16 noise (the torch backend's BF16GER2 gradient
    against its F32GER/f32 one), as the logits are held."""
    from repro_torch.core import facility
    from repro_torch.train import steps as S

    def rel(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()

    def run(**kw):
        with facility.configure(facility.FacilityConfig(device="cuda",
                                                        **kw)):
            loss, _, grads = S.loss_and_grads(cfg, model, batch)
        return loss.item(), grads

    t0 = time.perf_counter()
    loss_t, want = run(backend="torch")
    loss_f, f32 = run(backend="torch", ger=facility.Ger.F32GER,
                      out_dtype=torch.float32)
    noise = {k: rel(want[k], f32[k]) for k in want}
    del f32
    loss_k, got = run(backend="kernel")
    worst = sorted(((rel(got[k], want[k]) / max(5e-2, 2 * noise[k]),
                     rel(got[k], want[k]), noise[k], k) for k in got),
                   reverse=True)
    del got, want
    ok_loss = (abs(loss_k - loss_t) <= 2e-2 * abs(loss_t)
               and bool(torch.isfinite(torch.tensor(loss_k))))
    ok = ok_loss and worst[0][0] < 1
    print(f"  [{'ok' if ok else 'FAIL'}] {arch} step-1 loss kernel "
          f"{loss_k:.6f}, torch {loss_t:.6f} (f32 {loss_f:.6f}); "
          f"{len(worst)} gradients within max(5e-2, 2 x bf16 noise) of the "
          f"torch backend; worst rel L2 / tol {worst[0][0]:.3f} "
          f"({time.perf_counter() - t0:.1f} s)")
    for q, r, nz, k in worst[:3]:
        print(f"    {k}: rel L2 {r:.3e} (bf16 noise {nz:.3e})")
    if not ok:
        failures.append(f"{arch} step-1 loss or gradients")


def host_like(torch, tree):
    """Empty CPU tensors in ``tree``'s structure (a module's parameters
    in a CPU copy of the module), for a checkpoint to restore into."""
    import copy
    if isinstance(tree, torch.nn.Module):
        memo = {id(p): torch.nn.Parameter(torch.empty(p.shape,
                                                      dtype=p.dtype),
                                          requires_grad=False)
                for p in tree.parameters()}
        return copy.deepcopy(tree, memo)
    if isinstance(tree, dict):
        return {k: host_like(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_like(torch, v) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype)


def check_checkpoint(torch, failures, arch, state, step):
    """A Checkpointer save of the train state and a restore into host
    tensors of its structure: every leaf back bit for bit."""
    import tempfile

    from repro_torch.checkpoint import checkpoint as C

    with tempfile.TemporaryDirectory() as d:
        ck = C.Checkpointer(d)
        t0 = time.perf_counter()
        ck.save(step, state)
        t1 = time.perf_counter()
        like = ck.restore(step, host_like(torch, state))
        t2 = time.perf_counter()
        flat, back = C._flatten(state), C._flatten(like)
        nbytes = sum(t.numel() * t.element_size() for _, t in flat)
        same = ([p for p, _ in flat] == [p for p, _ in back] and all(
            a.dtype == b.dtype and torch.equal(a.detach().cpu(), b)
            for (_, a), (_, b) in zip(flat, back)))
        del like, back
    print(f"  [{'ok' if same else 'FAIL'}] {arch} checkpoint of "
          f"{len(flat)} leaves, {nbytes / 2**30:.2f} GiB: save "
          f"{t1 - t0:.1f} s, restore {t2 - t1:.1f} s, bit for bit")
    if not same:
        failures.append(f"{arch} checkpoint round trip")


def train(torch, failures, arch, num_layers):
    """Train ``arch`` through ``launch.train.build`` (fp32 weights from
    seed 0, the default kernel backend) for ``TRAIN["steps"]`` steps on one
    repeated batch, every kernel's launch count reset just before the
    steps and read just after and held to ``expected_train_launches``;
    returns the counts."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    cfg = get_arch(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
        print(f"  depth cut: num_layers {num_layers} (of "
              f"{get_arch(arch).num_layers}); widths unchanged")
    b, steps = TRAIN["batch"], TRAIN["steps"]
    s = TRAIN_SEQ.get(arch, TRAIN["seq"])
    lr = TRAIN_LR.get(arch, TRAIN["lr"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    make_state, make_step, _ = T.build(cfg, lr=lr, total_steps=steps,
                                       weight_decay=0.0, seed=0,
                                       device="cuda")
    state, step = make_state(), make_step()
    model = state["params"]
    nparam = sum(t.numel() for t in model.parameters())
    batch = pipeline.device_batch(pipeline.synthetic_batch(
        cfg, batch=b, seq=s, step=0), "cuda")
    ntok = batch["tokens"].numel()
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {nparam / 1e9:.3f} B "
          f"fp32 parameters, init {time.perf_counter() - t0:.1f} s; batch "
          f"{({k: tuple(v.shape) for k, v in batch.items()})}, lr "
          f"{lr}, {steps} steps")
    check_train_grads(torch, failures, arch, cfg, model, batch)

    want = expected_train_launches(cfg)
    kernels = kernel_wrappers()
    torch.cuda.synchronize()
    reset_counts(kernels)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    launches = {name: fn.launches for name, fn in kernels.items()}
    trace = list(kernels["mma_gemm"].trace)
    attn_trace = list(kernels["mma_flash_attention"].trace)
    take_records(f"{arch} train", kernels)
    losses = torch.stack(losses).tolist()
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = {k: v for k, v in want.items() if k != "forward_gemm"}
    model_counts = {k: steps * per_step.get(k, 0) for k in kernels}
    print(f"  losses {[round(x, 4) for x in losses]}; launches {launches}; "
          f"{steps} steps x {per_step} give {model_counts}: "
          f"{'matches' if model_counts == launches else 'DIFFERS FROM'} the "
          f"counts; GEMM by path "
          f"{RECORDS[f'{arch} train']['by_path']['mma_gemm']}")
    if model_counts != launches:
        failures.append(f"{arch} train launch counts {launches} differ from "
                        f"the per-call model {model_counts}")
    for name, n in per_step.items():
        if n and launches[name] <= 0:
            failures.append(f"{name} never launched while training {arch}")
    ok = (all(x == x and abs(x) != float("inf") for x in losses)
          and all(b < a for a, b in zip(losses[1:], losses[2:]))
          and losses[-1] <= (1 - TRAIN["fall"]) * losses[0])
    print(f"  [{'ok' if ok else 'FAIL'}] {arch}: loss finite, falling at "
          f"every step after the first update and by {TRAIN['fall']:.0%} "
          f"or more over the run ({losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{1 - losses[-1] / losses[0]:.1%})")
    if not ok:
        failures.append(f"{arch} training loss")
    # No backward product may leave the weight stream and the wgmma tile
    # where they take its shape (16-byte pitches, K >= 16): the WMMA and
    # fp32 tiles are for what they refuse.
    from repro_torch.core import tiling
    off = sorted({(bb, m, k, n) for bb, m, k, n, dt, _, path in trace
                  if path == "wmma" and k >= tiling.MIN_K
                  and (k * dt.itemsize) % 16 == 0
                  and (n * dt.itemsize) % 16 == 0})
    print(f"  [{'ok' if not off else 'FAIL'}] {arch}: every aligned "
          f"product on the weight stream or the wgmma tile"
          + (f"; on wmma: {off[:8]}" if off else ""))
    if off:
        failures.append(f"{arch} train products on the wmma tile: {off}")

    # Model FLOPs: 3x the forward's (the backward does twice its work):
    # its GEMMs (the first launches of the step) and its attention.
    from repro_torch.kernels import mma_attention as A
    fwd_gemm = sum(2 * bb * m * k * n for bb, m, k, n, *_ in
                   trace[:want["forward_gemm"]])
    fwd_attn = sum(4 * d * h * bb * A.attn_live_pairs(
        sq, sk, causal=causal, q_offset=qo, window=win)
        for bb, sq, sk, h, _, d, _, causal, qo, win, _, _ in
        attn_trace[:want.get("mma_flash_attention", 0)])
    step_ms = sorted(times)[len(times) // 2]
    flops = 3 * (fwd_gemm + fwd_attn)
    print(f"  {arch} train step: {step_ms:.2f} ms (host clock, median of "
          f"{steps}; {[round(t, 1) for t in times]}), {ntok / step_ms * 1e3:.0f}"
          f" tokens/s, model {flops / 1e12:.2f} TFLOP a step = "
          f"{flops / step_ms / 1e9:.1f} TFLOP/s ({flops / step_ms / 1e9 / 989:.3f}"
          f" of the 989 bf16 peak), peak device memory {peak:.2f} GiB")
    with facility.configure(facility.FacilityConfig(device="cuda")):
        prof = profile_step(torch, "train step",
                            lambda: step(state, batch), step_ms)
    check_checkpoint(torch, failures, arch, state, steps)
    del state, model, step, make_state, make_step
    torch.cuda.empty_cache()
    # The same steps from the same weights on the eager torch backend: each
    # step's loss within 2e-2 relative, as step 1's is held.
    make_state, make_step, _ = T.build(cfg, lr=lr, total_steps=steps,
                                       weight_decay=0.0, seed=0,
                                       device="cuda", backend="torch")
    state, step = make_state(), make_step()
    eager = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        eager.append(metrics["loss"])
    eager = torch.stack(eager).tolist()
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, eager))
    ok = worst <= 2e-2
    print(f"  [{'ok' if ok else 'FAIL'}] {arch} the same steps on the eager "
          f"torch backend: losses {[round(x, 4) for x in eager]}; kernel "
          f"backend within {worst:.2e} relative (tol 2e-2)")
    if not ok:
        failures.append(f"{arch} loss curve against the torch backend")
    del state, step, make_state, make_step, batch
    return launches, dict(step_ms=step_ms, tokens_per_s=ntok / step_ms * 1e3,
                          tflops=flops / step_ms / 1e9, peak_gib=peak,
                          losses=losses,
                          busy_ms=prof[0] if prof else None,
                          idle=prof[1] if prof else None)


# ----------------------------------------------------------------------
# Phase 6: the family table and its paths (the IMMA and DMMA kernels,
# quant.qdot, the complex op-class, blas3's dft and trsm, the saturating
# forms)
# ----------------------------------------------------------------------

# The phase's main-path runs: (run name, the kernel path each must launch,
# its launches a call).  dft and complex_gemm are four K1 launches a call
# (F32GER on the WMMA tile); trsm's panel updates and the saturating forms
# run the torch lowering, no kernel.  F64GER's runs (DGEMM 8192^2, the
# complex128 complex_gemm and the f64 dft) are phase 14's DMMA_TARGETS.
FAMILY_RUNS = {
    "I8GER4 8192": ("imma", 1),
    "I4GER8 8192": ("imma", 1), "I4GER8 4096": ("imma", 1),
    "I16GER2 8192": ("imma", 1), "I16GER2 4096": ("imma", 1),
    "qdot M=4": ("imma", 1), "qdot M=1024": ("imma", 1),
    "complex_gemm c64 4096": ("wmma", 4),
    "dft f32 N=1024 64x128": ("wmma", 4),
    "trsm f32 N=4096 R=1024": (None, 0),
    "saturating": (None, 0),
}
# The IMMA kernel's form each integer run must take (tiling.imma_plan):
# the wgmma tile for every product TMA can read, I8GER4's weight stream at
# qdot's decode (the kernel's N = 4 activation columns).
FAMILY_FORMS = {"I8GER4 8192": "tile", "I4GER8 8192": "tile",
                "I4GER8 4096": "tile", "I16GER2 8192": "tile",
                "I16GER2 4096": "tile", "qdot M=4": "stream",
                "qdot M=1024": "tile"}
# The phase's kernel entries: (the GEMM path, the IMMA form) each reads its
# launches from.  The mma.sync kernel is the masked form's entry
# (phase 8: "mma_gemm masked (imma)").
PATH_ENTRIES = {"mma_gemm.imma": ("imma", "tile"),
                "mma_gemm.imma_stream": ("imma", "stream")}
# Per phase-6 run: the IMMA kernel's launches by form.
FORMS: dict[str, dict] = {}
# I16GER2's four int8 products a 16-bit product (its bound counts them).
_PRODUCTS = {"I8GER4": 1, "I4GER8": 1, "I16GER2": 4}


def _int_operands(torch, g, kind, lead, m, k, n):
    """Full-range operands of an integer family; K is logical (I4GER8
    packs it two nibbles a byte)."""
    name = kind.name
    xr, yr = {"I8GER4": ((-128, 128, torch.int8), (0, 256, torch.uint8)),
              "I4GER8": ((-128, 128, torch.int8), (-128, 128, torch.int8)),
              "I16GER2": ((-32768, 32768, torch.int16),
                          (-32768, 32768, torch.int16))}[name]
    kp = k // 2 if name == "I4GER8" else k

    def ri(lo, hi, dt, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device="cuda").to(dt)
    return ri(*xr, *lead, m, kp), ri(*yr, *lead, kp, n)


def check_families(torch, failures) -> dict:
    """Each new path against its plain version at edge cases: ragged
    fringes, batch, every accumulate form with a full-range int32 seed,
    the epilogues an integer accumulator admits, out dtypes and I16GER2's
    wrap, bit for bit; F64GER within 1e-15 * K * max|x| * max|y| (fp64
    sums in another order), its activations included.  Returns the worst
    error of the IMMA kernel's by path."""
    from repro_torch.core import precision
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_gemm as G

    Ger = precision.Ger
    g = torch.Generator(device="cuda").manual_seed(6)
    worst = {"imma": 0.0}

    def ri(lo, hi, *shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g,
                             device="cuda").to(dtype)

    cases = [("ragged", (), (37, 100, 45), {}),
             ("batched B=3", (3,), (77, 200, 130), {}),
             ("aligned", (), (256, 4096, 512), {})]
    for neg_p in (False, True):
        for neg_a in (False, True):
            form = {(False, False): "pp", (True, False): "np",
                    (False, True): "pn", (True, True): "nn"}[neg_p, neg_a]
            cases.append((f"{form} seed alpha 3.7 beta -2.5", (),
                          (70, 256, 90),
                          dict(seed=True, neg_product=neg_p, neg_acc=neg_a,
                               alpha=3.7, beta=-2.5)))
    cases += [("bias+relu+res batched B=2", (2,), (33, 96, 40),
               dict(seed=True, epi=True)),
              ("out f32", (), (64, 512, 72), dict(out=torch.float32)),
              ("out bf16", (), (64, 512, 72), dict(out=torch.bfloat16)),
              ("out f64", (), (64, 512, 72), dict(out=torch.float64))]
    for kind in (Ger.I8GER4, Ger.I4GER8, Ger.I16GER2):
        for name, lead, (m, k, n), opts in cases:
            opts = dict(opts)
            x, y = _int_operands(torch, g, kind, lead, m, k, n)
            c = (ri(-2 ** 31, 2 ** 31 - 1, *lead, m, n)
                 if opts.pop("seed", False) else None)
            kw = dict(kind=kind, out_dtype=opts.pop("out", None), **{
                f: opts[f] for f in ("neg_product", "neg_acc", "alpha",
                                     "beta") if f in opts})
            if opts.get("epi"):
                kw.update(ep=E.Epilogue(bias=True, activation="relu",
                                        residual=True),
                          bias=ri(-1000, 1000, n),
                          residual=ri(-1000, 1000, *lead, m, n))
            got = G.mma_gemm(x, y, c, **kw)
            want = G.mma_gemm_plain(x, y, c, **kw)
            err = (got.double() - want.double()).abs().max().item()
            ok = torch.equal(got, want) and got.dtype == want.dtype
            worst["imma"] = max(worst["imma"], err)
            print(f"  [{'ok' if ok else 'FAIL'}] imma {kind.name} {name} "
                  f"{lead}{(m, k, n)}: max|err| {err:.3e} (bit for bit)")
            if not ok:
                failures.append(f"imma {kind.name} {name}")
    # I16GER2 at full range wraps: the exact sum leaves int32 and the
    # kernel keeps the wrapped bits of the reference's int32 dot
    x, y = _int_operands(torch, g, Ger.I16GER2, (), 128, 4096, 128)
    exact = torch.matmul(x.double(), y.double())
    wraps = bool((exact.abs() > 2 ** 31 - 1).any())
    ok = wraps and torch.equal(G.mma_gemm(x, y, kind=Ger.I16GER2),
                               exact.to(torch.int64).to(torch.int32))
    print(f"  [{'ok' if ok else 'FAIL'}] imma I16GER2 wrap 128x4096x128: "
          f"the exact sum leaves int32 ({wraps}); kernel == wrapped exact "
          f"sum bit for bit")
    if not ok:
        failures.append("imma I16GER2 wrap")

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float64)

    f64_cases = [("ragged", (), (37, 301, 45), {}),
                 ("batched B=3", (3,), (77, 200, 130), {}),
                 ("np/nn seed alpha 0.5 beta -2", (), (70, 256, 90),
                  dict(seed=True, neg_product=True, neg_acc=True, alpha=0.5,
                       beta=-2.0)),
                 ("bias+gelu+res batched B=2", (2,), (65, 128, 66),
                  dict(act="gelu")),
                 ("bias+silu+res", (), (129, 256, 200), dict(act="silu")),
                 ("out f32", (), (64, 512, 72), dict(out=torch.float32))]
    for name, lead, (m, k, n), opts in f64_cases:
        x, y = rn(*lead, m, k), rn(*lead, k, n)
        c = rn(*lead, m, n) if opts.get("seed") else None
        kw = dict(kind=Ger.F64GER, out_dtype=opts.get("out"), **{
            f: opts[f] for f in ("neg_product", "neg_acc", "alpha", "beta")
            if f in opts})
        if "act" in opts:
            kw.update(ep=E.Epilogue(bias=True, activation=opts["act"],
                                    residual=True),
                      bias=rn(n), residual=rn(*lead, m, n))
        got = G.mma_gemm(x, y, c, **kw).double()
        want = G.mma_gemm_plain(x, y, c, **kw).double()
        err = (got - want).abs().max().item()
        tol = 1e-15 * k * x.abs().max().item() * y.abs().max().item()
        if opts.get("out") == torch.float32:
            tol += 2 ** -24 * want.abs().max().item()     # one f32 rounding
        ok = err <= tol
        print(f"  [{'ok' if ok else 'FAIL'}] dmma F64GER {name} "
              f"{lead}{(m, k, n)}: max|err| {err:.3e} (tol {tol:.3e})")
        if not ok:
            failures.append(f"dmma F64GER {name}")
    return worst


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def family_runs(torch, timer, failures, by_run, worst):
    """The phase's main-path runs through the entry points a user calls
    (``facility.contract``, ``quant.qdot``, ``blas3.complex_gemm``,
    ``blas3.dft``, ``blas3.trsm``), every launch count reset just before
    each and read just after, each held to its expected path and count,
    its result checked; then each timed (CUDA events, L2 flushed) beside
    its plain version, a library yardstick and its bound.  Returns the
    ``kernels`` entry of the IMMA kernel, and the timed rows of the runs
    on the WMMA tile or on no kernel."""
    from repro_torch.core import facility as F
    from repro_torch.core import quant as Q
    from repro_torch.kernels import blas3 as B3
    from repro_torch.kernels import mma_gemm as G

    Ger = F.Ger
    kernels = kernel_wrappers()
    g = torch.Generator(device="cuda").manual_seed(7)
    rows: dict[str, dict] = {}

    def run(name, fn):
        reset_counts(kernels)
        G.mma_gemm.imma_launches_by_form = dict.fromkeys(
            G.mma_gemm.imma_launches_by_form, 0)
        with F.configure(F.FacilityConfig(device="cuda")):
            out = fn()
        torch.cuda.synchronize()
        by_run[name] = {k: f.launches for k, f in kernels.items()}
        take_records(name, kernels)
        FORMS[name] = dict(G.mma_gemm.imma_launches_by_form)
        path, want = FAMILY_RUNS[name]
        got = RECORDS[name]["by_path"]["mma_gemm"]
        form = FAMILY_FORMS.get(name)
        ok = (sum(got.values()) == want
              and (path is None or got[path] == want)
              and (form is None or FORMS[name][form] == want))
        print(f"  [{'ok' if ok else 'FAIL'}] {name}: GEMM launches by path "
              f"{ {p: v for p, v in got.items() if v} }"
              + (f", IMMA by form { {f: v for f, v in FORMS[name].items() if v} }"
                 if form else "")
              + f" (want {want} on {path}{f' {form}' if form else ''})")
        if not ok:
            failures.append(f"{name}: launches {got}, want {want} on {path}"
                            f"{f' {form}' if form else ''}")
        return out

    def timed(name, kernel, plain, library, nbytes, ops, peak, lib_name,
              **extra):
        row = {"ms": timer(kernel), "plain_ms": timer(plain),
               "library_ms": timer(library) if library else None,
               "library": lib_name, **extra}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, peak)
        rows[name] = row
        print(f"  time {name}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, {lib_name} "
              f"{row['library_ms'] if library else 'n/a'} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
              + "".join(f", {k} {v}" for k, v in extra.items()))

    def check(name, ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {name}: {what}")
        if not ok:
            failures.append(f"{name}: {what}")

    # the integer families through contract at 8192^2 (and 4096^2)
    for kind, n in ((Ger.I8GER4, 8192), (Ger.I4GER8, 8192),
                    (Ger.I4GER8, 4096), (Ger.I16GER2, 8192),
                    (Ger.I16GER2, 4096)):
        name = f"{kind.name} {n}"
        x, y = _int_operands(torch, g, kind, (), n, n, n)
        plan = F.Plan(ger=kind, out_dtype=F.ACC)
        out = run(name, lambda: F.contract("mk,kn->mn", x, y, plan=plan))
        check(name, torch.equal(out, G.mma_gemm_plain(x, y, kind=kind)),
              "bit for bit with the plain version")
        s8 = torch.randint(-128, 128, (n, n), generator=g, device="cuda",
                           dtype=torch.int8)
        x8 = s8 if kind != Ger.I8GER4 else x
        in_bytes = (x.numel() * x.element_size()
                    + y.numel() * y.element_size())
        timed(name, lambda: G.mma_gemm(x, y, kind=kind),
              lambda: G.mma_gemm_plain(x, y, kind=kind),
              lambda: torch._int_mm(x8, s8), in_bytes + 4 * n * n,
              2 * n ** 3 * _PRODUCTS[kind.name], "int8",
              "torch._int_mm s8 x s8 of the unpacked shape (not the same "
              "function)")
        del x, y, out, s8, x8

    # qdot at deepseek-7b's MLP up-projection (4096 -> 11008)
    k, n = 4096, 11008
    w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
    wq, ws = Q.quantize_weight(w)
    for m in (4, 1024):
        name = f"qdot M={m}"
        x = torch.randn(m, k, generator=g, device="cuda")
        out = run(name, lambda: Q.qdot(x, wq, ws))
        with F.configure(F.FacilityConfig(device="cuda")):
            plain = Q.qdot(x, wq, ws, backend="torch")
        check(name, torch.equal(out, plain) and bool(
            torch.isfinite(out).all()), "bit for bit with the torch "
              "backend's qdot")
        rel = _rel(out, torch.matmul(x, w))
        check(name, rel < 2e-2, f"relative L2 to the f32 product {rel:.3e} "
              f"(int8 quantization; < 2e-2)")
        xq, _, _ = Q.quantize_act_u8(x)
        # the spec "kn,mk->mn" hands the kernel W^T and Xq^T: two copies
        copies = [nm for nm, t in (("W^T", wq.t()), ("Xq^T", xq.t()))
                  if not t.is_contiguous()]
        wt, xt = wq.t().contiguous(), xq.t().contiguous()
        xb, wb = x.bfloat16(), w.bfloat16()

        def qdot_call():
            with F.configure(F.FacilityConfig(device="cuda")):
                Q.qdot(x, wq, ws)

        def qdot_plain():
            with F.configure(F.FacilityConfig(device="cuda")):
                Q.qdot(x, wq, ws, backend="torch")

        timed(name, lambda: G.mma_gemm(wt, xt, kind=Ger.I8GER4),
              qdot_plain, lambda: torch.matmul(xb, wb),
              m * k + k * n + 4 * m * n, 2 * m * n * k, "int8",
              "torch.matmul bf16 of the unquantized product (not the same "
              "function)", copies=copies,
              qdot_ms=timer(qdot_call),
              copy_w_ms=timer(lambda: wq.t().contiguous()),
              copy_x_ms=timer(lambda: xq.t().contiguous()))
    del w, wq, wt, xt, xb, wb

    # complex_gemm at 4096^2, complex64 on F32GER (complex128: phase 14)
    n, kind = 4096, Ger.F32GER
    name = f"complex_gemm c64 {n}"
    ar, ai, br, bi = (torch.randn(n, n, generator=g, device="cuda")
                      for _ in range(4))
    re, im = run(name, lambda: B3.complex_gemm(ar, ai, br, bi, kind=kind))
    ca, cb = torch.complex(ar, ai), torch.complex(br, bi)
    rel = _rel(torch.complex(re, im), torch.matmul(ca, cb))
    check(name, rel < 1e-5, f"relative L2 to complex torch.matmul {rel:.3e} "
          f"(< 1e-05)")

    def cg(backend=None):
        with F.configure(F.FacilityConfig(device="cuda")):
            B3.complex_gemm(ar, ai, br, bi, kind=kind, backend=backend)

    timed(name, cg, lambda: cg("torch"), lambda: torch.matmul(ca, cb),
          6 * n * n * 4, 8 * n ** 3, "f32", "torch.matmul torch.complex64")
    del ar, ai, br, bi, re, im, ca, cb

    # batched dft in f32 (f64: phase 14): N = 1024, 64 stacks of 128
    # columns.  The input is real: of the four real products of a call,
    # two multiply zeros, so the work is two, 4 N^2 64 128 flops.
    bsz, n, m = 64, 1024, 128
    name = f"dft f32 N={n} {bsz}x{m}"
    x = torch.randn(bsz, n, m, generator=g, device="cuda")
    re, im = run(name, lambda: B3.dft(x))
    ref64 = torch.fft.fft(x.double(), dim=-2)
    rel = _rel(torch.complex(re.double(), im.double()), ref64)
    rel_fft = _rel(torch.fft.fft(x, dim=-2).to(torch.complex128), ref64)
    check(name, rel < 1e-5, f"relative L2 to a float64 fft {rel:.3e} (< "
          f"1e-05; torch.fft.fft in torch.float32: {rel_fft:.3e})")

    def dft_call(backend=None):
        with F.configure(F.FacilityConfig(device="cuda")):
            B3.dft(x, backend=backend)

    xc = x.to(torch.complex64)
    timed(name, dft_call, lambda: dft_call("torch"),
          lambda: torch.fft.fft(xc, dim=-2),
          (2 * n * n + 3 * bsz * n * m) * 4, 4 * n * n * bsz * m, "f32",
          "torch.fft.fft (not the same algorithm)")
    del x, re, im, ref64, xc

    # trsm: N = 4096, 1024 right-hand sides (panel updates on the torch
    # lowering, as the reference pins xla: no kernel launch)
    n, r = 4096, 1024
    l = (torch.tril(torch.randn(n, n, generator=g, device="cuda"))
         + n * torch.eye(n, device="cuda"))
    rhs = torch.randn(n, r, generator=g, device="cuda")
    xs = run("trsm f32 N=4096 R=1024", lambda: B3.trsm(l, rhs, block=64))
    res = ((torch.matmul(l, xs) - rhs).norm()
           / (l.norm() * xs.norm() + rhs.norm())).item()
    check("trsm f32 N=4096 R=1024", res < 1e-6,
          f"relative residual {res:.3e} (< 1e-6)")
    t_trsm = timer(lambda: B3.trsm(l, rhs, block=64), iters=3, warmup=1)
    t_lib = timer(lambda: torch.linalg.solve_triangular(l, rhs,
                                                        upper=False))
    print(f"  time trsm f32 N={n} R={r}: {t_trsm:.4f} ms, "
          f"torch.linalg.solve_triangular {t_lib:.4f} ms")
    rows["trsm f32 N=4096 R=1024"] = {"ms": t_trsm, "library_ms": t_lib}
    del l, rhs, xs

    # the saturating forms on the card: the kernel backend's route (the
    # torch lowering) against the ref oracle, seeded near both int32 ends
    def saturating():
        outs = []
        for kind in (Ger.I16GER2, Ger.I8GER4):
            x, y = _int_operands(torch, g, kind, (), 256, 512, 256)
            c = torch.where(torch.arange(256, device="cuda")[:, None] % 2
                            == 0, 2 ** 31 - 1000, -2 ** 31 + 1000).to(
                                torch.int32).expand(256, 256).contiguous()
            got, want = (F.contract("mk,kn->mn", x, y, acc=c,
                                    plan=F.Plan(ger=kind, saturating=True,
                                                backend=bk,
                                                out_dtype=F.ACC))
                         for bk in ("kernel", "ref"))
            outs.append((kind, got, want))
        return outs

    for kind, got, want in run("saturating", saturating):
        clamps = int((want.abs() >= 2 ** 31 - 1).sum())
        check(f"saturating {kind.name} 256x512x256",
              torch.equal(got, want) and clamps > 0,
              f"bit for bit with the ref lowering, {clamps} clamped "
              f"outputs")

    entries = []
    for ename, (path, form) in PATH_ENTRIES.items():
        head = next(k for k, v in FAMILY_FORMS.items() if v == form)
        row = rows[head]
        entries.append({
            "name": ename, "route": "cuda",
            "source": f"src/repro_torch/csrc/gemm_{path}.cu",
            "replaces": "src/repro/kernels/mma_gemm.py:197",
            "form": form,
            "max_abs_err": worst[path], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"], "shape": head,
            "shapes": {k: v for k, v in rows.items()
                       if FAMILY_FORMS.get(k) == form}})
    # the runs on the WMMA tile (F32GER) and on no kernel, for the GEMM's
    # entry
    others = {k: v for k, v in rows.items()
              if FAMILY_RUNS[k][0] in (None, "wmma")}
    return entries, others


# The IMMA kernel's forms at their aims' shapes: (label, family, (B, M, K,
# N) with K logical, forms, the parent kernel's PERF.md time (N1, Y5, S1;
# None: not measured), aim).  forms: "x"/"y" packed panels, "masked" the
# pm* lanes (the mma.sync kernel), "qdot" the kernel at qdot's decode (X the
# (11008, 4096) int8 weight W^T, Y the (4096, M) uint8 activations).
# aim: ("ms", t), or ("natural", f): within f of the same shape's natural
# launch in this run.
IMMA_TARGETS = (
    ("I8GER4 8192^3", "I8GER4", (None, 8192, 8192, 8192), (), 5.3170,
     ("ms", 1.11)),
    ("I8GER4 4096^3", "I8GER4", (None, 4096, 4096, 4096), (), 0.6598,
     ("ms", 0.139)),
    ("I4GER8 8192^3", "I4GER8", (None, 8192, 8192, 8192), (), 5.7177,
     ("ms", 1.11)),
    ("I4GER8 4096^3", "I4GER8", (None, 4096, 4096, 4096), (), 0.6975,
     ("ms", 0.139)),
    ("I16GER2 8192^3", "I16GER2", (None, 8192, 8192, 8192), (), 24.6750,
     ("ms", 4.44)),
    ("I16GER2 4096^3", "I16GER2", (None, 4096, 4096, 4096), (), 3.2880,
     ("ms", 0.556)),
    ("I8GER4 4096^3 Y packed", "I8GER4", (None, 4096, 4096, 4096), ("y",),
     0.6344, ("natural", 1.05)),
    ("I8GER4 4096^3 X+Y packed", "I8GER4", (None, 4096, 4096, 4096),
     ("x", "y"), 0.6308, ("natural", 1.05)),
    ("I8GER4 4096^3 X+Y packed masked", "I8GER4", (None, 4096, 4096, 4096),
     ("x", "y", "masked"), 0.8478, None),
    ("I16GER2 4096^3 X+Y packed", "I16GER2", (None, 4096, 4096, 4096),
     ("x", "y"), None, ("natural", 1.05)),
    ("qdot kernel M=4 4096->11008", "I8GER4", (None, 11008, 4096, 4),
     ("qdot",), 0.0956, ("ms", 0.027)),
    ("qdot kernel M=4 4096->11008 packed X", "I8GER4",
     (None, 11008, 4096, 4), ("qdot", "x"), 0.0889, ("ms", 0.027)),
    ("qdot kernel M=1 4096->11008", "I8GER4", (None, 11008, 4096, 1),
     ("qdot",), None, None),
    ("qdot kernel M=16 4096->11008", "I8GER4", (None, 11008, 4096, 16),
     ("qdot",), None, None),
    ("qdot kernel M=32 4096->11008", "I8GER4", (None, 11008, 4096, 32),
     ("qdot",), None, None),
    ("qdot kernel M=64 4096->11008", "I8GER4", (None, 11008, 4096, 64),
     ("qdot",), None, None),
)


def imma_target_operands(torch, i):
    """IMMA_TARGETS[i]'s operands from seed 601 + i: (x, y, the X the
    kernel reads, mma_gemm's keywords, the Y the kernel reads), full-range
    integers."""
    from repro_torch.core import packing, precision
    _, fam, (b, m, k, n), forms, _, _ = IMMA_TARGETS[i]
    g = torch.Generator(device="cuda").manual_seed(601 + i)
    kind = precision.Ger[fam]
    lead = () if b is None else (b,)
    x, y = _int_operands(torch, g, kind, lead, m, k, n)
    kw = dict(kind=kind)
    if "masked" in forms:
        kw["masks"] = _lane_masks(torch, g, m, n, k)
    xk, yk = x, y
    if "x" in forms:     # qdot's packed W: the X panels of W^T, from W
        w = x.t().contiguous() if "qdot" in forms else x
        po = packing.pack_gemm(w, packing.gemm_layout(
            kind, m, k, side="x", transposed="qdot" in forms))
        xk, kw["x_layout"] = po.data, po.layout
    if "y" in forms:
        po = packing.pack_gemm(y, packing.gemm_layout(kind, k, n))
        yk, kw["y_layout"] = po.data, po.layout
    return x, y, xk, kw, yk


def imma_targets(torch, timer, failures, entries):
    """Phase 6's IMMA_TARGETS through the kernel wrapper: each on the form
    tiling.imma_plan picks, bit for bit the plain version and the
    mma.sync kernel (the form it replaced: an explicit block), the same
    bits twice; timed beside that kernel, ``torch._int_mm`` s8 x s8 at the
    unpacked shape (B row-major, and B column-major: cuBLASLt's int8
    layout; not the same function), the bound, the parent's PERF.md time
    and its aim, met or missed (reported, not failed).  The rows go into
    the phase's entries of each form."""
    from repro_torch.core import precision, tiling
    from repro_torch.kernels import mma_gemm as G

    rows, natural = {}, {}
    for i, (label, fam, (b, m, k, n), forms, parent, aim) in enumerate(
            IMMA_TARGETS):
        x, y, xk, kw, yk = imma_target_operands(torch, i)
        kind = kw["kind"]
        G.mma_gemm.imma_launches_by_form = dict.fromkeys(tiling.IMMA_FORMS,
                                                         0)
        out = G.mma_gemm(xk, yk, **kw)
        torch.cuda.synchronize()
        form = [f for f, v in G.mma_gemm.imma_launches_by_form.items() if v]
        form = form[0] if len(form) == 1 else str(form)
        want = "mma" if "masked" in forms else (
            "stream" if "qdot" in forms and n <= 64 else "tile")
        _check(failures, f"imma {label}", form == want,
               f"on the {form} form (want {want})")
        masks = kw.get("masks")
        _check(failures, f"imma {label}", torch.equal(
            out, G.mma_gemm_plain(x, y, kind=kind, masks=masks)),
            "bit for bit the plain version")
        old_kw = dict(kw, block=tiling.GEMM_TILES[kind][0])
        old = G.mma_gemm(xk, yk, **old_kw)
        _check(failures, f"imma {label}", torch.equal(out, old),
               "bit for bit the mma.sync kernel (explicit block)")
        _check(failures, f"imma {label}",
               torch.equal(G.mma_gemm(xk, yk, **kw), out),
               "two launches the same bits")
        del old
        pol = precision.policy(kind)
        s8 = torch.randint(-128, 128, (k, n), device="cuda",
                           dtype=torch.int8)
        a8 = torch.randint(-128, 128, (m, k), device="cuda",
                           dtype=torch.int8)
        s8t = s8.t().contiguous().t()          # column-major B
        ms = timer(lambda xk=xk, yk=yk, kw=kw: G.mma_gemm(xk, yk, **kw))
        row = {"ms": ms, "form": form,
               "replaced_ms": timer(lambda xk=xk, yk=yk, kw=old_kw:
                                    G.mma_gemm(xk, yk, **kw)),
               "parent_ms": parent}
        if m % 8 == 0 and n % 8 == 0 and k % 8 == 0 and m >= 17:
            row["library_ms"] = timer(lambda: torch._int_mm(a8, s8))
            row["int_mm_col_major_ms"] = timer(
                lambda: torch._int_mm(a8, s8t))
        else:
            row["library_ms"] = None
        row["library"] = "torch._int_mm s8 x s8 (not the same function)"
        del s8, a8, s8t
        products = 4 if fam == "I16GER2" else 1
        in_bytes = sum(t.numel() * t.element_size() for t in (x, y))
        if masks is not None:
            mo, no, ko = (int(t.sum()) for t in masks)
            in_bytes = (mo * ko * x.element_size() + ko * no
                        * y.element_size())
            ops = 2 * mo * no * ko
        else:
            ops = 2 * m * n * k * products
        row["bound_ms"], row["bound_by"] = bound_ms(in_bytes + 4 * m * n,
                                                    ops, "int8")
        if not forms:
            natural[(fam, m, k, n)] = ms
        nat = natural.get((fam, m, k, n))
        met = None
        if aim is not None:
            goal = aim[1] if aim[0] == "ms" else aim[1] * (nat or 0)
            met = ms <= goal if (aim[0] == "ms" or nat) else None
            row["aim_ms"] = goal
        row["aim_met"] = met
        # the plan the natural operands take (a packed call follows it)
        row["plan"] = str(tiling.choose_gemm_path(
            m, n, x.shape[-1], kind, b or 1, G.natural_aligned(x, y), None,
            masks is not None, None, G.tma_aligned(x))[1])
        rows[label] = row
        print(f"  time imma {label}: {ms:.4f} ms on the {form} form "
              f"({row['plan']}), "
              f"the mma.sync kernel {row['replaced_ms']:.4f} ms (parent in "
              f"PERF.md: {'not measured' if parent is None else f'{parent} ms'}"
              f"), torch._int_mm "
              + (f"{row['library_ms']:.4f} ms (B column-major "
                 f"{row['int_mm_col_major_ms']:.4f} ms)"
                 if row["library_ms"] is not None else "n/a")
              + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{row['bound_ms'] / ms:.2f} of bound"
              + ("" if aim is None else
                 f"; aim {'met' if met else 'MISSED' if met is not None else 'n/a'}"
                 f" (<= {row['aim_ms']:.4f} ms)"), flush=True)
        del x, y, xk, yk, out
        torch.cuda.empty_cache()
    for e in entries:
        if e["name"] in PATH_ENTRIES:
            form = PATH_ENTRIES[e["name"]][1]
            e["targets"] = {lb: r for lb, r in rows.items()
                            if r["form"] == form}


# ----------------------------------------------------------------------
# Phase 7: prepacked serving (ROADMAP slice C4: core/packing.py, K1d and
# K3's packed filter stream)
# ----------------------------------------------------------------------

# The serving launcher's --prepack threshold.
PREPACK_MIN = 1024
# Decode steps of the prepacked step runs (deepseek-moe-16b, whisper-small,
# qwen2-vl-7b), after one prefill.
PREPACK_STEPS = 4
# Per phase-7 run: its packed launches by path, its pack time and stats.
PHASE7: dict[str, dict] = {}


@contextlib.contextmanager
def recording_steps(into):
    """Record every prefill's last logits and every decode tick's tokens
    and logits of ``serve_loop`` (``train.steps``' step factories) into
    the list ``into`` while the block runs."""
    from repro_torch.train import steps as ST

    made = (ST.make_prefill_step, ST.make_serve_step)

    def prefill_factory(cfg):
        step = made[0](cfg)

        def run(model, batch):
            last, pre = step(model, batch)
            into.append(("prefill", last.clone()))
            return last, pre
        return run

    def serve_factory(cfg):
        step = made[1](cfg)

        def run(model, cache, tokens):
            nxt, logits, cache = step(model, cache, tokens)
            into.append(("decode", nxt.clone(), logits.clone()))
            return nxt, logits, cache
        return run

    ST.make_prefill_step, ST.make_serve_step = prefill_factory, serve_factory
    try:
        yield into
    finally:
        ST.make_prefill_step, ST.make_serve_step = made


def zero_counts(kernels):
    """Zero every launch count, by path, on packed operands, with pm*
    masks and attention's by mode (no traces: the phase-7 and phase-8
    runs are not RECORDS)."""
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G
    for fn in kernels.values():
        fn.launches = 0
    for name in BY_PATH:
        kernels[name].launches_by_path = dict.fromkeys(
            kernels[name].launches_by_path, 0)
    G.mma_gemm.packed_launches_by_path = dict.fromkeys(G.PACKED_PATHS, 0)
    G.mma_gemm.masked_launches_by_path = dict.fromkeys(G.MASKED_PATHS, 0)
    A.mma_flash_attention.launches_by_mode = dict.fromkeys(A.MODES, 0)
    K.mma_conv2d.packed_launches_by_path = dict.fromkeys(K.CONV_PATHS, 0)


def read_counts(kernels):
    """A run's launches, by path, on packed operands, with pm* masks and
    attention's by mode, just after it."""
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G
    return {"launches": {k: f.launches for k, f in kernels.items()},
            "by_path": {n: dict(kernels[n].launches_by_path)
                        for n in BY_PATH},
            "packed": {**{f"gemm {p}": v for p, v in
                          G.mma_gemm.packed_launches_by_path.items()},
                       **{f"conv {p}": v for p, v in
                          K.mma_conv2d.packed_launches_by_path.items()}},
            "masked": dict(G.mma_gemm.masked_launches_by_path),
            "attn_by_mode": dict(A.mma_flash_attention.launches_by_mode)}


def pack_model(torch, arch, model):
    """``prepack_params_for_serving`` in place, timed (host clock around a
    synchronised pass); returns (stats, seconds, the counters after)."""
    from repro_torch.core import facility, packing

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with facility.configure(facility.FacilityConfig(device="cuda")):
        stats = packing.prepack_params_for_serving(model,
                                                   min_size=PREPACK_MIN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"  phase 7: {arch} packed in place in {dt:.3f} s: {stats}; "
          f"device memory {mem0 / 2**30:.2f} -> "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return stats, dt, dict(packing.COUNTERS)


def _relayouts(after, before):
    """The packs, repacks, invalidations and demotes since ``before``."""
    keys = ("pack", "repack", "invalidate", "demote")
    return {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def _check(failures, name, ok, what):
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: {what}")
    if not ok:
        failures.append(f"{name}: {what}")


def steps_in_turn(torch, models, cfg, settings, rounds=15):
    """Each model's batch-1 prefill and decode step (serve_steps' closures),
    the models in turn, so that all meet the same host load: ``{(name,
    "prefill" | "decode"): host-clock ms of its unprofiled steps}`` over
    5 prefill rounds and ``rounds`` decode rounds, and ``{name: device
    busy ms of one profiled decode step, or None where the profiler
    recorded none}``."""
    from repro_torch.core import facility

    steps = {k: serve_steps(torch, m, cfg, settings)[:2]
             for k, m in models.items()}
    host = {}
    dev = {}
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for which, n in ((0, 5), (1, rounds)):
            for _ in range(n):
                for k, fns in steps.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fns[which]()
                    torch.cuda.synchronize()
                    host.setdefault((k, ("prefill", "decode")[which]),
                                    []).append(
                        (time.perf_counter() - t0) * 1e3)
        for k, (_, decode) in steps.items():
            got = profile_step(torch, f"decode step ({k})", decode,
                               sorted(host[k, "decode"])[rounds // 2])
            dev[k] = None if got is None else got[0]
    return host, dev


# Serves of deepseek-7b in phase 7, natural and packed in turn (ABBA, so
# that a drift of the host's load over the six weighs on both alike).
PREPACK_SERVES = ("natural", "packed", "packed", "natural", "natural",
                  "packed")


def prepacked_serve(torch, failures, arch, settings, model, cfg, natural):
    """deepseek-7b packed in place (a copy of phase 3's model, which stays
    natural beside it) and served with phase 3's settings, in turn with
    the natural model (PREPACK_SERVES): the first packed serve's tokens
    and every logit bit for bit those of phase 3's natural run
    (``natural``: its stats, counts and recorded steps), each packed
    serve's launches by path phase 3's, and no pack, repack or demote
    while serving; pack time and bytes, each serve's decode tok/s and a
    decode step's device and host time, natural beside packed."""
    import copy

    from repro_torch.core import facility, packing
    from repro_torch.launch import serve as S

    packed = copy.deepcopy(model)
    stats, pack_s, before = pack_model(torch, arch, packed)
    kernels = kernel_wrappers()
    name = f"{arch} prepacked serve"
    tok_s = {"natural": [], "packed": []}
    for i, which in enumerate(PREPACK_SERVES):
        first = which == "packed" and not tok_s["packed"]
        rec = []
        with facility.configure(facility.FacilityConfig(device="cuda")), \
                (recording_steps(rec) if first
                 else contextlib.nullcontext()):
            zero_counts(kernels)
            out = S.serve_loop(cfg, packed if which == "packed" else model,
                               **settings)
            counts = read_counts(kernels)
        tok_s[which].append(out["tokens_per_s"])
        print(f"  phase 7: serve {i + 1} ({which}) {settings}: "
              f"{json.dumps(out)}")
        if which == "natural":
            continue
        print(f"  phase 7: launches {counts['launches']}, by path "
              f"{counts['by_path']['mma_gemm']}, on packed panels "
              f"{counts['packed']}")
        if first:
            same = (len(rec) == len(natural["record"]) and all(
                len(a) == len(b) and a[0] == b[0]
                and all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
                for a, b in zip(rec, natural["record"])))
            _check(failures, name, same and out["completed"] == settings[
                "n_requests"], f"{len(rec)} prefill/decode outputs (token "
                f"ids and logits) bit for bit those of phase 3's natural "
                f"run")
            packed_counts = counts["packed"]
        _check(failures, name, counts["launches"] == natural["launches"]
               and counts["by_path"] == natural["by_path"],
               f"serve {i + 1}: launches and launches by path equal "
               f"phase 3's")
        _check(failures, name, counts["packed"]["gemm stream"] > 0
               and counts["packed"]["gemm wgmma"] > 0,
               f"serve {i + 1}: decode products on packed panels on the "
               f"weight stream, prefill products on the wgmma tile")
    moved = _relayouts(dict(packing.COUNTERS), before)
    _check(failures, name, not any(moved.values()),
           f"packing counters while serving: {moved} (all 0)")
    host, dev = steps_in_turn(
        torch, {"natural": model, "packed": packed}, cfg, settings)
    del packed
    steps = {f"{k} {what}": {"median": sorted(v)[len(v) // 2],
                             "min": min(v)}
             for (k, what), v in host.items()}
    print(f"  phase 7: {arch} decode tok/s by serve, in turn "
          f"{PREPACK_SERVES}: natural {tok_s['natural']}, packed "
          f"{tok_s['packed']} (phase 3's natural "
          f"{natural['stats']['tokens_per_s']:.2f}); batch-1 prefill (5 "
          f"each) and decode step (15 each), in turn, host ms: "
          + ", ".join(f"{k} median {v['median']:.3f} min {v['min']:.3f}"
                      for k, v in steps.items())
          + f"; device busy of a decode step {dev['packed']} ms packed vs "
          f"{dev['natural']} natural")
    PHASE7[name] = {"packed": packed_counts, "pack_s": pack_s,
                    "stats": stats, "tok_s": tok_s["packed"],
                    "tok_s_natural": tok_s["natural"],
                    "tok_s_phase3": natural["stats"]["tokens_per_s"],
                    "host_ms": steps,
                    "decode_device_ms": dev["packed"],
                    "decode_device_ms_natural": dev["natural"]}


def prepacked_steps(torch, failures, arch, model, cfg, batch, seq_len):
    """One prefill and PREPACK_STEPS greedy decode steps on ``batch``
    (phase 3's inputs) before and after packing ``model`` in place: every
    logit bit for bit, the same launches by path, no pack, repack or
    demote in the packed run, and the packed panels and filter streams
    launched."""
    from repro_torch.core import facility, packing
    from repro_torch.models import model as M

    kernels = kernel_wrappers()
    b = batch["tokens"].shape[0]

    def run():
        with facility.configure(facility.FacilityConfig(device="cuda")):
            zero_counts(kernels)
            last, pre = M.prefill(model, batch, cfg)
            if cfg.is_enc_dec or cfg.vision_prefix:
                cache = handoff(torch, cfg, pre, b, seq_len, torch.bfloat16)
            else:
                cache = M.init_cache(cfg, b, seq_len, device="cuda")
            del pre
            outs = [last]
            tok = last.argmax(-1, keepdim=True).to(torch.int32)
            for _ in range(PREPACK_STEPS):
                logits, cache = M.decode_step(model, cache, tok, cfg)
                outs.append(logits)
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            return outs, read_counts(kernels)

    nat, nat_counts = run()
    stats, pack_s, before = pack_model(torch, arch, model)
    pk, counts = run()
    moved = _relayouts(dict(packing.COUNTERS), before)
    name = f"{arch} prepacked prefill + {PREPACK_STEPS} decode steps"
    print(f"  phase 7: {name}: launches {counts['launches']}, GEMM by path "
          f"{counts['by_path']['mma_gemm']}, on packed panels "
          f"{counts['packed']}")
    _check(failures, name, len(nat) == len(pk) and all(
        torch.equal(x, y) for x, y in zip(nat, pk)),
        "prefill and decode logits bit for bit the natural run's")
    _check(failures, name, counts["launches"] == nat_counts["launches"]
           and counts["by_path"] == nat_counts["by_path"],
           "launches and launches by path equal the natural run's")
    _check(failures, name, not any(moved.values()),
           f"packing counters in the packed run: {moved} (all 0)")
    stems = cfg.is_enc_dec or cfg.vision_prefix
    _check(failures, name, counts["packed"]["gemm stream"] > 0 and (
        not stems or counts["packed"]["conv wgmma"] > 0),
        "decode products on packed panels"
        + (", the conv stem on K3's packed filter stream" if stems else ""))
    PHASE7[name] = {"packed": counts["packed"], "pack_s": pack_s,
                    "stats": stats}


def qdot_packed_run(torch, failures):
    """quant.qdot on a weight prepacked as X-side I8GER4 panels
    (``prepack_params_for_serving(quantize=True)``'s form) at
    deepseek-7b's MLP up-projection, M = 4 and 1024, through the entry
    point: counts zeroed just before and read just after; the output bit
    for bit the natural qdot's, no demote, the IMMA kernel on packed
    panels.  Returns the operands for the timings."""
    from repro_torch.core import facility, packing
    from repro_torch.core import quant as Q

    g = torch.Generator(device="cuda").manual_seed(11)
    k, n = 4096, 11008
    w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
    wq, ws = Q.quantize_weight(w)
    lay = packing.gemm_layout(facility.Ger.I8GER4, n, k, side="x",
                              transposed=True)
    po = packing.pack_gemm(wq, lay, scale=ws,
                           col_sum=wq.to(torch.int32).sum(0).float())
    xs = {m: torch.randn(m, k, generator=g, device="cuda")
          for m in (4, 1024)}
    kernels = kernel_wrappers()
    with facility.configure(facility.FacilityConfig(device="cuda")):
        nat = {m: Q.qdot(x, wq, ws) for m, x in xs.items()}
        before = dict(packing.COUNTERS)
        zero_counts(kernels)
        pk = {m: Q.qdot(x, po) for m, x in xs.items()}
        torch.cuda.synchronize()
        counts = read_counts(kernels)
    moved = _relayouts(dict(packing.COUNTERS), before)
    name = "qdot prepacked (M = 4, 1024)"
    _check(failures, name, all(torch.equal(nat[m], pk[m]) for m in xs),
           "bit for bit the natural qdot's")
    _check(failures, name, not any(moved.values())
           and counts["packed"]["gemm imma"] == 2,
           f"packed launches {counts['packed']}, packing counters {moved}")
    PHASE7[name] = {"packed": counts["packed"]}
    return w, wq, ws, po, xs


def phase7_kernels(torch, timer, failures, qdot_ops):
    """Each packed kernel mode against its natural launch (bit for bit)
    and its plain version (``_report_close``), timed (CUDA events, L2
    flushed) beside the natural launch, the plain version, the library
    call and the bound; ``qdot`` timed whole, natural (its W^T copy)
    beside packed.  Returns the ``kernels`` entries of the packed
    modes."""
    from repro_torch.core import facility, packing
    from repro_torch.core import quant as Q
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(12)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    def ypack(w, batched=False):
        k, n = w.shape[-2:]
        return packing.pack_gemm(w, packing.gemm_layout(
            Ger.BF16GER2, k, n, batched=batched))

    rows = {}

    def mode(key, label, natural, packed, plain, library, nbytes, ops,
             peak, out_dtype):
        want = natural()
        got = packed()
        torch.cuda.synchronize()
        _check(failures, label, torch.equal(got, want),
               "bit for bit the natural launch")
        err = _report_close(torch, f"{label} vs plain", got.float(),
                            plain().float(), out_dtype, failures)
        row = {"ms": timer(packed), "natural_ms": timer(natural),
               "plain_ms": timer(plain),
               "library_ms": timer(library) if library else None}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, peak)
        print(f"  time {label}: packed {row['ms']:.4f} ms, natural "
              f"{row['natural_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.setdefault(key, {})[label] = (row, err)

    kw = dict(kind=Ger.BF16GER2, out_dtype=torch.bfloat16)
    m, k, n = SERVE["batch"], 4096, 11008
    x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
    po = ypack(w)
    mode("stream", f"stream packed Y {m}x{k}x{n}",
         lambda: G.mma_gemm(x, w, **kw),
         lambda: G.mma_gemm(x, po.data, y_layout=po.layout, **kw),
         lambda: G.mma_gemm_plain(x, w, **kw), lambda: torch.matmul(x, w),
         (m * k + k * n + m * n) * 2, 2 * m * n * k, "bf16", torch.bfloat16)
    xb, wb = randn(64, 1, 2048), randn(64, 2048, 1408, scale=2048 ** -0.5)
    pb = ypack(wb, batched=True)
    mode("stream", "stream packed Y bank 64x1x2048x1408",
         lambda: G.mma_gemm(xb, wb, **kw),
         lambda: G.mma_gemm(xb, pb.data, y_layout=pb.layout, **kw),
         lambda: G.mma_gemm_plain(xb, wb, **kw),
         lambda: torch.matmul(xb, wb),
         (64 * 2048 + 64 * 2048 * 1408 + 64 * 1408) * 2,
         2 * 64 * 2048 * 1408, "bf16", torch.bfloat16)
    del xb, wb, pb
    xw = randn(1024, k)
    mode("wgmma", f"wgmma packed Y 1024x{k}x{n}",
         lambda: G.mma_gemm(xw, w, **kw),
         lambda: G.mma_gemm(xw, po.data, y_layout=po.layout, **kw),
         lambda: G.mma_gemm_plain(xw, w, **kw), lambda: torch.matmul(xw, w),
         (1024 * k + k * n + 1024 * n) * 2, 2 * 1024 * n * k, "bf16",
         torch.bfloat16)
    # Host time of one call (enqueue only, 200 calls), natural beside
    # packed, in turn, 7 rounds (median and min): the wrapper alone, and
    # the whole facility.contract dispatch (admission, the normalizer,
    # refresh, the wrapper's one path choice) at decode and prefill M.
    calls = {}
    for where, xx in (("decode (stream)", x), ("prefill (wgmma)", xw)):
        calls[f"mma_gemm {where} natural"] = \
            lambda xx=xx: G.mma_gemm(xx, w, **kw)
        calls[f"mma_gemm {where} packed"] = \
            lambda xx=xx: G.mma_gemm(xx, po.data, y_layout=po.layout, **kw)
        calls[f"contract {where} natural"] = \
            lambda xx=xx: facility.contract("mk,kn->mn", xx, w)
        calls[f"contract {where} packed"] = \
            lambda xx=xx: facility.contract("mk,kn->mn", xx, po)
    host = {}
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for _ in range(7):
            for label, fn in calls.items():
                host.setdefault(label, []).append(host_us(torch, fn))
    host = {label: {"median": sorted(v)[3], "min": min(v)}
            for label, v in host.items()}
    print("  host us per call, natural and packed in turn (median, min "
          "of 7): " + ", ".join(f"{label} {v['median']:.1f}, "
                                f"{v['min']:.1f}"
                                for label, v in host.items()))
    del x, w, po, xw, calls
    # whisper-small's conv2 (k3 s2 over 3000 frames, SAME: 3001 padded
    # frames), bias + gelu, bf16 out
    img = randn(4, 1, 3001, 768)
    wc = randn(1, 3, 768, 768, scale=(3 * 768) ** -0.5)
    pc = packing.pack_conv(wc[0], packing.conv_layout(
        Ger.BF16GER2, 1, 3, 768, 768, nd=1))
    bias = randn(768, dtype=torch.float32)
    ep = E.Epilogue(bias=True, activation="gelu")
    ckw = dict(stride=(1, 2), ep=ep, bias=bias, out_dtype=torch.bfloat16)
    # cuDNN as phase 2 times it: channels-last NCHW views, the bias
    w_nchw = wc.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x_nchw = img.permute(0, 3, 1, 2)
    b16 = bias.to(img.dtype)
    ow = 1500
    mode("conv", "K3 packed filters whisper conv2 4x3001x768 k3 s2",
         lambda: K.mma_conv2d(img, wc, **ckw),
         lambda: K.mma_conv2d(img, pc.data, w_layout=pc.layout, **ckw),
         lambda: K.mma_conv2d_plain(img, wc, **ckw),
         lambda: torch.nn.functional.conv2d(x_nchw, w_nchw, b16,
                                            stride=(1, 2)),
         (4 * 3001 * 768 + 3 * 768 * 768 + 4 * ow * 768) * 2 + 768 * 4,
         2 * 4 * ow * 768 * 3 * 768, "bf16", torch.bfloat16)
    del img, wc, pc, x_nchw, w_nchw

    # qdot: the whole call natural (its W^T copy) and packed (none), and
    # the IMMA kernel alone on natural W^T and on packed panels
    w, wq, ws, pq, xs = qdot_ops
    qdot_rows = {}
    for m, x in xs.items():
        xq, _, _ = Q.quantize_act_u8(x)
        xt = xq.t().contiguous()
        wt = wq.t().contiguous()
        ikw = dict(kind=Ger.I8GER4)

        def whole(wgt, scale, x=x):
            with facility.configure(facility.FacilityConfig(device="cuda")):
                Q.qdot(x, wgt, scale)

        def torch_qdot(x=x):
            with facility.configure(facility.FacilityConfig(device="cuda")):
                Q.qdot(x, wq, ws, backend="torch")

        xb16, wb16 = x.bfloat16(), w.bfloat16()
        mode("imma", f"IMMA packed X qdot M={m} ({m}x4096x11008)",
             lambda: G.mma_gemm(wt, xt, **ikw),
             lambda: G.mma_gemm(pq.data, xt, x_layout=pq.layout, **ikw),
             lambda: G.mma_gemm_plain(wt, xt, **ikw),
             lambda: torch.matmul(xb16, wb16),
             m * k + k * n + 4 * m * n, 2 * m * n * k, "int8", torch.int32)
        row = {"qdot_ms": timer(lambda: whole(pq, None)),
               "qdot_natural_ms": timer(lambda: whole(wq, ws)),
               "qdot_torch_ms": timer(torch_qdot),
               "copy_w_ms": timer(lambda: wq.t().contiguous())}
        qdot_rows[f"M={m}"] = row
        print(f"  time qdot M={m} whole call: packed {row['qdot_ms']:.4f} "
              f"ms (no W^T copy), natural {row['qdot_natural_ms']:.4f} ms "
              f"(its W^T copy alone {row['copy_w_ms']:.4f} ms), torch "
              f"backend {row['qdot_torch_ms']:.4f} ms")
    del w, wq, pq

    sources = {"stream": ("src/repro_torch/csrc/gemm_stream.cu",
                          "src/repro/kernels/mma_gemm.py:333"),
               "wgmma": ("src/repro_torch/csrc/gemm_wgmma.cu",
                         "src/repro/kernels/mma_gemm.py:333"),
               "imma": ("src/repro_torch/csrc/gemm_imma.cu",
                        "src/repro/kernels/mma_gemm.py:333"),
               "conv": ("src/repro_torch/csrc/mma_conv.cu",
                        "src/repro/kernels/mma_conv.py:176")}
    names = {"stream": "mma_gemm packed Y (stream)",
             "wgmma": "mma_gemm packed Y (wgmma)",
             "imma": "mma_gemm packed X (imma)",
             "conv": "mma_conv2d packed filters (wgmma)"}
    counter = {"stream": "gemm stream", "wgmma": "gemm wgmma",
               "imma": "gemm imma", "conv": "conv wgmma"}
    entries = []
    for key, by_label in rows.items():
        label, (row, _) = next(iter(by_label.items()))
        e = {"name": names[key], "route": "cuda", "source": sources[key][0],
             "replaces": sources[key][1],
             "max_abs_err": max(err for _, err in by_label.values()),
             **row, "shape": label,
             "launches_by_run": {r: v["packed"][counter[key]]
                                 for r, v in PHASE7.items()},
             "timed": {lb: r for lb, (r, _) in by_label.items()}}
        if key == "imma":
            e["qdot"] = qdot_rows
        if key == "stream":
            e["host_us"] = host
        e["launches"] = sum(e["launches_by_run"].values())
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched in phase 7's runs")
        entries.append(e)
    return entries



# ----------------------------------------------------------------------
# Phase 8: the pm* masked forms (K1b) and the tight-parity F32GER config on
# the card (K2e: the attention kernel's fp32 tile)
# ----------------------------------------------------------------------

# The tight-parity config's runs, FacilityConfig(ger=F32GER,
# out_dtype=float32), each at full width: (a) deepseek-7b at full depth
# through serve_loop and (b) whisper-small at full depth through prefill
# and decode_step, both on phase 3's models (their bf16 weights cast per
# call by the F32GER policy) before phase 7 packs them; (c) two train
# steps of deepseek-7b cut to 4 layers through launch.train.build.
F32_SERVE = dict(batch=4, prompt_len=256, gen_len=12, n_requests=2)
F32_GEN = dict(batch=4, frames=3000, prompt_len=4, gen_len=8)
F32_TRAIN = ("deepseek-7b", 4, dict(batch=4, seq=512, steps=2))
# The tolerances, stated before the first run on the card: the kernel
# backend's logits, step-1 loss and step-1 gradients (each leaf) against
# the eager torch backend in the same config, relative L2.  Both backends
# compute in fp32 (bf16 weights and the embedding are exact in it); their
# sums run in other orders, about sqrt(K) * 2^-24 relative a product, and
# the difference travels through the layers.
F32_TOL = {"logits": 1e-4, "grads": 1e-4}
# Per phase-8 run: its launches by kernel, path, mode and mask.
PHASE8: dict[str, dict] = {}
# The masked products (K1b) at deepseek-7b's MLP shapes, in its bf16
# policy, and the other families' paths: (name, family, batch, M, K, N,
# with a seed).  About 30% of the lanes of each mask are off.
MASKED_CASES = (
    ("bf16 decode MLP", "BF16GER2", None, 4, 4096, 11008, False),
    ("bf16 prefill MLP", "BF16GER2", None, 1024, 4096, 11008, False),
    ("F32GER", "F32GER", None, 1024, 4096, 4096, False),
    ("F32GER batched + seed", "F32GER", 8, 256, 1024, 1024, True),
    ("I8GER4", "I8GER4", None, 4096, 4096, 4096, False),
    ("F64GER", "F64GER", None, 2048, 2048, 2048, False),
)
# K2e at the F32GER runs' attention shapes: (name, q shape, k/v shape,
# causal, the parent kernel's time in PERF.md section 6 (NVIDIA H100 80GB
# HBM3 at 700 W: printed for the reader, never put in the kernels line;
# None: not there), the aim in ms or None).
F32_ATTENTION = (
    ("deepseek-7b prefill", (1, 256, 32, 128), (1, 256, 32, 128), True,
     0.0575, 0.034),
    ("deepseek-7b logits check prefill", (4, 256, 32, 128),
     (4, 256, 32, 128), True, None, None),
    ("deepseek-7b train", (4, 512, 32, 128), (4, 512, 32, 128), True,
     0.4907, 0.28),
    ("whisper-small encoder", (4, 1500, 12, 64), (4, 1500, 12, 64), False,
     1.0741, 0.85),
    ("whisper-small cross prompt", (4, 4, 12, 64), (4, 1500, 12, 64), False,
     None, None),
    ("whisper-small cross decode", (4, 1, 12, 64), (4, 1500, 12, 64), False,
     0.0676, 0.0676),
)


def f32_config(torch, **kw):
    from repro_torch.core import facility
    return facility.FacilityConfig(device="cuda", ger=facility.Ger.F32GER,
                                   out_dtype=torch.float32, **kw)


@contextlib.contextmanager
def tracing_gemm():
    """The GEMM wrapper's trace of (batch, M, K, N, dtype, out dtype,
    path) a launch while the block runs (a list, yielded)."""
    from repro_torch.kernels import mma_gemm as G
    G.mma_gemm.trace = []
    try:
        yield G.mma_gemm.trace
    finally:
        G.mma_gemm.trace = None


def f32_path_of(m, k) -> str:
    """Where an unmasked F32GER product runs on the card: the fp32 weight
    stream at M <= 64 (K of at least one MMA step), else the fp32 tile
    (the "wmma" path's F32GER tiles)."""
    from repro_torch.core import tiling
    return ("stream" if m <= tiling.STREAM_MAX_M and k >= tiling.MIN_K
            else "wmma")


def check_f32_counts(failures, run, counts, model_counts, modes, trace):
    """A phase-8 F32GER run's launches: the per-call model's counts, each
    GEMM (``trace``: the wrapper's record of every launch) on its fp32
    path, the stream at M <= 64 and the fp32 tile above (``f32_path_of``,
    never a tensor-core path), and attention's by mode (the fp32 tile,
    K2e)."""
    gemm = counts["by_path"]["mma_gemm"]
    off = sorted({(b, m, k, n, path) for b, m, k, n, dt, _, path in trace
                  if path != f32_path_of(m, k) or str(dt) != "torch.float32"},
                 key=str)
    got_modes = {m: n for m, n in counts["attn_by_mode"].items() if n}
    ok = (counts["launches"] == model_counts and not off
          and len(trace) == counts["launches"]["mma_gemm"]
          and got_modes == modes)
    print(f"  [{'ok' if ok else 'FAIL'}] phase 8: {run}: launches "
          f"{counts['launches']} (per-call model {model_counts}); GEMM by "
          f"path {gemm}, each of the {len(trace)} on its fp32 path (stream "
          f"at M <= 64, the fp32 tile above)"
          + (f"; off path: {off[:8]}" if off else "")
          + f"; attention by mode {got_modes} (want {modes}); conv by path "
          f"{counts['by_path']['mma_conv2d']}")
    if not ok:
        failures.append(f"{run} launches")
    PHASE8[run] = counts


def _check_rel(failures, run, what, got, want, tol) -> float:
    r = _rel(got, want)
    ok = bool(got.isfinite().all()) and r <= tol
    print(f"  [{'ok' if ok else 'FAIL'}] phase 8: {run} {what} "
          f"{tuple(got.shape)}: kernel vs torch backend rel L2 {r:.3e} "
          f"(tol {tol:.0e})")
    if not ok:
        failures.append(f"{run} {what}")
    return r


def _greedy(torch, model, cfg, batch, seq_len, gen, fcfg, tokens):
    """Prefill, the cache handoff (f32) and ``gen`` decode steps under
    ``fcfg``: greedy where ``tokens`` is an empty list (which then records
    them), else teacher-forced with them.  Returns the prefill's and the
    last step's logits."""
    from repro_torch.core import facility
    from repro_torch.models import model as M

    b = next(iter(batch.values())).shape[0]
    with facility.configure(fcfg):
        last, pre = M.prefill(model, batch, cfg)
        cache = handoff(torch, cfg, pre, b, seq_len, torch.float32)
        del pre
        forced = bool(tokens)
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        for i in range(gen):
            if forced:
                tok = tokens[i]
            else:
                tokens.append(tok)
            logits, cache = M.decode_step(model, cache, tok, cfg)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    del cache
    return last.float(), logits[:, -1].float()


def f32_serve(torch, failures, model, cfg):
    """(a) deepseek-7b served through serve_loop in the tight-parity
    config, launches held to the per-call model with every GEMM on its
    fp32 path (decode's on the weight stream, the 256-token prefills' on
    the fp32 tile) and every prefill attention on K2e's fp32 tile; then a
    batch-4 prompt of 256 tokens through prefill and F32_SERVE's decode
    steps, greedy on the kernel backend and teacher-forced with its tokens
    on the eager torch backend: the prefill's and the last step's logits
    within F32_TOL of each other."""
    from repro_torch.core import facility
    from repro_torch.launch import serve as S

    kernels = kernel_wrappers()
    want = expected_launches(cfg)
    run = f"{cfg.name} F32GER serve"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = []
    with facility.configure(f32_config(torch)), recording_steps(rec), \
            tracing_gemm() as trace:
        zero_counts(kernels)
        stats = S.serve_loop(cfg, model, **F32_SERVE)
        torch.cuda.synchronize()
        counts = read_counts(kernels)
    print(f"  phase 8: {run} {F32_SERVE}: {json.dumps(stats)} "
          f"({time.perf_counter() - t0:.1f} s)")
    pre, steps = stats["completed"], stats["steps"]
    model_counts = {k: pre * want["prefill"].get(k, 0)
                    + steps * want["decode"].get(k, 0) for k in kernels}
    check_f32_counts(failures, run, counts, model_counts,
                     {"f32_tile": pre * cfg.num_layers}, trace)
    if pre != F32_SERVE["n_requests"]:
        failures.append(f"{run}: served {pre} of "
                        f"{F32_SERVE['n_requests']} requests")
    b, p, gen = (F32_SERVE[k] for k in ("batch", "prompt_len", "gen_len"))
    g = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=g,
                           device="cuda", dtype=torch.int32)
    tokens = []
    t0 = time.perf_counter()
    outs = {be: _greedy(torch, model, cfg, {"tokens": prompt}, p + gen, gen,
                        f32_config(torch, backend=be), tokens)
            for be in ("kernel", "torch")}
    rel = [_check_rel(failures, run, what, outs["kernel"][i],
                      outs["torch"][i], F32_TOL["logits"])
           for i, what in enumerate(("prefill logits",
                                     f"decode step {gen} logits"))]
    print(f"  phase 8: {run} logits check: batch {b} x {p} prompt, {gen} "
          f"steps ({time.perf_counter() - t0:.1f} s)")
    PHASE8[run]["rel_l2"] = rel
    return {"stats": stats, "counts": counts, "record": rec}


def f32_generate(torch, failures, model, cfg):
    """(b) whisper-small in the tight-parity config: a batch-4 prefill over
    3000 mel frames (the encoder's attention on the fp32 tile, the
    decoder's cross-attention on fp32 split-KV), the handoff and
    F32_GEN's greedy decode steps (each step's cross-attention on fp32
    split-KV), launches held to the per-call model, each GEMM on its fp32
    path (the encoder's on the fp32 tile, the decoder's 16-row prefill
    and 4-row steps on the weight stream); then the same inputs,
    teacher-forced, on the eager torch backend: the prefill's and the
    last step's logits within F32_TOL."""
    b, gen = F32_GEN["batch"], F32_GEN["gen_len"]
    batch, seq_len = mm_batch(cfg, F32_GEN, b)
    kernels = kernel_wrappers()
    want = expected_launches(cfg)
    run = f"{cfg.name} F32GER generate"
    tokens = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tracing_gemm() as trace:
        zero_counts(kernels)
        got = _greedy(torch, model, cfg, batch, seq_len, gen,
                      f32_config(torch), tokens)
        torch.cuda.synchronize()
        counts = read_counts(kernels)
    t1 = time.perf_counter()
    model_counts = {k: want["prefill"].get(k, 0)
                    + gen * want["decode"].get(k, 0) for k in kernels}
    e, n = cfg.encoder_layers, cfg.num_layers
    print(f"  phase 8: {run} {F32_GEN}: prefill + {gen} steps "
          f"{t1 - t0:.2f} s; first request's tokens "
          f"{torch.cat(tokens, 1)[0].tolist()}")
    check_f32_counts(failures, run, counts, model_counts,
                     {"f32_tile": e + n, "f32_split": n + gen * n}, trace)
    ref = _greedy(torch, model, cfg, batch, seq_len, gen,
                  f32_config(torch, backend="torch"), tokens)
    PHASE8[run]["rel_l2"] = [
        _check_rel(failures, run, what, got[i], ref[i], F32_TOL["logits"])
        for i, what in enumerate(("prefill logits",
                                  f"decode step {gen} logits"))]


def f32_train(torch, failures):
    """(c) deepseek-7b at full width cut to 4 layers, trained through
    ``launch.train.build`` in the tight-parity config: step 1's loss and
    every gradient leaf on the kernel backend within F32_TOL of the eager
    torch backend's (same config, same weights), then two steps with the
    launches held to the per-step model (every GEMM, backward included, on
    the fp32 tile: all have M > 64; the forward's attention on the fp32
    tile) and the loss finite; then one more step profiled, its time split
    into GEMM, other device work and host (``gemm_split``)."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.train import steps as S

    arch, layers, st = F32_TRAIN
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    run = f"{arch} F32GER train ({layers} layers)"
    t0 = time.perf_counter()
    make_state, make_step, _ = T.build(
        cfg, lr=TRAIN["lr"], total_steps=st["steps"], weight_decay=0.0,
        seed=0, device="cuda", ger=facility.Ger.F32GER,
        out_dtype=torch.float32)
    state, step = make_state(), make_step()
    model = state["params"]
    batch = pipeline.device_batch(pipeline.synthetic_batch(
        cfg, batch=st["batch"], seq=st["seq"], step=0), "cuda")

    def grads(backend):
        with facility.configure(f32_config(torch, backend=backend)):
            loss, _, g = S.loss_and_grads(cfg, model, batch)
        return loss.item(), g

    loss_t, want = grads("torch")
    loss_k, got = grads("kernel")
    rels = sorted(((_rel(got[k].float(), want[k].float()), k) for k in got),
                  reverse=True)
    del got, want
    loss_rel = abs(loss_k - loss_t) / abs(loss_t)
    ok = (loss_k == loss_k and abs(loss_k) != float("inf")
          and loss_rel <= F32_TOL["grads"]
          and rels[0][0] <= F32_TOL["grads"])
    print(f"  [{'ok' if ok else 'FAIL'}] phase 8: {run} step-1 loss kernel "
          f"{loss_k:.7f}, torch {loss_t:.7f} (rel {loss_rel:.3e}); "
          f"{len(rels)} gradient leaves, worst rel L2 {rels[0][0]:.3e} "
          f"(tol {F32_TOL['grads']:.0e}): "
          + ", ".join(f"{k} {r:.3e}" for r, k in rels[:3]))
    if not ok:
        failures.append(f"{run} step-1 loss or gradients")
    kernels = kernel_wrappers()
    per_step = {k: v for k, v in expected_train_launches(cfg).items()
                if k != "forward_gemm"}
    torch.cuda.synchronize()
    losses, times = [], []
    with tracing_gemm() as trace:
        zero_counts(kernels)
        for _ in range(st["steps"]):
            t1 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            losses.append(metrics["loss"].item())
        counts = read_counts(kernels)
    model_counts = {k: st["steps"] * per_step.get(k, 0) for k in kernels}
    check_f32_counts(failures, run, counts, model_counts, {
        "f32_tile": st["steps"] * per_step.get("mma_flash_attention", 0)},
        trace)
    PHASE8[run]["split"] = gemm_split(
        torch, f"{run} train step", lambda: step(state, batch),
        sorted(times)[len(times) // 2])
    finite = all(x == x and abs(x) != float("inf") for x in losses)
    print(f"  [{'ok' if finite else 'FAIL'}] phase 8: {run} losses "
          f"{losses}, step times {[round(t, 1) for t in times]} ms, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB ({time.perf_counter() - t0:.1f} s in all)")
    if not finite:
        failures.append(f"{run} loss")
    PHASE8[run]["rel_l2"] = {"loss": loss_rel, "worst_grad": rels[0][0]}
    del state, step, model, batch


def _lane_masks(torch, g, m, n, k):
    return tuple(torch.rand(s, generator=g, device="cuda") > 0.3
                 for s in (m, n, k))


def phase8_kernels(torch, timer, failures):
    """The masked products (K1b): a main-path run through the entry points
    (``facility.contract(masks=)`` at each MASKED_CASES shape and
    ``kernels.ops.mma_pm_dot`` twice: on the first case and on I4GER8
    with a column mask), launches reset just before and read
    just after; then each case's masked kernel held against its plain
    version (integers bit for bit), with NaN and Inf in every disabled lane
    of the float families, and timed beside the same kernel unmasked, the
    unmasked default path, the plain version, the ``torch.where`` +
    ``torch.matmul`` yardstick (``torch._int_mm`` for I8GER4) and its
    bound; then K2e at the F32GER runs' attention shapes beside SDPA on
    f32 inputs (TF32 off).  Returns the ``kernels`` entries."""
    import warnings

    from repro_torch.core import facility, precision, tiling
    from repro_torch.kernels import mma_gemm as G
    from repro_torch.kernels import ops as O

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(20)
    operands = []
    for name, fam, b, m, k, n, seeded in MASKED_CASES:
        kind = Ger[fam]
        pol = precision.policy(kind)
        lead = (b,) if b else ()
        if pol.is_integer:
            x = torch.randint(-128, 128, lead + (m, k), generator=g,
                              device="cuda").to(torch.int8)
            y = torch.randint(0, 256, lead + (k, n), generator=g,
                              device="cuda").to(torch.uint8)
        else:
            x = torch.randn(lead + (m, k), generator=g, device="cuda",
                            dtype=torch.float64 if fam == "F64GER"
                            else torch.float32).to(pol.x_dtype)
            y = (torch.randn(lead + (k, n), generator=g, device="cuda",
                             dtype=x.dtype if fam == "F64GER"
                             else torch.float32) * k ** -0.5).to(pol.y_dtype)
        c = (torch.randn(lead + (m, n), generator=g, device="cuda")
             if seeded else None)
        masks = _lane_masks(torch, g, m, n, k)
        xm, ym, pm = masks
        if not pol.is_integer:     # NaN and Inf where the lanes are off
            x[..., ~xm, :] = float("nan")
            x[..., ~pm] = float("inf")
            y[..., ~pm, :] = float("nan")
            y[..., ~ym] = float("-inf")
        operands.append((name, kind, pol, b, m, k, n, x, y, c, masks))

    # I4GER8, which contract refuses: a column mask alone takes the IMMA
    # kernel's column predicate through ops.mma_pm_dot (nibbles packed
    # two a byte along K, at I8GER4's case's 4096^3)
    x4, y4 = (torch.randint(-128, 128, s, generator=g, device="cuda").to(
        torch.int8) for s in ((4096, 2048), (2048, 4096)))
    ym4 = torch.rand(4096, generator=g, device="cuda") > 0.3

    # the main path: the entry points a user calls
    kernels = kernel_wrappers()
    outs = []
    torch.cuda.synchronize()
    zero_counts(kernels)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for name, kind, pol, b, m, k, n, x, y, c, masks in operands:
            spec = "bmk,bkn->bmn" if b else "mk,kn->mn"
            outs.append(facility.contract(
                spec, x, y, acc=c, masks=masks,
                plan=facility.Plan(ger=kind, out_dtype=facility.ACC)))
        name, kind, pol, b, m, k, n, x, y, c, masks = operands[0]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            shim = O.mma_pm_dot(x, y, kind=kind, xmask=masks[0],
                                ymask=masks[1], pmask=masks[2])
            i4 = O.mma_pm_dot(x4, y4, kind=Ger.I4GER8, xmask=None,
                              ymask=ym4)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    PHASE8["masked products"] = counts
    print(f"  phase 8: masked products through contract(masks=) and "
          f"ops.mma_pm_dot: launches {counts['launches']}, GEMM by path "
          f"{counts['by_path']['mma_gemm']}, masked by path "
          f"{counts['masked']}")
    _check(failures, "ops.mma_pm_dot", torch.equal(shim, outs[0]),
           "bit for bit contract(masks=)")
    _check(failures, "ops.mma_pm_dot I4GER8 column mask 4096^3",
           torch.equal(i4, G.mma_gemm_plain(x4, y4, kind=Ger.I4GER8,
                                            masks=(None, ym4, None)))
           and bool((i4[:, ~ym4] == 0).all()),
           "bit for bit the plain version, exact zeros on disabled columns")
    del x4, y4, i4

    rows = {}
    for (name, kind, pol, b, m, k, n, x, y, c, masks), out in zip(
            operands, outs):
        xm, ym, pm = masks
        path, cfg = tiling.choose_gemm_path(m, n, k, kind, b or 1, True,
                                            None, True)
        label = f"masked {name} {'%dx' % b if b else ''}{m}x{k}x{n} ({path})"
        plain = G.mma_gemm_plain(x, y, c, kind=kind, masks=masks)
        finite = pol.is_integer or bool(out.isfinite().all())
        if pol.is_integer:
            ok = torch.equal(out, plain)
            _check(failures, label, ok, "bit for bit the plain version")
            err = 0.0 if ok else float("inf")
        elif kind == Ger.F64GER:
            xs, ys = G.select_masks(x, y, masks)
            tol = 1e-15 * k * xs.abs().max().item() * ys.abs().max().item()
            err = (out - plain).abs().max().item()
            _check(failures, label, finite and err <= tol,
                   f"max|err| {err:.3e} (tol 1e-15*K*max|x|*max|y| "
                   f"{tol:.3e}), finite")
        else:
            err = _report_close(torch, label, out.float(), plain.float(),
                                torch.float32, failures)
            _check(failures, label, finite, "finite (NaN/Inf lanes off)")
        if c is None:
            zero = bool((out[..., ~xm, :] == 0).all()) \
                and bool((out[..., ~ym] == 0).all())
            _check(failures, label, zero, "exact zeros on disabled rows "
                   "and columns")
        # the same kernel unmasked: the masked route's tile as an explicit
        # block (IMMA: the mma.sync kernel, which an unmasked call leaves)
        blk = (cfg.bm, cfg.bn, cfg.bk) if path in ("wmma", "imma") else None
        before = dict(G.mma_gemm.launches_by_path)
        G.mma_gemm(x, y, c, kind=kind)
        default = _path_taken(G.mma_gemm, before)
        if pol.is_integer:
            def library():    # s8 x s8: not the same function as s8 x u8
                return torch._int_mm(
                    torch.where(xm[:, None] & pm, x, 0),
                    torch.where(pm[:, None] & ym, y, 0).to(torch.int8))
        else:
            def library():
                xs = torch.where(xm[:, None] & pm, x, 0)
                ys = torch.where(pm[:, None] & ym, y, 0)
                z = torch.matmul(xs, ys)
                return z if c is None else z + c
        row = {"ms": timer(lambda: G.mma_gemm(x, y, c, kind=kind,
                                              masks=masks)),
               "unmasked_ms": timer(lambda: G.mma_gemm(x, y, c, kind=kind,
                                                       block=blk)),
               "default_ms": timer(lambda: G.mma_gemm(x, y, c, kind=kind)),
               "default_path": default,
               "plain_ms": timer(lambda: G.mma_gemm_plain(
                   x, y, c, kind=kind, masks=masks)),
               "library_ms": timer(library)}
        # the work this run's masks leave: enabled rows, columns and ranks
        mo, no, ko = (int(t.sum()) for t in masks)
        bb = b or 1
        nbytes = (bb * (mo * ko * x.element_size() + ko * no * y.element_size()
                        + m * n * 4 * (2 if c is not None else 1))
                  + m + n + k)
        peak = {"BF16GER2": "bf16", "F32GER": "f32", "I8GER4": "int8",
                "F64GER": "f64"}[kind.name]
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2 * bb * mo * no * ko, peak)
        print(f"  time {label}: masked {row['ms']:.4f} ms, same kernel "
              f"unmasked {row['unmasked_ms']:.4f} ms, default path "
              f"({default}) {row['default_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, where + library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; {mo}/{m} rows, {no}/{n} columns, "
              f"{ko}/{k} ranks on)")
        rows.setdefault(path, {})[label] = (row, err)
    del operands, outs

    sources = {"wmma": "src/repro_torch/csrc/mma_gemm.cu, "
                       "src/repro_torch/csrc/tile_gemm.cuh",
               "imma": "src/repro_torch/csrc/gemm_imma.cu",
               "dmma": "src/repro_torch/csrc/gemm_dmma.cu"}
    entries = []
    for path, by_label in rows.items():
        label, (row, _) = next(iter(by_label.items()))
        e = {"name": f"mma_gemm masked ({path})", "route": "cuda",
             "source": sources[path],
             "replaces": "src/repro/kernels/mma_gemm.py:121",
             "max_abs_err": max(err for _, err in by_label.values()),
             **row, "shape": label,
             "launches": counts["masked"][path],
             "timed": {lb: r for lb, (r, _) in by_label.items()}}
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched on phase 8's "
                            f"masked run")
        entries.append(e)
    return entries + phase8_attention(torch, timer, failures)


# F32GER's GEMM kernels at the tight-parity runs' shapes: (label, batch,
# M, K, N, forms).  Up to M = 64 the fp32 weight stream: deepseek-7b's
# decode MLP, projections, down projection and logits, whisper-small's
# unaligned 51865-column logits, each row bucket, fringes with the
# accumulate forms and an epilogue, an expert-bank-like batch; above, the
# fp32 tile: deepseek-7b's prefill MLP and projections (128 x 128) and a
# 256-row prefill (64 x 64).
F32_GEMM_CASES = (
    ("decode MLP", None, 4, 4096, 11008, False),
    ("decode projection", None, 4, 4096, 4096, False),
    ("decode down projection", None, 4, 11008, 4096, False),
    ("decode logits", None, 4, 4096, 102400, False),
    ("whisper decode logits (unaligned)", None, 4, 768, 51865, False),
    ("bucket M=1", None, 1, 4096, 11008, False),
    ("bucket M=16", None, 16, 4096, 11008, False),
    ("bucket M=32", None, 32, 4096, 11008, False),
    ("bucket M=64", None, 64, 4096, 11008, False),
    ("fringe + forms", None, 37, 202, 1001, True),
    ("batched bank", 8, 3, 2048, 1408, False),
    ("prefill MLP", None, 1024, 4096, 11008, False),
    ("prefill projection", None, 1024, 4096, 4096, False),
    ("prefill 256 rows", None, 256, 4096, 4096, False),
    ("tile fringe + forms", None, 1000, 330, 1000, True),
)


def _tf32(torch, t):
    """t rounded to TF32 (10 mantissa bits, to nearest): what a TF32
    tensor-core product reads."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def phase8_f32_gemm(torch, timer, failures):
    """F32GER's GEMM kernels, the fp32 weight stream (M <= 64) and the fp32
    tile (M > 64), at F32_GEMM_CASES: each held against the plain version
    of its path (the stream's split-K one where it splits K; TF32 off)
    within the fp32 tolerance, and, for each plain product (no seed or
    epilogue), the TF32 control: the same plain version on TF32-rounded
    operands must land outside that tolerance (max err/tol above 2), or
    the check could not tell fp32 FMAs from a TF32 product.  A decode row is the same bits at batch 1 and batch 4.
    Each case is timed (CUDA events, L2 flushed) beside the plain
    version, ``torch.matmul`` on f32 (TF32 off) and its bound at the fp32
    peak; deepseek-7b's decode MLP and prefill MLP on packed Y panels too.
    The two entries' launches are the F32GER runs' (PHASE8), by path."""
    from repro_torch.core import facility, packing, tiling
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_gemm as G

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    for name, b, m, k, n, forms in F32_GEMM_CASES:
        lead = (b,) if b else ()
        x = torch.randn(lead + (m, k), generator=g, device="cuda")
        y = torch.randn(lead + (k, n), generator=g, device="cuda") * k ** -0.5
        c = None
        kw = dict(kind=Ger.F32GER, out_dtype=torch.float32)
        if forms:
            c = torch.randn(lead + (m, n), generator=g, device="cuda")
            kw.update(neg_product=True, alpha=0.5, beta=-2.0,
                      ep=E.Epilogue(bias=True, activation="silu"),
                      bias=torch.randn(n, generator=g, device="cuda"))
        aligned = G.natural_aligned(x, y)
        path, cfg = tiling.choose_gemm_path(m, n, k, Ger.F32GER, b or 1,
                                            aligned)
        label = (f"F32GER {name} {'%dx' % b if b else ''}{m}x{k}x{n} "
                 f"({path}"
                 + (f", split {cfg.split}, bn {cfg.bn})" if path == "stream"
                    else f", {cfg.bm}x{cfg.bn})"))
        before = G.mma_gemm.launches_by_path[path]
        got = G.mma_gemm(x, y, c, **kw)
        torch.cuda.synchronize()
        if G.mma_gemm.launches_by_path[path] != before + 1 \
                or path != f32_path_of(m, k):
            failures.append(f"{label}: not launched on {f32_path_of(m, k)}")
        plain = G._plain_of(path, cfg, k)
        want = plain(x, y, c, **kw)
        err = _report_close(torch, label, got, want, torch.float32,
                            failures)
        tol = 2e-5 * want.abs() + 2e-5 * want.abs().max()
        ratios = {"budget_ratio": ((got - want).abs() / tol).max().item()}
        if not forms:
            # the control holds the product alone (a seed's magnitude
            # would widen the tolerance past the product's rounding)
            ctrl = plain(_tf32(torch, x), _tf32(torch, y), c, **kw)
            ratios["tf32_budget_ratio"] = ((ctrl - want).abs() / tol).max(
            ).item()
            ok = ratios["tf32_budget_ratio"] > 2
            print(f"  [{'ok' if ok else 'FAIL'}] control {label}: max "
                  f"err/tol, kernel {ratios['budget_ratio']:.3f}, plain "
                  f"version on TF32-rounded operands "
                  f"{ratios['tf32_budget_ratio']:.3f} (must exceed 2)")
            if not ok:
                failures.append(f"{label}: the f32 tolerance admits TF32")
            del ctrl
        del want
        if name == "decode MLP":
            one = G.mma_gemm(x[2:3], y, **kw)
            _check(failures, f"{label} batch 1 vs 4",
                   torch.equal(one, got[2:3]),
                   "a decode row the same bits at batch 1 and batch 4")
        kw_c = dict(kw)
        xs, ys = x, y
        row = {"ms": timer(lambda: G.mma_gemm(xs, ys, c, **kw_c)),
               "plain_ms": timer(lambda: plain(xs, ys, c, **kw_c)),
               "library_ms": timer(lambda: torch.matmul(xs, ys)),
               "path": path, **ratios}
        if name in ("decode MLP", "prefill MLP"):
            po = packing.pack_gemm(y, packing.gemm_layout(Ger.F32GER, k, n))
            packed = G.mma_gemm(x, po.data, c, y_layout=po.layout, **kw)
            _check(failures, f"{label} packed Y", torch.equal(packed, got),
                   "bit for bit the natural launch")
            row["packed_ms"] = timer(lambda: G.mma_gemm(
                xs, po.data, c, y_layout=po.layout, **kw_c))
            del po, packed
        bb = b or 1
        nbytes = bb * (m * k + k * n + m * n * (2 if c is not None else 1)
                       ) * 4
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2 * bb * m * n * k,
                                                    "f32")
        print(f"  time {label}: kernel {row['ms']:.4f} ms"
              + (f", packed Y {row['packed_ms']:.4f} ms"
                 if "packed_ms" in row else "")
              + f", plain {row['plain_ms']:.4f} ms, torch.matmul f32 "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
        rows.setdefault(path, {})[label] = (row, err)
        del x, y, c, got
    entries = []
    for path, name, source in (
            ("stream", "mma_gemm f32 (stream)",
             "src/repro_torch/csrc/gemm_stream.cu"),
            ("wmma", "mma_gemm f32 (tile)",
             "src/repro_torch/csrc/mma_gemm.cu, "
             "src/repro_torch/csrc/tile_gemm.cuh")):
        by_label = rows[path]
        label, (row, _) = next(iter(by_label.items()))
        by_run = {r: cnt["by_path"]["mma_gemm"][path]
                  for r, cnt in PHASE8.items() if "F32GER" in r}
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": "src/repro/kernels/mma_gemm.py:197",
             "max_abs_err": max(err for _, err in by_label.values()),
             **row, "shape": label, "launches_by_run": by_run,
             "launches": sum(by_run.values()),
             "timed": {lb: r for lb, (r, _) in by_label.items()}}
        if e["launches"] <= 0:
            failures.append(f"{name} never launched on phase 8's F32GER "
                            f"runs")
        entries.append(e)
    return entries


def _tf32_control(torch, label, q, k, v, got, kw, failures):
    """The control of the f32 rounding budget: the plain version on q and
    k rounded to TF32 (10 mantissa bits, to nearest: what a TF32
    tensor-core product reads; ``allow_tf32`` would not do, as cuBLAS
    keeps a one-query product off the tensor cores) must land outside
    the tolerance that the fp32 tile met (the budget plus 2^-20 *
    max|ref|), or the budget could not tell fp32 scores from TF32 ones.
    Returns both max err/tol readings."""
    from repro_torch.kernels import mma_attention as A

    def tf32(t):
        return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    want = A.flash_attention_plain(q, k, v, **kw)
    tol = A.rounding_budget(q, k, v, **kw) + 2.0 ** -20 * want.abs().max()
    scores = A.flash_attention_plain(tf32(q), tf32(k), v, **kw)
    ratios = {"budget_ratio": ((got - want).abs() / tol).max().item(),
              "tf32_budget_ratio":
                  ((scores - want).abs() / tol).max().item()}
    ok = ratios["tf32_budget_ratio"] > 2
    print(f"  [{'ok' if ok else 'FAIL'}] control {label}: max err/tol, "
          f"fp32 tile {ratios['budget_ratio']:.3f}, plain version on "
          f"TF32-rounded q and k {ratios['tf32_budget_ratio']:.3f} (must "
          f"exceed 2)")
    if not ok:
        failures.append(f"{label}: the f32 budget admits TF32 scores")
    return ratios


def phase8_attention(torch, timer, failures):
    """K2e at the F32GER runs' attention shapes: each held against its
    plain version (``check_attn_case``: the rounding budget, with no P
    rounding in f32) and the budget's TF32 control (``_tf32_control``), a
    split row at batch 1 bit for bit the same row in the batch, and timed
    beside the plain version and SDPA on f32 inputs (TF32 off), with its
    bound at the fp32 peak, the parent kernel's PERF.md time and its aim
    (a miss is reported, not failed); the entries' launches are the
    F32GER runs' (PHASE8), by mode."""
    from repro_torch.kernels import mma_attention as A

    g = torch.Generator(device="cuda").manual_seed(21)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, qs, ks, causal, parent, aim in F32_ATTENTION:
        q, k, v = (torch.randn(s, generator=g, device="cuda")
                   for s in (qs, ks, ks))
        kw = dict(causal=causal)
        n_split, _ = A.split_kv_plan(qs[2], qs[1], ks[1])
        mode = "split" if n_split > 1 else "tile"
        label = f"f32 {name} {qs} over {ks[1]} ({mode})"
        err, got = check_attn_case(torch, label, q, k, v, kw, failures)
        ratios = _tf32_control(torch, label, q, k, v, got, kw, failures)
        if mode == "split":
            one = A.mma_flash_attention(q[:1], k[:1], v[:1], **kw)
            _check(failures, f"{label} row at batch 1",
                   torch.equal(one[0], got[0]),
                   "bit for bit the same row in the batch")
        del got
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {"ms": timer(lambda: A.mma_flash_attention(q, k, v, **kw)),
               "plain_ms": timer(lambda: A.flash_attention_plain(
                   q, k, v, **kw)),
               "library_ms": timer(lambda: sdpa(qt, kt, vt,
                                                is_causal=causal))}
        b, sq, h, d = qs
        pairs = A.attn_live_pairs(sq, ks[1], causal=causal)
        row["bound_ms"], row["bound_by"] = bound_ms(
            (2 * q.numel() + k.numel() + v.numel()) * 4,
            4 * d * pairs * h * b, "f32")
        row.update(ratios)
        goal = ""
        if aim is not None:
            row["aim_met"] = row["ms"] <= aim
            goal = (f"; aim {'met' if row['aim_met'] else 'MISSED'} "
                    f"(<= {aim:.4f} ms)")
        print(f"  time attn {label}: kernel {row['ms']:.4f} ms (parent in "
              f"PERF.md: {parent if parent is not None else 'none'} ms), "
              f"plain {row['plain_ms']:.4f} ms, sdpa f32 "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.2f} of "
              f"bound{goal}")
        rows.setdefault(mode, {})[label] = (row, err)
    entries = []
    for mode, by_label in rows.items():
        label, (row, _) = next(iter(by_label.items()))
        by_run = {r: c["attn_by_mode"].get(f"f32_{mode}", 0)
                  for r, c in PHASE8.items() if "attn_by_mode" in c}
        e = {"name": f"mma_flash_attention f32 ({mode})", "route": "cuda",
             "source": "src/repro_torch/csrc/mma_attention.cu",
             "replaces": "src/repro/kernels/mma_attention.py:193",
             "max_abs_err": max(err for _, err in by_label.values()),
             **row, "shape": label, "launches_by_run": by_run,
             "launches": sum(by_run.values()),
             "timed": {lb: r for lb, (r, _) in by_label.items()}}
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched on phase 8's "
                            f"F32GER runs")
        entries.append(e)
    return entries



# ----------------------------------------------------------------------
# Phase 9: guarded serving and ABFT (runtime/faults.py, the guarded
# kernel -> torch -> ref ladder, core/abft.py) and K1e, the GEMM kernels'
# checksum sidecar, with K2 at ABFT's depth D + 1
# ----------------------------------------------------------------------

# The fault matrix's settings (launch/serve.py's run_fault_matrix
# defaults, the reference's), on full-width, full-depth deepseek-7b.
MATRIX = dict(batch=2, prompt_len=8, gen_len=6, n_requests=4)
# Per phase-9 run: its launches (by path, with the sidecar, attention by
# mode and at a padded depth) and what it showed.
PHASE9: dict[str, dict] = {}


def zero_counts9(kernels):
    """zero_counts, and the sidecar's and the padded depths' counts."""
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_gemm as G
    zero_counts(kernels)
    G.mma_gemm.checksum_launches_by_path = dict.fromkeys(G.SIDECAR_PATHS, 0)
    A.mma_flash_attention.padded_launches_by_mode = dict.fromkeys(A.MODES, 0)


def read_counts9(kernels):
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_gemm as G
    return {**read_counts(kernels),
            "sidecar": dict(G.mma_gemm.checksum_launches_by_path),
            "padded": dict(A.mma_flash_attention.padded_launches_by_mode)}


def _same_record(torch, rec, ref) -> bool:
    return len(rec) == len(ref) and all(
        len(a) == len(b) and a[0] == b[0]
        and all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
        for a, b in zip(rec, ref))


def guarded_serves(torch, failures, model, cfg, natural):
    """Phase 9's serving runs of deepseek-7b at full width and depth, right
    after its phase-3 run (``natural``: that run's stats, launches and
    recorded steps), each with every count zeroed just before it and read
    just after: (1) guards on, ABFT off: every prefill and decode output
    bit for bit phase 3's, no guard event, every contract dispatch counted
    on the kernel rung; (2) ``serve_loop(..., abft=True)``: no verdict, no
    demotion, each prefill's logits within phase 3's logits bound of phase
    3's (relative L2: the attn augmentation moves rounding only), the
    GEMM sidecar launched on the weight stream and the wgmma tile and the
    attention kernel at the padded depth 129; (3) ``run_fault_matrix``:
    every scenario ok, ``sdc`` detected by a kernel-rung check that read
    the sidecar, and recovered.  Decode tok/s of each beside phase 3's."""
    from repro_torch.core import abft, facility, lowering
    from repro_torch.launch import serve as S

    kernels = kernel_wrappers()
    runs = {}
    for run, kw in (("guards", dict(guards=True)),
                    ("abft", dict(guards=True, abft=True))):
        rec = []
        lowering.clear_guard_state()
        lowering.DISPATCH_COUNTS.clear()
        with facility.configure(facility.FacilityConfig(device="cuda",
                                                        **kw)), \
                recording_steps(rec):
            torch.cuda.synchronize()
            zero_counts9(kernels)
            out = S.serve_loop(cfg, model, **SERVE)
            counts = read_counts9(kernels)
        rungs = {}
        for (r, _, _), n in lowering.DISPATCH_COUNTS.items():
            rungs[r] = rungs.get(r, 0) + n
        out.pop("abft_verdicts")
        print(f"  phase 9: {cfg.name} serve, {kw}: {json.dumps(out)}")
        print(f"  phase 9: launches {counts['launches']}, GEMM by path "
              f"{counts['by_path']['mma_gemm']}, with the sidecar "
              f"{counts['sidecar']}, attention at a padded depth "
              f"{counts['padded']}; dispatches by rung {rungs}")
        name = f"{cfg.name} {run} serve"
        _check(failures, name, out["completed"] == SERVE["n_requests"]
               and lowering.GUARD_EVENTS == [] and set(rungs) == {"kernel"},
               f"{out['completed']} of {SERVE['n_requests']} requests, "
               f"{len(lowering.GUARD_EVENTS)} guard events, dispatches on "
               f"{sorted(rungs)} (only the kernel rung)")
        runs[run] = (out, counts, rec)
        PHASE9[name] = {**counts, "tok_s": out["tokens_per_s"],
                        "tok_s_phase3": natural["stats"]["tokens_per_s"]}
    out, counts, rec = runs["guards"]
    _check(failures, f"{cfg.name} guards serve", _same_record(
        torch, rec, natural["record"]) and counts["launches"]
        == natural["launches"], f"{len(rec)} prefill/decode outputs (token "
        f"ids and logits) bit for bit phase 3's, launches phase 3's")
    out, counts, rec = runs["abft"]
    pre = [(a[1], b[1]) for a, b in zip(rec, natural["record"])
           if a[0] == b[0] == "prefill"]
    rels = [_rel(a.float(), b.float()) for a, b in pre]
    tol = LOGIT_TOLS[cfg.name, "prefill logits"]
    ticks = [(a[1], b[1]) for a, b in zip(rec, natural["record"])
             if a[0] == b[0] == "decode"]
    same = next((i for i, (a, b) in enumerate(ticks)
                 if not torch.equal(a, b)), len(ticks))
    _check(failures, f"{cfg.name} abft serve", out["abft_detections"] == 0
           and len(pre) == SERVE["n_requests"] and max(rels) < tol,
           f"{out['abft_detections']} verdicts; {len(pre)} prefills' logits "
           f"vs phase 3's rel L2 max {max(rels):.3e} (phase 3's bound "
           f"{tol:.3e}); the first {same} of {len(ticks)} decode ticks' "
           f"tokens equal phase 3's")
    _check(failures, f"{cfg.name} abft serve",
           counts["sidecar"]["stream"] > 0 and counts["sidecar"]["wgmma"] > 0
           and counts["padded"]["tile"] > 0,
           "GEMM sidecar on the weight stream and the wgmma tile, attention "
           "at the padded depth 129 on the tile")
    PHASE9[f"{cfg.name} abft serve"].update(prefill_rel_l2=max(rels),
                                            same_ticks=same)
    print(f"  phase 9: decode tok/s: phase 3 "
          f"{natural['stats']['tokens_per_s']:.2f}, guards "
          f"{runs['guards'][0]['tokens_per_s']:.2f}, abft "
          f"{out['tokens_per_s']:.2f}")

    lowering.clear_guard_state()
    t0 = time.perf_counter()
    with facility.configure(facility.FacilityConfig(device="cuda")):
        torch.cuda.synchronize()
        zero_counts9(kernels)
        results = S.run_fault_matrix(cfg, model, **MATRIX)
        counts = read_counts9(kernels)
    wall = time.perf_counter() - t0
    for r in results:
        print(f"  [{'ok' if r['ok'] else 'FAIL'}] phase 9: fault matrix "
              f"{r['scenario']:16s} completed={r['completed']} "
              f"faults={r['fired']} demotions={r['demotions']} "
              f"abft={r['abft_detections']} nan={r['nan_steps']} "
              f"crashes={r['step_faults']} preempt={r['preemptions']} "
              f"requeue={r['requeues']} "
              f"pages_hw={r['pages']['high_water_pages']} "
              f"wall {r['wall_s']:.2f} s")
        if not r["ok"]:
            failures.append(f"fault matrix {r['scenario']}")
    sdc = next(r for r in results if r["scenario"] == "sdc")
    gemm = [v for v in sdc["abft_verdicts"] if v["op_class"] == "gemm"]
    _check(failures, "fault matrix sdc", len(results) == 7 and gemm
           and all(v["recovered"] and v["detail"].get("sidecar")
                   for v in gemm),
           f"{len(results)} scenarios; sdc's gemm verdicts "
           f"{[(v['rung'], v['how'], v['recovered'], v['detail']) for v in gemm]}"
           f" (recovered, detected by a check that read the sidecar)")
    print(f"  phase 9: fault matrix {MATRIX}: {wall:.1f} s wall; launches "
          f"{counts['launches']}, with the sidecar {counts['sidecar']}")
    PHASE9[f"{cfg.name} fault matrix"] = {**counts, "wall_s": wall}
    lowering.clear_guard_state()


# ABFT runs through facility.contract (the entry point) of the products and
# attention calls the deepseek-7b serve does not reach: (name, kind,
# operand shapes, plan keywords).  F32GER and an unaligned pitch take the
# WMMA tile, F64GER the DMMA kernel; the conv at whisper's conv2 shape with
# no epilogue gets ABFT's 769th filter column (K3's WMMA tile by its
# alignment rule); attention at D + 1 in every mode.
ABFT_CONTRACT_RUNS = (
    ("F32GER MLP 1024x4096x11008", "gemm", "F32GER",
     ((1024, 4096), (4096, 11008)), {}),
    ("bf16 logits 1024x768x51865", "gemm", "BF16GER2",
     ((1024, 768), (768, 51865)), {}),
    ("DGEMM 2048^3", "gemm", "F64GER", ((2048, 2048), (2048, 2048)), {}),
    ("conv1d whisper conv2 (F 768 + 1)", "conv", "BF16GER2",
     ((4, 3000, 768), (3, 768, 768)), dict(stride=2, padding="same")),
    ("attn deepseek prefill D=128+1", "attn", "BF16GER2",
     ((4, 256, 32, 128), (4, 256, 32, 128)), dict(causal=True)),
    ("attn one query over 288 D=128+1", "attn", "BF16GER2",
     ((4, 1, 32, 128), (4, 288, 32, 128)), dict(causal=True, q_offset=287)),
    ("attn whisper encoder D=64+1", "attn", "BF16GER2",
     ((4, 1500, 12, 64), (4, 1500, 12, 64)), dict(causal=False)),
    ("attn whisper cross D=64+1", "attn", "BF16GER2",
     ((4, 1, 12, 64), (4, 1500, 12, 64)), dict(causal=False)),
    ("attn F32GER prefill D=128+1", "attn", "F32GER",
     ((1, 256, 32, 128), (1, 256, 32, 128)), dict(causal=True)),
    ("attn F32GER decode D=128+1", "attn", "F32GER",
     ((4, 1, 32, 128), (4, 288, 32, 128)), dict(causal=True, q_offset=287)),
)


def abft_contract_runs(torch, failures):
    """ABFT_CONTRACT_RUNS through ``facility.contract`` under
    ``FacilityConfig(guards=True, abft=True)``, counts zeroed just before
    and read just after: no verdict, no guard event, each output within
    2e-2 of the same call unguarded (the reference's bound for the
    augmentation; the GEMMs are the unguarded call's bit for bit), and
    the sidecar, K3's WMMA tile and every padded attention mode
    launched."""
    from repro_torch.core import abft, facility, lowering

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(21)
    kernels = kernel_wrappers()
    operands = []
    for name, op, fam, shapes, kw in ABFT_CONTRACT_RUNS:
        dt = {"F32GER": torch.float32, "F64GER": torch.float64}.get(
            fam, torch.bfloat16)
        ts = [(torch.randn(s, generator=g, device="cuda",
                           dtype=torch.float64 if dt == torch.float64
                           else torch.float32)
               * (s[-2] ** -0.5 if op != "attn" and i else 1.0)).to(dt)
              for i, s in enumerate(shapes)]
        if op == "attn":
            ts.append(torch.randn(shapes[1], generator=g, device="cuda"
                                  ).to(dt))
        operands.append((name, op, Ger[fam], ts, kw))

    def call(op, ger, ts, kw):
        out = None if ger == Ger.BF16GER2 else (
            torch.float64 if ger == Ger.F64GER else torch.float32)
        plan = facility.Plan(ger=ger, out_dtype=out, **kw)
        spec = {"gemm": "mk,kn->mn", "conv": facility.CONV1D,
                "attn": facility.ATTN}[op]
        return facility.contract(spec, *ts, plan=plan)

    with facility.configure(facility.FacilityConfig(device="cuda")):
        base = [call(op, ger, ts, kw) for _, op, ger, ts, kw in operands]
    lowering.clear_guard_state()
    torch.cuda.synchronize()
    zero_counts9(kernels)
    t0 = time.perf_counter()
    with facility.configure(facility.FacilityConfig(
            device="cuda", guards=True, abft=True)):
        outs = [call(op, ger, ts, kw) for _, op, ger, ts, kw in operands]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts9(kernels)
    verdicts = abft.drain_verdicts()
    for (name, op, *_), a, b in zip(operands, outs, base):
        r = _rel(a.float(), b.float())
        ok = (torch.equal(a, b) if op == "gemm" else r < 2e-2) and bool(
            torch.isfinite(a).all())
        print(f"  [{'ok' if ok else 'FAIL'}] phase 9: abft {name}: "
              f"{tuple(a.shape)} vs unguarded rel L2 {r:.3e}"
              + (" (bit for bit)" if op == "gemm" else " (tol 2e-2)"))
        if not ok:
            failures.append(f"abft {name}")
    _check(failures, "abft contract runs", verdicts == []
           and lowering.GUARD_EVENTS == []
           and counts["sidecar"]["wmma"] >= 2
           and counts["sidecar"]["dmma"] >= 1
           and counts["by_path"]["mma_conv2d"].get("wmma", 0) >= 1
           and all(counts["padded"][m] > 0 for m in counts["padded"]),
           f"{len(verdicts)} verdicts, {len(lowering.GUARD_EVENTS)} guard "
           f"events; sidecar {counts['sidecar']}, conv by path "
           f"{counts['by_path']['mma_conv2d']}, attention at a padded depth "
           f"{counts['padded']} ({wall:.2f} s)")
    PHASE9["abft contract runs"] = {**counts, "wall_s": wall}
    del operands, outs, base


# The sidecar's timed shapes, at the runs' products: (label, family, M,
# K, N); "split" and "1" name the weight stream's split of K.
SIDECAR_TIMED = (
    ("stream", "decode 4x4096x11008 (split)", "BF16GER2", 4, 4096, 11008),
    ("stream", "decode logits 4x4096x102400 (split 1)", "BF16GER2", 4,
     4096, 102400),
    ("wgmma", "prefill 1024x4096x11008", "BF16GER2", 1024, 4096, 11008),
    ("wmma", "F32GER 1024x4096x11008", "F32GER", 1024, 4096, 11008),
    ("wmma", "unaligned 1024x768x51865", "BF16GER2", 1024, 768, 51865),
    ("dmma", "DGEMM 2048^3", "F64GER", 2048, 2048, 2048),
)


def phase9_kernels(torch, timer, failures):
    """Each sidecar kernel at SIDECAR_TIMED: ``checksum=True`` bit for bit
    ``checksum=False``, the sums within ABFT's tolerance of the plain
    version's (``mma_gemm_sidecar_plain``), each timed on and off beside
    the plain version, ``torch.matmul`` and the bound; then K2 at D + 1
    (129 and 65) in every mode against its plain version, and timed at
    deepseek's prefill beside the unpadded D = 128 and SDPA.  Returns the
    ``kernels`` entries (launches: phase 9's runs')."""
    from repro_torch.core import abft, precision, tiling
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_gemm as G

    Ger = precision.Ger
    g = torch.Generator(device="cuda").manual_seed(22)
    rows = {}
    for path, label, fam, m, k, n in SIDECAR_TIMED:
        kind = Ger[fam]
        pol = precision.policy(kind)
        wide = torch.float64 if fam == "F64GER" else torch.float32
        x = torch.randn(m, k, generator=g, device="cuda", dtype=wide).to(
            pol.x_dtype)
        y = (torch.randn(k, n, generator=g, device="cuda", dtype=wide)
             * k ** -0.5).to(pol.y_dtype)
        took, cfg = tiling.choose_gemm_path(m, n, k, kind, 1,
                                            G.natural_aligned(x, y))
        out, ck_col, ck_row = G.mma_gemm(x, y, kind=kind, checksum=True)
        same = torch.equal(out, G.mma_gemm(x, y, kind=kind))
        _, want_col, want_row = G.mma_gemm_sidecar_plain(x, y, kind=kind)
        mag = x.double().abs() @ y.double().abs()
        mag_col, mag_row = G.checksum_tiles(mag, *G.sidecar_tile(
            took, cfg, m))
        eps = torch.finfo(pol.acc_dtype).eps
        err = max((a.double() - b.double()).abs().max().item()
                  for a, b in ((ck_col, want_col), (ck_row, want_row)))
        ok = same and took == path and all(bool(
            ((a.double() - b.double()).abs()
             <= abft.ATOL + abft.FACTOR * eps * mg).all())
            for a, b, mg in ((ck_col, want_col, mag_col),
                             (ck_row, want_row, mag_row)))
        del mag, mag_col, mag_row
        print(f"  [{'ok' if ok else 'FAIL'}] phase 9: sidecar {label} on "
              f"{took}{f' split {cfg.split}' if took == 'stream' else ''}: "
              f"out bit for bit {same}; sums vs plain max|err| {err:.3e} "
              f"(tol ATOL + FACTOR*eps*|X||Y| summed alike)")
        if not ok:
            failures.append(f"sidecar {label}")
        row = {name: timer(fn) for name, fn in (
            ("ms", lambda: G.mma_gemm(x, y, kind=kind, checksum=True)),
            ("off_ms", lambda: G.mma_gemm(x, y, kind=kind)),
            ("plain_ms", lambda: G.mma_gemm_sidecar_plain(x, y, kind=kind)),
            ("library_ms", lambda: torch.matmul(x, y)))}
        acc = pol.acc_dtype.itemsize
        ck_bytes = (ck_col.numel() + ck_row.numel()) * acc
        row["bound_ms"], row["bound_by"] = bound_ms(
            (m * k + k * n) * x.element_size() + m * n * acc + ck_bytes,
            2 * m * n * k, {"BF16GER2": "bf16", "F32GER": "f32",
                            "F64GER": "f64"}[fam])
        print(f"  time sidecar {label}: on {row['ms']:.4f} ms, off "
              f"{row['off_ms']:.4f} ms ({row['ms'] / row['off_ms']:.3f}x), "
              f"plain {row['plain_ms']:.4f} ms, torch.matmul "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
        rows.setdefault(path, []).append((label, row, err))
        del x, y, out, ck_col, ck_row, want_col, want_row

    # K2 at D + 1 in every mode, then timed at deepseek's prefill
    worst = 0.0
    cases = (("tile", torch.bfloat16, (4, 256, 32, 32), 256, True),
             ("split", torch.bfloat16, (4, 1, 32, 32), 288, True),
             ("f32_tile", torch.float32, (1, 256, 32, 32), 256, True),
             ("f32_split", torch.float32, (4, 1, 32, 32), 288, True))
    for d in (129, 65):
        for mode, dt, (b, sq, h, kvh), sk, causal in cases:
            q, k, v = (torch.randn(s, generator=g, device="cuda").to(dt)
                       for s in ((b, sq, h, d), (b, sk, kvh, d),
                                 (b, sk, kvh, d)))
            kw = dict(causal=causal, q_offset=sk - sq,
                      out_dtype=torch.float32)
            before = A.mma_flash_attention.padded_launches_by_mode[mode]
            e, _ = check_attn_case(torch, f"attention D={d} {mode} "
                                   f"({b},{sq},{h})x{sk}", q, k, v, kw,
                                   failures)
            worst = max(worst, e)
            if A.mma_flash_attention.padded_launches_by_mode[mode] \
                    != before + 1:
                failures.append(f"attention D={d} {mode}: not a padded "
                                f"launch of {mode}")
    b, s, h, d = 4, 256, 32, 129
    q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    q8, k8, v8 = (t[..., :128].contiguous() for t in (q, k, v))
    att = {name: timer(fn) for name, fn in (
        ("ms", lambda: A.mma_flash_attention(q, k, v, causal=True)),
        ("d128_ms", lambda: A.mma_flash_attention(q8, k8, v8, causal=True)),
        ("plain_ms", lambda: A.flash_attention_plain(q, k, v, causal=True)),
        ("library_ms", lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)))}
    pairs = A.attn_live_pairs(s, s, causal=True)
    att["bound_ms"], att["bound_by"] = bound_ms(
        4 * b * s * h * d * 2, 4 * b * h * d * pairs, "bf16")
    print(f"  time attention D=129 ({b},{s},{h}) causal (padded to 192): "
          f"{att['ms']:.4f} ms, at D=128 {att['d128_ms']:.4f} ms, plain "
          f"{att['plain_ms']:.4f} ms, SDPA {att['library_ms']:.4f} ms, "
          f"bound {att['bound_ms']:.4f} ms ({att['bound_by']})")

    launched = {"sidecar": {}, "padded": {}}
    for r in PHASE9.values():
        for key in launched:
            for p, n in r.get(key, {}).items():
                launched[key][p] = launched[key].get(p, 0) + n
    sources = {"stream": "src/repro_torch/csrc/gemm_stream.cu",
               "wgmma": "src/repro_torch/csrc/gemm_wgmma.cu, "
                        "src/repro_torch/csrc/wgmma_tile.cuh",
               "wmma": "src/repro_torch/csrc/mma_gemm.cu",
               "dmma": "src/repro_torch/csrc/gemm_dmma.cu"}
    entries = []
    for path, timed in rows.items():
        label, row, _ = timed[0]
        e = {"name": f"mma_gemm sidecar ({path})", "route": "cuda",
             "source": sources[path] + ", src/repro_torch/csrc/common.cuh",
             "replaces": "src/repro/kernels/mma_gemm.py:163",
             "max_abs_err": max(err for _, _, err in timed), **row,
             "shape": label,
             "launches": launched["sidecar"].get(path, 0),
             "launches_by_run": {n: r["sidecar"][path]
                                 for n, r in PHASE9.items()
                                 if "sidecar" in r},
             "timed": {lb: r for lb, r, _ in timed}}
        entries.append(e)
    entries.append({
        "name": "mma_flash_attention padded depth (D + 1)", "route": "cuda",
        "source": "src/repro_torch/csrc/mma_attention.cu, "
                  "src/repro_torch/csrc/wgmma_ops.cuh",
        "replaces": "src/repro/kernels/mma_attention.py:193",
        "max_abs_err": worst, **att,
        "shape": f"B={b} S={s} H={h} D={d} bf16 causal",
        "launches": sum(launched["padded"].values()),
        "launches_by_mode": launched["padded"]})
    for e in entries:
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched in phase 9's runs")
    return entries


def phase9(torch, failures, entries):
    """Phase 9: the serving runs (a) ran after deepseek-7b's phase-3 run;
    here the ABFT contract runs, then the sidecar kernels and K2 at D + 1."""
    print("== phase 9: guarded serving and ABFT (runtime/faults.py, the "
          "guarded ladder, core/abft.py) and K1e, the GEMM sidecar",
          flush=True)
    t0 = time.perf_counter()
    abft_contract_runs(torch, failures)
    torch.cuda.empty_cache()
    timer = Timer(torch)
    entries += phase9_kernels(torch, timer, failures)
    del timer
    print(f"  phase 9 (after the serves): {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------
# Phase 10: autotuned dispatch (core/autotune.py, roofline/analysis.py),
# K1d on the WMMA and fp32 tiles and K3's packed filters on its WMMA and
# fp32 tiles
# ----------------------------------------------------------------------

# Per phase-10 run: its launches on packed panels by kernel entry and what
# it showed (the GEMM's WMMA launches split by the run's family).
PHASE10: dict[str, dict] = {}
# The autotune cache every run of this script reads and writes: a fresh
# temporary file (main sets REPRO_TORCH_AUTOTUNE_CACHE), empty until
# phase 10 tunes deepseek-7b's shapes, so phases 1-9 dispatch as they did
# before autotune.
TUNE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


def f32_prepacked_serve(torch, failures, model, cfg, natural):
    """deepseek-7b in the tight-parity config (F32GER, f32) served
    prepacked: a copy of phase 3's model packed under F32GER (its bf16
    weights widened once to fp32 panels), served with F32_SERVE right
    after phase 8's natural F32GER serve (``natural``: its stats, counts
    and recorded steps): every prefill and decode output bit for bit the
    natural serve's, no pack, repack or demote while serving, the
    natural serve's launches by path, and every GEMM reading panels (K1d)
    on its fp32 path: decode's on the weight stream, the prefills' on the
    fp32 tile; decode tok/s of both; then one decode step of the packed
    model profiled, its time split into GEMM, other device work and host
    (``gemm_split``)."""
    import copy

    from repro_torch.core import facility, packing
    from repro_torch.launch import serve as S

    run = f"{cfg.name} F32GER prepacked serve"
    packed = copy.deepcopy(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with facility.configure(f32_config(torch)):
        stats = packing.prepack_params_for_serving(packed,
                                                   min_size=PREPACK_MIN)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    kernels = kernel_wrappers()
    before = dict(packing.COUNTERS)
    rec = []
    with facility.configure(f32_config(torch)), recording_steps(rec):
        zero_counts(kernels)
        out = S.serve_loop(cfg, packed, **F32_SERVE)
        torch.cuda.synchronize()
        counts = read_counts(kernels)
    moved = _relayouts(dict(packing.COUNTERS), before)
    prefill, decode, what = serve_steps(torch, packed, cfg, F32_SERVE)
    with facility.configure(f32_config(torch)):
        decode()                                   # warm
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        split = gemm_split(torch, f"{run} decode step (batch "
                           f"{F32_SERVE['batch']})", decode,
                           sorted(times)[len(times) // 2])
    del packed, prefill, decode
    torch.cuda.empty_cache()
    print(f"  phase 10: {run}: packed in {pack_s:.3f} s {stats}; "
          f"{json.dumps(out)}")
    gemm = counts["by_path"]["mma_gemm"]
    n_packed = counts["packed"]["gemm wmma"] + counts["packed"]["gemm stream"]
    _check(failures, run, _same_record(torch, rec, natural["record"])
           and out["completed"] == F32_SERVE["n_requests"],
           f"{len(rec)} prefill/decode outputs (token ids and logits) bit "
           f"for bit phase 8's natural F32GER serve")
    _check(failures, run, not any(moved.values()),
           f"packing counters while serving: {moved} (all 0)")
    _check(failures, run, counts["launches"] == natural["counts"]["launches"]
           and counts["by_path"] == natural["counts"]["by_path"]
           and counts["packed"]["gemm wmma"] == gemm["wmma"] > 0
           and counts["packed"]["gemm stream"] == gemm["stream"] > 0
           and n_packed == counts["launches"]["mma_gemm"],
           f"launches {counts['launches']} equal the natural serve's; "
           f"every GEMM reading panels ({n_packed} of "
           f"{counts['launches']['mma_gemm']}: the fp32 stream "
           f"{counts['packed']['gemm stream']}, the fp32 tile "
           f"{counts['packed']['gemm wmma']})")
    print(f"  phase 10: {run}: decode tok/s {out['tokens_per_s']:.2f} "
          f"prepacked vs {natural['stats']['tokens_per_s']:.2f} natural "
          f"(phase 8, the same call)")
    PHASE10[run] = {"wmma f32": counts["packed"]["gemm wmma"],
                    "stream f32": counts["packed"]["gemm stream"],
                    "tok_s": out["tokens_per_s"],
                    "tok_s_natural": natural["stats"]["tokens_per_s"],
                    "pack_s": pack_s, "stats": stats,
                    "decode_split": split}


def f32_prepacked_generate(torch, failures, model, cfg):
    """whisper-small in the tight-parity config, a copy packed under
    F32GER: a prefill and F32_GEN's greedy decode steps bit for bit the
    natural model's (tokens and logits), no pack, repack or demote, the
    conv stem's two convs on K3's fp32 tile reading packed filters and
    the GEMMs reading panels on the fp32 tile (the encoder's) and the
    fp32 weight stream (the decoder's)."""
    import copy

    from repro_torch.core import facility, packing

    run = f"{cfg.name} F32GER prepacked generate"
    b, gen = F32_GEN["batch"], F32_GEN["gen_len"]
    batch, seq_len = mm_batch(cfg, F32_GEN, b)
    kernels = kernel_wrappers()
    nat_tokens, pk_tokens = [], []
    nat = _greedy(torch, model, cfg, batch, seq_len, gen, f32_config(torch),
                  nat_tokens)
    packed = copy.deepcopy(model)
    with facility.configure(f32_config(torch)):
        stats = packing.prepack_params_for_serving(packed,
                                                   min_size=PREPACK_MIN)
    before = dict(packing.COUNTERS)
    torch.cuda.synchronize()
    zero_counts(kernels)
    pk = _greedy(torch, packed, cfg, batch, seq_len, gen, f32_config(torch),
                 pk_tokens)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    moved = _relayouts(dict(packing.COUNTERS), before)
    del packed
    print(f"  phase 10: {run}: packed {stats}; launches "
          f"{counts['launches']}, on packed panels {counts['packed']}")
    same = (all(torch.equal(a, c) for a, c in zip(nat, pk))
            and all(torch.equal(a, c) for a, c in zip(nat_tokens,
                                                       pk_tokens)))
    _check(failures, run, same, f"prefill + {gen} decode steps: logits and "
           f"tokens bit for bit the natural model's")
    _check(failures, run, not any(moved.values())
           and counts["packed"]["conv f32"] == 2
           and counts["packed"]["gemm wmma"] > 0
           and counts["packed"]["gemm stream"] > 0,
           f"packing counters {moved} (all 0); the stem's 2 convs on the "
           f"fp32 tile's packed filters, GEMMs on panels: "
           f"{counts['packed']['gemm wmma']} on the fp32 tile, "
           f"{counts['packed']['gemm stream']} on the fp32 stream")
    PHASE10[run] = {"wmma f32": counts["packed"]["gemm wmma"],
                    "stream f32": counts["packed"]["gemm stream"],
                    "conv f32": counts["packed"]["conv f32"]}


@contextlib.contextmanager
def recording_consults(gemm, attn):
    """Record every autotune consult of the dispatch while the block runs:
    ``gemm`` gets ((kind, m, n, k, epilogue key, b), winner) of each GEMM
    (``autotune.lookup``), ``attn`` ((kind, h, sq, sk, d, epilogue key),
    winner) of each attention call (``autotune.lookup_attn``)."""
    from repro_torch.core import autotune

    lookup, lookup_attn = autotune.lookup, autotune.lookup_attn

    def spy(kind, m, n, k, epilogue_key="none", backend=None, cache=None,
            b=1):
        won = lookup(kind, m, n, k, epilogue_key, backend, cache, b)
        gemm.append(((kind, m, n, k, epilogue_key, b), won))
        return won

    def spy_attn(kind, h, sq, sk, d, epilogue_key="none", backend=None,
                 cache=None):
        won = lookup_attn(kind, h, sq, sk, d, epilogue_key, backend, cache)
        attn.append(((kind, h, sq, sk, d, epilogue_key), won))
        return won

    autotune.lookup, autotune.lookup_attn = spy, spy_attn
    try:
        yield
    finally:
        autotune.lookup, autotune.lookup_attn = lookup, lookup_attn


def tune_deepseek(torch, model, cfg, settings):
    """Every distinct GEMM and attention shape of deepseek-7b's serve (a
    batch-1 prefill of the prompt length and a decode step of the batch:
    their autotune consults, recorded) tuned into the script's cache on
    the card; one line a shape, the winner beside the heuristic, both
    measured.  Returns {key: (winner, heuristic, their ms)}."""
    from repro_torch.core import autotune, facility, tiling
    from repro_torch.kernels import mma_attention as A

    prefill, decode, _ = serve_steps(torch, model, cfg, settings)
    gemm, attn = [], []
    A.mma_flash_attention.trace = []
    with facility.configure(facility.FacilityConfig(device="cuda")), \
            recording_consults(gemm, attn):
        prefill()
        decode()
    torch.cuda.synchronize()
    launched = {(h, sq, sk, d): (b, kvh, causal, q_off)
                for b, sq, sk, h, kvh, d, _, causal, q_off, *_ in
                A.mma_flash_attention.trace}
    A.mma_flash_attention.trace = None
    out = {}
    t0 = time.perf_counter()
    for key in sorted({k for k, _ in gemm}, key=str):
        kind, m, n, k, ep, b = key
        scores = {}
        won = autotune.autotune(kind, m, n, k, b=b, epilogue_key=ep,
                                scores=scores)
        heur = tiling.choose_gemm_path(m, n, k, kind, b)
        out[key] = (won, heur, scores[won] * 1e3, scores[heur] * 1e3)
        print(f"  phase 10: tuned {kind.value} {b}x{m}x{k}x{n} [{ep}] "
              f"(key rows {autotune.tune_rows(kind, m)}): winner {won} "
              f"{scores[won] * 1e3:.4f} ms, heuristic {heur} "
              f"{scores[heur] * 1e3:.4f} ms ({len(scores)} measured)")
    for key in sorted({k for k, _ in attn}, key=str):
        kind, h, sq, sk, d, ep = key
        b, kvh, causal, q_off = launched[h, sq, sk, d]
        scores = {}
        won = autotune.autotune_attn(kind, h, sq, sk, d, b=b, kvh=kvh,
                                     causal=causal, q_offset=q_off,
                                     epilogue_key=ep, scores=scores)
        heur = A.attn_plan(b, h, sq, sk, d, kind == facility.Ger.F32GER)[:2]
        out[key] = (won, heur, scores[won] * 1e3, scores[heur] * 1e3)
        print(f"  phase 10: tuned attention {kind.value} ({b}, {sq}, {h}, "
              f"{d}) over {sk} [{ep}]: winner (q tile, split) {won} "
              f"{scores[won] * 1e3:.4f} ms, heuristic {heur} "
              f"{scores[heur] * 1e3:.4f} ms ({len(scores)} measured)")
    print(f"  phase 10: tuned {len(out)} shapes in "
          f"{time.perf_counter() - t0:.1f} s into "
          f"{autotune.default_cache().path}")
    return out


def tuned_serves(torch, failures, arch, settings, model, cfg, natural):
    """deepseek-7b under the tuned cache: its shapes tuned
    (:func:`tune_deepseek`), then served with phase 3's settings, natural
    and a packed copy, every launch's path the winner its consult read
    (the GEMM trace beside the consults, in order; no fallback), the
    packed serve bit for bit the natural one with no pack, repack or
    demote; the kernel backend's prefill (1 x the prompt length) and
    decode (the batch) logits against the eager backend within phase 3's
    bound; decode tok/s beside phase 3's; the host us of one contract
    call with an empty cache beside the full one."""
    from repro_torch.core import autotune

    # phases 1-9 and the kernel checks dispatch on the script's empty
    # cache; the tuned serves on a cache of their own
    untuned = autotune.default_cache()
    autotune._DEFAULT_CACHE = autotune.AutotuneCache(
        pathlib.Path(os.environ[TUNE_ENV]).with_name("tuned.json"))
    try:
        _tuned_serves(torch, failures, arch, settings, model, cfg, natural,
                      untuned)
    finally:
        autotune._DEFAULT_CACHE = untuned


def _tuned_serves(torch, failures, arch, settings, model, cfg, natural,
                  untuned):
    import copy

    from repro_torch.core import autotune, facility, packing
    from repro_torch.kernels import mma_gemm as G
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    tuned = tune_deepseek(torch, model, cfg, settings)
    run = f"{arch} tuned serve"
    packed = copy.deepcopy(model)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        stats = packing.prepack_params_for_serving(packed,
                                                   min_size=PREPACK_MIN)
    kernels = kernel_wrappers()
    recs, tok_s, packed_counts = {}, {}, None
    for which, m in (("natural", model), ("packed", packed)):
        rec, gemm, attn = [], [], []
        before = dict(packing.COUNTERS)
        fb = (G.mma_gemm.tuned_fallbacks,
              kernels["mma_flash_attention"].tuned_fallbacks)
        with facility.configure(facility.FacilityConfig(device="cuda")), \
                recording_steps(rec), recording_consults(gemm, attn):
            zero_counts(kernels)
            G.mma_gemm.trace = []
            out = S.serve_loop(cfg, m, **settings)
            torch.cuda.synchronize()
            counts = read_counts(kernels)
            trace, G.mma_gemm.trace = G.mma_gemm.trace, None
        moved = _relayouts(dict(packing.COUNTERS), before)
        fell = (G.mma_gemm.tuned_fallbacks - fb[0],
                kernels["mma_flash_attention"].tuned_fallbacks - fb[1])
        recs[which], tok_s[which] = rec, out["tokens_per_s"]
        print(f"  phase 10: {run} ({which}) {settings}: {json.dumps(out)}")
        follows = len(gemm) == len(trace) and all(
            won is None or t[-1] == won[0]
            for (_, won), t in zip(gemm, trace))
        hit = sum(won is not None for _, won in gemm)
        by_win = {}
        for (_, won), t in zip(gemm, trace):
            if won is not None:
                by_win[t[-1]] = by_win.get(t[-1], 0) + 1
        attn_hit = sum(won is not None for _, won in attn)
        _check(failures, f"{run} ({which})", follows and fell == (0, 0)
               and hit > 0 and attn_hit > 0,
               f"{len(trace)} GEMM launches by path "
               f"{counts['by_path']['mma_gemm']}, {hit} of them on a "
               f"winner, each on its winner's path ({by_win}); "
               f"{attn_hit} of {len(attn)} attention calls on a winner; "
               f"fallbacks {fell}")
        if which == "packed":
            packed_counts = counts["packed"]
            _check(failures, f"{run} (packed)", not any(moved.values()),
                   f"packing counters while serving: {moved} (all 0); on "
                   f"packed panels {counts['packed']}")
    del packed
    torch.cuda.empty_cache()
    _check(failures, run, _same_record(torch, recs["packed"],
                                       recs["natural"]),
           f"packed serve's {len(recs['packed'])} prefill/decode outputs "
           f"bit for bit the natural serve's under the same cache")
    b, p = settings["batch"], settings["prompt_len"]
    g = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, p), generator=g,
                           device="cuda", dtype=torch.int32)
    outs = {}
    for mode in ("kernel", "torch"):
        with facility.configure(facility.FacilityConfig(device="cuda",
                                                        backend=mode)):
            last, _ = M.prefill(model, {"tokens": prompt}, cfg)
            cache = M.init_cache(cfg, b, 64, device="cuda")
            step, _ = M.decode_step(model, cache, prompt[:, :1].expand(b, 1),
                                    cfg)
        outs[mode] = (last.float(), step[:, -1].float())
    rels = []
    for what, i in (("prefill logits", 0), ("decode logits", 1)):
        got, want = outs["kernel"][i], outs["torch"][i]
        r = _rel(got, want)
        rels.append(r)
        tol = LOGIT_TOLS[arch, what]
        _check(failures, run, bool(got.isfinite().all()) and r < tol,
               f"{what} {tuple(got.shape)} (prefill 1 x {p}, decode batch "
               f"{b}) kernel vs torch backend rel L2 {r:.3e} (phase 3's "
               f"bound {tol:.3e})")
    # host time of one contract call, an empty cache beside the full one
    full, empty = autotune.default_cache(), untuned
    gw = torch.Generator(device="cuda").manual_seed(13)
    w = (torch.randn(4096, 11008, generator=gw, device="cuda")
         * 4096 ** -0.5).bfloat16()
    xs = {"decode 4": torch.randn(4, 4096, generator=gw, device="cuda"
                                  ).bfloat16(),
          "prefill 256": torch.randn(256, 4096, generator=gw, device="cuda"
                                     ).bfloat16()}
    for x in xs.values():
        autotune.autotune(facility.Ger.BF16GER2, x.shape[0], 11008, 4096)
    host = {}
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for _ in range(7):
            for where, x in xs.items():
                for label, cache in (("empty", empty), ("full", full)):
                    autotune._DEFAULT_CACHE = cache
                    host.setdefault(f"{where} {label}", []).append(
                        host_us(torch, lambda x=x: facility.contract(
                            "mk,kn->mn", x, w)))
    autotune._DEFAULT_CACHE = full
    host = {k: {"median": sorted(v)[3], "min": min(v)}
            for k, v in host.items()}
    print(f"  phase 10: {run}: decode tok/s natural {tok_s['natural']:.2f}, "
          f"packed {tok_s['packed']:.2f} under the tuned cache (phase 3's "
          f"untuned {natural['stats']['tokens_per_s']:.2f}); host us of one "
          f"contract call (median, min of 7; {len(full)} entries in the "
          f"full cache): " + ", ".join(
              f"{k} {v['median']:.1f}, {v['min']:.1f}"
              for k, v in host.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    PHASE10[run] = {"wmma bf16": packed_counts["gemm wmma"],
                    "tok_s": tok_s, "rel_l2": rels, "host_us": host,
                    "tok_s_phase3": natural["stats"]["tokens_per_s"],
                    "pack_stats": stats,
                    "tuned": {str(k): [str(v[0]), str(v[1]), v[2], v[3]]
                              for k, v in tuned.items()}}


def phase10_kernels(torch, timer, failures):
    """K1d on the WMMA and fp32 tiles (and F32GER decode's packed Y on
    the fp32 weight stream) and K3's packed filters on its WMMA and fp32
    tiles: a main-path run through ``facility.contract`` (the entry point)
    of each mode, natural and packed, launches reset just before and read
    just after; each packed result bit for bit the natural one and held
    against the plain version of its path; the sidecar on a
    packed WMMA launch bit for bit the natural one's; the main modes timed
    (CUDA events, L2 flushed) beside the natural launch, the plain
    version, the library call and the bound.  Returns the ``kernels``
    entries."""
    from repro_torch.core import facility, packing, tiling
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(22)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    # (label, entry, family, (M, K, N), explicit block, masked, timed)
    cases = []
    for tag, (m, k, n) in (("decode", (SERVE["batch"], 4096, 11008)),
                           ("prefill", (1024, 4096, 11008))):
        for block in ((128, 128, 32), (64, 64, 64)):
            cases.append((f"bf16 block {block} {tag} {m}x{k}x{n}", "wmma",
                          Ger.BF16GER2, (m, k, n), block, False, True))
        cases.append((f"F32GER {tag} {m}x{k}x{n}",
                      "stream f32" if tag == "decode" else "wmma f32",
                      Ger.F32GER, (m, k, n), None, False, True))
    cases += [
        ("bf16 unaligned 1024x768x51865", "wmma", Ger.BF16GER2,
         (1024, 768, 51865), None, False, True),
        ("bf16 masked 1024x4096x11008", "wmma", Ger.BF16GER2,
         (1024, 4096, 11008), None, True, True),
        ("F32GER masked 1024x4096x11008", "wmma f32", Ger.F32GER,
         (1024, 4096, 11008), None, True, True),
        ("bf16 fringe 1000x330x1000", "wmma", Ger.BF16GER2,
         (1000, 330, 1000), (128, 128, 32), False, False),
        ("F32GER fringe 1000x330x1000", "wmma f32", Ger.F32GER,
         (1000, 330, 1000), None, False, False)]
    ops = []
    for label, entry, kind, (m, k, n), block, masked, timed in cases:
        dt = torch.float32 if kind == Ger.F32GER else torch.bfloat16
        x = randn(m, k, dtype=dt)
        w = randn(k, n, dtype=dt, scale=k ** -0.5)
        masks = None
        if masked:
            masks = _lane_masks(torch, g, m, n, k)
            x[~masks[0], :] = float("nan")
            w[:, ~masks[1]] = float("nan")
            w[~masks[2], :] = float("inf")
        po = packing.pack_gemm(w, packing.gemm_layout(kind, k, n))
        plan = facility.Plan(ger=kind, out_dtype=facility.ACC, block=block)
        ops.append((label, entry, kind, (m, k, n), block, masks, timed, x,
                    w, po, plan))
    img = randn(4, 1, 3001, 768)
    wc = randn(3, 768, 768, scale=(3 * 768) ** -0.5)
    patch = randn(4, 448, 448, 3)
    wp = randn(14, 14, 3, 3584, scale=588 ** -0.5)
    convs = []
    for kind in (Ger.BF16GER2, Ger.F32GER):
        dt = torch.float32 if kind == Ger.F32GER else torch.bfloat16
        entry = "conv f32" if kind == Ger.F32GER else "conv wmma"
        for label, spec, x, w, stride in (
                ("whisper conv2 4x3001x768 k3 s2", facility.CONV1D,
                 img[:, 0].to(dt), wc.to(dt), 2),
                ("qwen2-vl patch 4x448x448x3 k14 s14", facility.CONV2D,
                 patch.to(dt), wp.to(dt), (14, 14))):
            nd = 1 if spec == facility.CONV1D else 2
            kh, (kw, c, f) = ((1, w.shape) if nd == 1
                              else (w.shape[0], w.shape[1:]))
            pc = packing.pack_conv(w, packing.conv_layout(kind, kh, kw, c,
                                                          f, nd=nd))
            bias = randn(f, dtype=torch.float32)
            plan = facility.Plan(
                ger=kind, out_dtype=torch.float32, stride=stride,
                epilogue=E.Epilogue(bias=True, activation="gelu"),
                block=None if kind == Ger.F32GER else (64, 128, 32))
            convs.append((f"{kind.value} {label}", entry, spec, x, w, pc,
                          bias, plan))

    # the main path: every mode natural and packed through contract
    kernels = kernel_wrappers()
    nat, pk = {}, {}
    before = dict(packing.COUNTERS)
    torch.cuda.synchronize()
    zero_counts(kernels)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for label, _, _, _, _, masks, _, x, w, po, plan in ops:
            nat[label] = facility.contract("mk,kn->mn", x, w, masks=masks,
                                           plan=plan)
            pk[label] = facility.contract("mk,kn->mn", x, po, masks=masks,
                                          plan=plan)
        for label, _, spec, x, w, pc, bias, plan in convs:
            nat[label] = facility.contract(spec, x, w, bias=bias, plan=plan)
            pk[label] = facility.contract(spec, x, pc, bias=bias, plan=plan)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    moved = _relayouts(dict(packing.COUNTERS), before)
    n_bf16 = sum(1 for o in ops if o[1] == "wmma")
    n_stream = sum(1 for o in ops if o[1] == "stream f32")
    run = "packed modes through contract"
    _check(failures, run, not any(moved.values())
           and counts["packed"]["gemm wmma"] == len(ops) - n_stream
           and counts["packed"]["gemm stream"] == n_stream
           and counts["masked"]["wmma"] == 4
           and counts["packed"]["conv wmma"] == 2
           and counts["packed"]["conv f32"] == 2,
           f"launches {counts['launches']}, GEMM by path "
           f"{counts['by_path']['mma_gemm']}, conv by path "
           f"{counts['by_path']['mma_conv2d']}, on packed panels "
           f"{counts['packed']}; packing counters {moved} (all 0)")
    PHASE10[run] = {"wmma bf16": n_bf16, "stream f32": n_stream,
                    "wmma f32": len(ops) - n_bf16 - n_stream,
                    "conv wmma": counts["packed"]["conv wmma"],
                    "conv f32": counts["packed"]["conv f32"]}

    rows = {}
    for label, entry, kind, (m, k, n), block, masks, timed, x, w, po, \
            plan in ops:
        _check(failures, f"K1d {label}", torch.equal(pk[label], nat[label])
               and bool(torch.isfinite(pk[label]).all()),
               "packed bit for bit the natural launch, finite")
        gk = dict(kind=kind, block=block, masks=masks)
        path, cfg = tiling.choose_gemm_path(m, n, k, kind, 1, True, block,
                                            masks is not None)
        plain = lambda x=x, w=w, gk=gk, f=G._plain_of(  # noqa: E731
            path, cfg, k): f(x, w, kind=gk["kind"], masks=gk["masks"])
        err = _report_close(torch, f"K1d {label} vs plain", pk[label],
                            plain(), torch.float32, failures)
        if not timed:
            continue
        xs, ws = (G.select_masks(x, w, masks) if masks is not None
                  else (x, w))
        row = {"ms": timer(lambda x=x, po=po, gk=gk: G.mma_gemm(
                   x, po.data, y_layout=po.layout, **gk)),
               "natural_ms": timer(lambda x=x, w=w, gk=gk: G.mma_gemm(
                   x, w, **gk)),
               "plain_ms": timer(plain),
               "library_ms": timer(
                   (lambda x=x, w=w, masks=masks: torch.matmul(
                       *G.select_masks(x, w, masks)))
                   if masks is not None else
                   (lambda x=x, w=w: torch.matmul(x, w)))}
        del xs, ws
        # the bound counts the enabled lanes' work where masks are on
        me, ne, ke = ((int(t.sum()) for t in masks) if masks is not None
                      else (m, n, k))
        isz = 4 if kind == Ger.F32GER else 2
        nbytes = (me * ke + ke * ne) * isz + m * n * 4
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2 * me * ne * ke, "f32" if kind == Ger.F32GER
            else "bf16")
        print(f"  time K1d {label}: packed {row['ms']:.4f} ms, natural "
              f"{row['natural_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.setdefault(entry, {})[label] = (row, err)
    # the sidecar on a packed WMMA launch (K1e over K1d)
    for label, _, kind, (m, k, n), block, masks, _, x, w, po, _ in ops:
        if masks is None and block is not None and m > 64:
            want = G.mma_gemm(x, w, kind=kind, block=block, checksum=True)
            got = G.mma_gemm(x, po.data, kind=kind, block=block,
                             checksum=True, y_layout=po.layout)
            _check(failures, f"K1d {label} checksum=True",
                   all(torch.equal(a, c) for a, c in zip(got, want)),
                   "out, ck_col and ck_row bit for bit the natural "
                   "launch's")
            break
    for label, entry, spec, x, w, pc, bias, plan in convs:
        _check(failures, f"K3 packed {label}",
               torch.equal(pk[label], nat[label]),
               "packed filters bit for bit the natural launch")
        x4 = x[:, None] if spec == facility.CONV1D else x
        w4 = w[None] if spec == facility.CONV1D else w
        stride = (1, plan.stride) if spec == facility.CONV1D else plan.stride
        ckw = dict(stride=stride, ep=plan.epilogue, bias=bias,
                   out_dtype=torch.float32, bf=(plan.block or (0, None))[1])
        plain = lambda x4=x4, w4=w4, ckw=ckw: K.mma_conv2d_plain(  # noqa
            x4, w4, stride=ckw["stride"], ep=ckw["ep"], bias=ckw["bias"],
            out_dtype=torch.float32)
        got4 = pk[label][:, None] if spec == facility.CONV1D else pk[label]
        err = _report_close(torch, f"K3 packed {label} vs plain", got4,
                            plain(), torch.float32, failures)
        layout = pc.layout
        kh, kw, c, f = layout.kh, layout.kw, layout.c, layout.f
        n, h, wd, _ = x4.shape
        oh, ow = (h - kh) // stride[0] + 1, (wd - kw) // stride[1] + 1
        w_nchw = w4.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        x_nchw = x4.permute(0, 3, 1, 2)
        b16 = bias.to(x.dtype)
        row = {"ms": timer(lambda x4=x4, pc=pc, ckw=ckw: K.mma_conv2d(
                   x4, pc.data, w_layout=pc.layout, **ckw)),
               "natural_ms": timer(lambda x4=x4, w4=w4, ckw=ckw: K.mma_conv2d(
                   x4, w4, **ckw)),
               "plain_ms": timer(plain),
               "library_ms": timer(
                   lambda x_nchw=x_nchw, w_nchw=w_nchw, b16=b16, s=stride:
                   torch.nn.functional.conv2d(x_nchw, w_nchw, b16,
                                              stride=s))}
        isz = x.element_size()
        nbytes = (x4.numel() + w4.numel()) * isz + n * oh * ow * f * 4 \
            + f * 4
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2 * n * oh * ow * f * kh * kw * c,
            "f32" if x.dtype == torch.float32 else "bf16")
        print(f"  time K3 packed {label}: packed {row['ms']:.4f} ms, "
              f"natural {row['natural_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, cuDNN {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.setdefault(entry, {})[label] = (row, err)
    del ops, convs, nat, pk

    names = {"wmma": "mma_gemm packed Y (wmma)",
             "wmma f32": "mma_gemm packed Y (wmma f32)",
             "stream f32": "mma_gemm packed Y (stream f32)",
             "conv wmma": "mma_conv2d packed filters (wmma)",
             "conv f32": "mma_conv2d packed filters (f32)"}
    counter = {"wmma": "wmma bf16", "wmma f32": "wmma f32",
               "stream f32": "stream f32",
               "conv wmma": "conv wmma", "conv f32": "conv f32"}
    entries = []
    for key, by_label in rows.items():
        label, (row, _) = next(iter(by_label.items()))
        conv = key.startswith("conv")
        e = {"name": names[key], "route": "cuda",
             "source": ("src/repro_torch/csrc/mma_conv.cu" if conv
                        else "src/repro_torch/csrc/gemm_stream.cu"
                        if key == "stream f32"
                        else "src/repro_torch/csrc/mma_gemm.cu"),
             "replaces": ("src/repro/kernels/mma_conv.py:176" if conv
                          else "src/repro/kernels/mma_gemm.py:333"),
             "max_abs_err": max(err for _, err in by_label.values()),
             **row, "shape": label,
             "launches_by_run": {r: v.get(counter[key], 0)
                                 for r, v in PHASE10.items()},
             "timed": {lb: r for lb, (r, _) in by_label.items()}}
        e["launches"] = sum(e["launches_by_run"].values())
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched in phase 10's runs")
        entries.append(e)
    return entries


def phase10(torch, failures, entries):
    """Phase 10: the serving runs (the F32GER prepacked serve and
    generation, the tuned serves) ran after their models' phase-3 runs;
    here the packed WMMA/fp32 modes through contract, checked and
    timed."""
    print("== phase 10: autotuned dispatch (core/autotune.py, "
          "roofline/analysis.py), K1d on the WMMA and fp32 tiles, K3's "
          "packed filters on its WMMA and fp32 tiles", flush=True)
    t0 = time.perf_counter()
    for name, r in PHASE10.items():
        print(f"  {name}: " + json.dumps(
            {k: v for k, v in r.items() if k not in ("tuned",)},
            default=str))
    timer = Timer(torch)
    entries += phase10_kernels(torch, timer, failures)
    del timer
    print(f"  phase 10 (after the serves): {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------
# Phase 11: the last TPU kernel forms (K1d's panels on every GEMM path,
# K2d's full-grid attention)
# ----------------------------------------------------------------------

# name: (family, packed sides, (M, K, N), explicit block, masked, the path
# its natural operands take).  DGEMM with X, Y and both packed (masked
# too), the integer families, X panels on the weight stream (decode), the
# wgmma tile and the WMMA/fp32 tiles (prefill), and the weight on the X
# side (11008 x 4096 x 4: its 8-byte N pitch sends it to the WMMA tile).
K1D_MODES = {
    "DGEMM 2048^3 Y packed": (("y",), (2048, 2048, 2048), "F64GER", None,
                              False, "dmma"),
    "DGEMM 2048^3 X packed": (("x",), (2048, 2048, 2048), "F64GER", None,
                              False, "dmma"),
    "DGEMM 2048^3 X+Y packed": (("x", "y"), (2048, 2048, 2048), "F64GER",
                                None, False, "dmma"),
    "DGEMM 2048^3 X+Y packed, masked": (("x", "y"), (2048, 2048, 2048),
                                        "F64GER", None, True, "dmma"),
    "I8GER4 4096^3 Y packed": (("y",), (4096, 4096, 4096), "I8GER4", None,
                               False, "imma"),
    "I8GER4 4096^3 X+Y packed": (("x", "y"), (4096, 4096, 4096), "I8GER4",
                                 None, False, "imma"),
    "I8GER4 4096^3 X+Y packed, masked": (("x", "y"), (4096, 4096, 4096),
                                         "I8GER4", None, True, "imma"),
    "I16GER2 4096^3 X packed": (("x",), (4096, 4096, 4096), "I16GER2", None,
                                False, "imma"),
    "I16GER2 4096^3 Y packed": (("y",), (4096, 4096, 4096), "I16GER2", None,
                                False, "imma"),
    "decode 4x4096x11008 X packed": (("x",), (4, 4096, 11008), "BF16GER2",
                                     None, False, "stream"),
    "prefill 1024x4096x11008 X packed": (("x",), (1024, 4096, 11008),
                                         "BF16GER2", None, False, "wgmma"),
    "prefill 1024x4096x11008 X+Y packed": (("x", "y"), (1024, 4096, 11008),
                                           "BF16GER2", None, False,
                                           "wgmma"),
    "prefill 1024x4096x11008 X packed, block (128, 128, 32)": (
        ("x",), (1024, 4096, 11008), "BF16GER2", (128, 128, 32), False,
        "wmma"),
    "prefill 1024x4096x11008 X packed, masked": (
        ("x",), (1024, 4096, 11008), "BF16GER2", None, True, "wmma"),
    "F32GER prefill 1024x4096x11008 X packed": (
        ("x",), (1024, 4096, 11008), "F32GER", None, False, "wmma"),
    "weight on X 11008x4096x4": (("x",), (11008, 4096, 4), "BF16GER2", None,
                                 False, "wmma"),
}
# The kernels line's entry of each path's packed modes (the WMMA bf16 and
# fp32 tiles are one path, counted together).
K1D_ENTRIES = {
    "dmma": ("mma_gemm packed X/Y (dmma)", "gemm_dmma.cu"),
    "imma": ("mma_gemm packed X/Y (imma)", "gemm_imma.cu"),
    "stream": ("mma_gemm packed X (stream)", "gemm_stream.cu"),
    "wgmma": ("mma_gemm packed X (wgmma)", "gemm_wgmma.cu"),
    "wmma": ("mma_gemm packed X (wmma, bf16 and fp32 tiles)", "mma_gemm.cu"),
}
# K2d: (name, q (B, S, H, D), flags): causal prefill at deepseek-7b's
# heads, a batch of shorter causal prompts, and a sliding window.
K2D_CASES = (("causal (1,256,32,128)", (1, 256, 32, 128),
              dict(causal=True)),
             ("causal (2,512,4,64)", (2, 512, 4, 64), dict(causal=True)),
             ("window 512 (1,2048,32,128)", (1, 2048, 32, 128),
              dict(causal=True, window=512)))


def _k1d_operands(torch, g, kind, m, k, n):
    """x (M, K) and y (K, N) in ``kind``'s input dtypes: full-range
    integers, unit normals (y scaled by K^-1/2) otherwise."""
    from repro_torch.core import precision
    pol = precision.policy(kind)
    if pol.is_integer:
        return _int_operands(torch, g, kind, (), m, k, n)
    x = torch.randn(m, k, generator=g, device="cuda", dtype=torch.float64)
    y = torch.randn(k, n, generator=g, device="cuda",
                    dtype=torch.float64) * k ** -0.5
    return x.to(pol.x_dtype), y.to(pol.y_dtype)


def phase11_kernels(torch, timer, failures):
    """K1d on every GEMM path and K2d's full grid: a main-path run of every
    mode (each natural and packed through ``facility.contract``, and the
    attention cases bounded and on the full grid through
    ``mma_flash_attention``), counts zeroed just before and read just
    after; each packed result bit for bit the natural one and held against
    the plain version; the sidecar on packed DMMA, stream and wgmma
    launches bit for bit; then each mode timed (CUDA events, L2 flushed)
    beside its natural launch, the plain version, the library call and the
    bound.  Returns the ``kernels`` entries."""
    from repro_torch.core import facility, packing
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_gemm as G

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(23)
    ops = []
    for label, (sides, (m, k, n), fam, block, masked, path) in \
            K1D_MODES.items():
        kind = Ger[fam]
        x, y = _k1d_operands(torch, g, kind, m, k, n)
        masks = None
        if masked:
            masks = _lane_masks(torch, g, m, n, k)
            if kind not in (Ger.I8GER4, Ger.I16GER2):
                x[~masks[0], :] = float("nan")
                y[:, ~masks[1]] = float("inf")
                y[~masks[2], :] = float("nan")
        px = (packing.pack_gemm(x, packing.gemm_layout(kind, m, k, side="x"))
              if "x" in sides else x)
        py = (packing.pack_gemm(y, packing.gemm_layout(kind, k, n))
              if "y" in sides else y)
        plan = facility.Plan(ger=kind, out_dtype=facility.ACC, block=block)
        ops.append((label, path, kind, (m, k, n), block, masks, x, y, px,
                    py, plan))
    attn = []
    for label, (b, s, h, d), kw in K2D_CASES:
        q, k_, v = (torch.randn(b, s, h, d, generator=g, device="cuda"
                                ).bfloat16() for _ in range(3))
        attn.append((label, q, k_, v, kw))

    # the main path: every mode natural and packed through contract, the
    # attention cases bounded and full
    kernels = kernel_wrappers()
    nat, pk, bounded, full = {}, {}, {}, {}
    before = dict(packing.COUNTERS)
    torch.cuda.synchronize()
    zero_counts(kernels)
    A.mma_flash_attention.full_grid_launches = 0
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for label, _, _, _, _, masks, x, y, px, py, plan in ops:
            nat[label] = facility.contract("mk,kn->mn", x, y, masks=masks,
                                           plan=plan)
            pk[label] = facility.contract("mk,kn->mn", px, py, masks=masks,
                                          plan=plan)
    for label, q, k_, v, kw in attn:
        bounded[label] = A.mma_flash_attention(q, k_, v, **kw)
        full[label] = A.mma_flash_attention(q, k_, v, bound_grid=False, **kw)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    full_grid = A.mma_flash_attention.full_grid_launches
    moved = _relayouts(dict(packing.COUNTERS), before)
    want = {}
    for _, path, *_ in ops:
        want[path] = want.get(path, 0) + 1
    packed = {p: counts["packed"][f"gemm {p}"] for p in G.PACKED_PATHS}
    _check(failures, "phase 11 main path", not any(moved.values())
           and all(packed[p] == want.get(p, 0) for p in packed)
           and full_grid == len(attn),
           f"GEMM by path {counts['by_path']['mma_gemm']}, on packed panels "
           f"{packed} (want {want}), masked {counts['masked']}, attention "
           f"{counts['attn_by_mode']} of which full grid {full_grid}; "
           f"packing counters {moved} (all 0)")
    phase = dict(packed_launches_by_path=packed,
                 full_grid_launches=full_grid, demotes=moved["demote"])

    rows = {}
    for label, path, kind, (m, k, n), block, masks, x, y, px, py, \
            plan in ops:
        _check(failures, f"K1d {label}", torch.equal(pk[label], nat[label])
               and (kind in (Ger.I8GER4, Ger.I16GER2)
                    or bool(torch.isfinite(pk[label]).all())),
               "packed bit for bit the natural launch" + (
                   ", finite" if kind not in (Ger.I8GER4, Ger.I16GER2)
                   else ""))
        gk = dict(kind=kind, block=block, masks=masks)
        plain = lambda x=x, y=y, gk=gk: G.mma_gemm_plain(  # noqa: E731
            x, y, kind=gk["kind"], masks=gk["masks"])
        want_p = plain()
        if kind in (Ger.I8GER4, Ger.I16GER2):
            err = float((pk[label].long() - want_p.long()).abs().max())
            _check(failures, f"K1d {label} vs plain", err == 0,
                   "bit for bit the plain version (int32)")
        elif kind == Ger.F64GER:
            xs, ys = G.select_masks(x, y, masks) if masks else (x, y)
            err = (pk[label] - want_p).abs().max().item()
            tol = 1e-15 * k * xs.abs().max().item() * ys.abs().max().item()
            _check(failures, f"K1d {label} vs plain", err <= tol,
                   f"max|err| {err:.3e} (tol {tol:.3e})")
            del xs, ys
        else:
            err = _report_close(torch, f"K1d {label} vs plain", pk[label],
                                want_p, torch.float32, failures)
        del want_p
        lay = dict(x_layout=px.layout if px is not x else None,
                   y_layout=py.layout if py is not y else None)
        xd = px.data if px is not x else x
        yd = py.data if py is not y else y
        row = {"ms": timer(lambda xd=xd, yd=yd, gk=gk, lay=lay: G.mma_gemm(
                   xd, yd, **gk, **lay)),
               "natural_ms": timer(lambda x=x, y=y, gk=gk: G.mma_gemm(
                   x, y, **gk)),
               "plain_ms": timer(plain)}
        if kind in (Ger.I8GER4, Ger.I16GER2):
            s8 = torch.randint(-128, 128, (k, n), generator=g,
                               device="cuda", dtype=torch.int8)
            x8 = (x if kind == Ger.I8GER4 else torch.randint(
                -128, 128, (m, k), generator=g, device="cuda",
                dtype=torch.int8))
            row["library_ms"] = timer(lambda x8=x8, s8=s8: torch._int_mm(
                x8, s8))
            row["library"] = ("torch._int_mm s8 x s8 of the shape (not the "
                              "same function)")
            del s8, x8
        elif masks is not None:
            row["library_ms"] = timer(
                lambda x=x, y=y, masks=masks: torch.matmul(
                    *G.select_masks(x, y, masks)))
            row["library"] = "torch.where + torch.matmul"
        else:
            row["library_ms"] = timer(lambda x=x, y=y: torch.matmul(x, y))
            row["library"] = "torch.matmul " + str(x.dtype)[6:]
        me, ne, ke = ((int(t.sum()) for t in masks) if masks is not None
                      else (m, n, k))
        products = {Ger.I16GER2: 4}.get(kind, 1)
        peak = {Ger.F64GER: "f64", Ger.I8GER4: "int8", Ger.I16GER2: "int8",
                Ger.F32GER: "f32"}.get(kind, "bf16")
        nbytes = (me * ke * x.element_size() + ke * ne * y.element_size()
                  + m * n * nat[label].element_size())
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2 * me * ne * ke * products, peak)
        print(f"  time K1d {label}: packed {row['ms']:.4f} ms, natural "
              f"{row['natural_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"{row['library']} {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.setdefault(path, {})[label] = (row, err)
    # the sidecar on packed launches (K1e over K1d): out and both sums bit
    # for bit the natural launch's
    for label, path, kind, _, block, masks, x, y, px, py, _ in ops:
        if masks is not None or path not in ("dmma", "stream", "wgmma"):
            continue
        lay = dict(x_layout=px.layout if px is not x else None,
                   y_layout=py.layout if py is not y else None)
        want_c = G.mma_gemm(x, y, kind=kind, block=block, checksum=True)
        got_c = G.mma_gemm(px.data if px is not x else x,
                           py.data if py is not y else y, kind=kind,
                           block=block, checksum=True, **lay)
        _check(failures, f"K1d {label} checksum=True",
               all(torch.equal(a, c) for a, c in zip(got_c, want_c)),
               "out, ck_col and ck_row bit for bit the natural launch's")
    del ops, nat, pk

    # K2d: full against bounded, each against the plain version, timed
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn_rows, attn_err = {}, 0.0
    for label, q, k_, v, kw in attn:
        _check(failures, f"K2d {label}",
               torch.equal(full[label], bounded[label]),
               "the full grid bit for bit the bounded launch (tile mode)")
        e, _ = check_attn_case(torch, f"K2d {label} full grid", q, k_, v,
                               {**kw, "bound_grid": False}, failures)
        attn_err = max(attn_err, e)
        b, s, h, d = q.shape
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k_, v))
        mask = None
        if "window" in kw:
            pos = torch.arange(s, device="cuda")
            mask = ((pos[:, None] >= pos[None, :])
                    & (pos[:, None] - pos[None, :] < kw["window"]))
        row = {"ms": timer(lambda q=q, k_=k_, v=v, kw=kw:
                           A.mma_flash_attention(q, k_, v, bound_grid=False,
                                                 **kw), iters=5),
               "bounded_ms": timer(lambda q=q, k_=k_, v=v, kw=kw:
                                   A.mma_flash_attention(q, k_, v, **kw),
                                   iters=5),
               "plain_ms": timer(lambda q=q, k_=k_, v=v, kw=kw:
                                 A.flash_attention_plain(q, k_, v, **kw),
                                 iters=5),
               "library_ms": timer(
                   (lambda qt=qt, kt=kt, vt=vt: sdpa(qt, kt, vt,
                                                     is_causal=True))
                   if mask is None else
                   (lambda qt=qt, kt=kt, vt=vt, mask=mask: sdpa(
                       qt, kt, vt, attn_mask=mask)), iters=5)}
        bq, n_split, _ = A.attn_plan(b, h, s, s, d, False)
        step = A.kv_step(d, False, n_split)   # the keys a kernel step walks
        row["steps_full"] = -(-s // bq) * -(-s // step)
        row["steps_bounded"] = A.attn_live_steps(s, s, bq, step,
                                                 **{k2: v2 for k2, v2
                                                    in kw.items()})
        pairs = A.attn_live_pairs(s, s, **kw)
        row["bound_ms"], row["bound_by"] = bound_ms(
            4 * b * s * h * d * 2, 4 * d * pairs * b * h, "bf16")
        print(f"  time K2d {label}: full grid {row['ms']:.4f} ms "
              f"({row['steps_full']} steps a (b, h)), bounded "
              f"{row['bounded_ms']:.4f} ms ({row['steps_bounded']} steps), "
              f"plain {row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
        attn_rows[label] = row
    del attn, bounded, full

    # each entry's launches: its path's packed launches in the run above
    entries = []
    for path, by_label in rows.items():
        name, src = K1D_ENTRIES[path]
        label, (row, _) = next(iter(by_label.items()))
        e = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{src}",
             "replaces": "src/repro/kernels/mma_gemm.py:333",
             "launches": packed[path],
             "max_abs_err": max(err for _, err in by_label.values()),
             **row, "shape": label,
             "packed_launches_by_path": {path: packed[path]},
             "timed": {lb: r for lb, (r, _) in by_label.items()}}
        entries.append(e)
    label, row = next(iter(attn_rows.items()))
    entries.append({"name": "mma_flash_attention full grid",
                    "route": "cuda",
                    "source": "src/repro_torch/csrc/mma_attention.cu",
                    "replaces": "src/repro/kernels/mma_attention.py:201",
                    "launches": full_grid, "full_grid_launches": full_grid,
                    "max_abs_err": attn_err, **row, "shape": label,
                    "timed": attn_rows})
    for e in entries:
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched in phase 11's run")
    entries[0]["phase11"] = phase
    return entries


def phase11(torch, failures, entries):
    """Phase 11: K1d's panels on every GEMM path and K2d's full grid,
    through the entry points, checked and timed."""
    print("== phase 11: K1d's panels on every GEMM path (DMMA, IMMA, X "
          "panels on the stream, the wgmma tile and the WMMA/fp32 tiles) "
          "and K2d's full-grid attention", flush=True)
    t0 = time.perf_counter()
    timer = Timer(torch)
    entries += phase11_kernels(torch, timer, failures)
    del timer
    torch.cuda.empty_cache()
    print(f"  phase 11: {time.perf_counter() - t0:.1f} s")


# Phase 12: the 16-bit WMMA tile's forms at the main path's shapes.
# (label, family, (B, M, K, N), explicit block, masked, Y packed)
WMMA_CASES = (
    ("bf16 block (128, 128, 32) 1024x4096x11008", "BF16GER2",
     (None, 1024, 4096, 11008), (128, 128, 32), False, False),
    ("bf16 block (64, 64, 64) 1024x4096x11008", "BF16GER2",
     (None, 1024, 4096, 11008), (64, 64, 64), False, False),
    ("bf16 unaligned 1024x768x51865", "BF16GER2", (None, 1024, 768, 51865),
     None, False, False),
    ("bf16 unaligned 1024x768x51865 packed Y", "BF16GER2",
     (None, 1024, 768, 51865), None, False, True),
    ("bf16 masked 1024x4096x11008", "BF16GER2", (None, 1024, 4096, 11008),
     None, True, False),
    ("f16 block (128, 128, 32) 1024x4096x11008", "F16GER2",
     (None, 1024, 4096, 11008), (128, 128, 32), False, False),
    ("bf16 SSD K=1 outer 4x(64x1x4096)", "BF16GER2", (4, 64, 1, 4096), None,
     False, False),
)
# K3 at its WMMA filter tile: (label, image NHWC, filters HWIO, stride)
WMMA_CONV_CASES = (
    ("conv2 whisper 4x3001x768 k3 s2", (4, 1, 3001, 768), (1, 3, 768, 768),
     (1, 2)),
    ("patch embed qwen2-vl 4x448x448x3 k14 s14", (4, 448, 448, 3),
     (14, 14, 3, 3584), (14, 14)),
)
# The parent kernel's times at these forms, as PERF.md section 6 records
# them (runs Z3 and V7 there, NVIDIA H100 80GB HBM3 at 700 W): printed
# beside this run's times for the reader, never put in the kernels line.
WMMA_PERF_MD_PARENT_MS = {
    WMMA_CASES[0][0]: 1.0832, WMMA_CASES[1][0]: 0.9975,
    WMMA_CASES[2][0]: 1.2548, WMMA_CASES[3][0]: 1.1477,
    WMMA_CASES[4][0]: 1.1953, WMMA_CONV_CASES[0][0]: 0.3349,
    WMMA_CONV_CASES[1][0]: 0.3491}


def _perf_md_parent(label):
    ms = WMMA_PERF_MD_PARENT_MS.get(label)
    return ("parent in PERF.md: not measured" if ms is None
            else f"parent in PERF.md: {ms} ms")


def phase12_kernels(torch, timer, failures):
    """The redesigned 16-bit WMMA tile (K1's bf16/f16 products off the
    stream and wgmma paths, K3's WMMA conv): a main-path run of every form
    through ``facility.contract``, counts zeroed just before and read just
    after; each result against its plain version, packed Y bit for bit
    the natural launch; then each form timed (CUDA events, L2 flushed)
    beside the plain version, the library call and the bound, with the
    parent kernel's PERF.md time printed beside it.  Returns the two
    ``kernels`` entries."""
    from repro_torch.core import facility, packing, precision
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(25)
    ops = []
    for label, fam, (b, m, k, n), block, masked, packed in WMMA_CASES:
        kind = Ger[fam]
        dt = precision.policy(kind).x_dtype
        lead = () if b is None else (b,)
        x = torch.randn(*lead, m, k, generator=g, device="cuda").to(dt)
        w = (torch.randn(*lead, k, n, generator=g, device="cuda")
             * k ** -0.5).to(dt)
        masks = None
        if masked:
            masks = _lane_masks(torch, g, m, n, k)
            x[~masks[0], :] = float("nan")
            w[:, ~masks[1]] = float("nan")
            w[~masks[2], :] = float("inf")
        po = (packing.pack_gemm(w, packing.gemm_layout(kind, k, n))
              if packed else None)
        plan = facility.Plan(ger=kind, out_dtype=facility.ACC, block=block)
        ops.append((label, kind, (b, m, k, n), block, masks, x, w, po, plan))
    convs = []
    for label, ishape, wshape, stride in WMMA_CONV_CASES:
        kh, kw, c, f = wshape
        x = torch.randn(*ishape, generator=g, device="cuda").bfloat16()
        w = (torch.randn(*wshape, generator=g, device="cuda")
             * (kh * kw * c) ** -0.5).bfloat16()
        bias = torch.randn(f, generator=g, device="cuda")
        plan = facility.Plan(ger=Ger.BF16GER2, out_dtype=torch.float32,
                             stride=stride, block=(64, 128, 32),
                             epilogue=E.Epilogue(bias=True,
                                                 activation="gelu"))
        convs.append((label, x, w, bias, plan))

    # the main path: every form through contract
    kernels = kernel_wrappers()
    outs = {}
    torch.cuda.synchronize()
    zero_counts(kernels)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for label, _, _, _, masks, x, w, po, plan in ops:
            outs[label] = facility.contract(
                "mk,kn->mn" if x.ndim == 2 else "bmk,bkn->bmn", x,
                w if po is None else po, masks=masks, plan=plan)
        for label, x, w, bias, plan in convs:
            outs[label] = facility.contract(facility.CONV2D, x, w,
                                            bias=bias, plan=plan)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    gemm_wmma = counts["by_path"]["mma_gemm"]["wmma"]
    conv_wmma = counts["by_path"]["mma_conv2d"]["wmma"]
    _check(failures, "phase 12 main path",
           gemm_wmma == len(ops) and conv_wmma == len(convs)
           and counts["masked"]["wmma"] == sum(
               o[4] is not None for o in ops)
           and counts["packed"]["gemm wmma"] == sum(
               o[7] is not None for o in ops),
           f"GEMM by path {counts['by_path']['mma_gemm']}, conv by path "
           f"{counts['by_path']['mma_conv2d']}, masked {counts['masked']}, "
           f"packed {counts['packed']} (wmma: {len(ops)} products, "
           f"{len(convs)} convs)")
    main_wmma = sum(r["by_path"]["mma_gemm"]["wmma"]
                    for r in RECORDS.values())

    rows, errs = {}, {}
    for label, kind, (b, m, k, n), block, masks, x, w, po, plan in ops:
        gk = dict(kind=kind, block=block, masks=masks)
        plain = lambda x=x, w=w, gk=gk: G.mma_gemm_plain(  # noqa: E731
            x, w, kind=gk["kind"], masks=gk["masks"])
        errs[label] = _report_close(torch, f"wmma {label} vs plain",
                                    outs[label], plain(), torch.float32,
                                    failures)
        if po is not None:
            _check(failures, f"wmma {label}", torch.equal(
                outs[label], G.mma_gemm(x, w, **gk)),
                "packed Y bit for bit the natural launch")
        yk, lay = (w, {}) if po is None else (po.data,
                                              {"y_layout": po.layout})
        row = {"ms": timer(lambda x=x, yk=yk, gk=gk, lay=lay: G.mma_gemm(
                   x, yk, **gk, **lay)),
               "plain_ms": timer(plain),
               "library_ms": timer(
                   (lambda x=x, w=w, masks=masks: torch.matmul(
                       *G.select_masks(x, w, masks)))
                   if masks is not None else
                   (lambda x=x, w=w: torch.matmul(x, w))),
               "library": ("torch.where + torch.matmul" if masks is not None
                           else "torch.matmul")}
        me, ne, ke = ((int(t.sum()) for t in masks) if masks is not None
                      else (m, n, k))
        nb = b or 1
        nbytes = nb * ((me * ke + ke * ne) * 2 + m * n * 4)
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2 * nb * me * ne * ke, "bf16")
        print(f"  time wmma {label}: {row['ms']:.4f} ms "
              f"({_perf_md_parent(label)}), plain "
              f"{row['plain_ms']:.4f} ms, {row['library']} "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
        rows[label] = row
    conv_rows, conv_errs = {}, {}
    for label, x, w, bias, plan in convs:
        ckw = dict(stride=plan.stride, ep=plan.epilogue, bias=bias,
                   out_dtype=torch.float32)
        plain = lambda x=x, w=w, ckw=ckw: K.mma_conv2d_plain(  # noqa: E731
            x, w, **ckw)
        conv_errs[label] = _report_conv(torch, f"conv wmma {label} vs plain",
                                        outs[label], plain(), torch.float32,
                                        failures)
        kh, kw, c, f = w.shape
        n, h, wd, _ = x.shape
        oh = (h - kh) // plan.stride[0] + 1
        ow = (wd - kw) // plan.stride[1] + 1
        w_nchw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        x_nchw = x.permute(0, 3, 1, 2)
        b16 = bias.bfloat16()
        row = {"ms": timer(lambda x=x, w=w, ckw=ckw: K.mma_conv2d(
                   x, w, bf=128, **ckw)),
               "plain_ms": timer(plain),
               "library_ms": timer(
                   lambda x_nchw=x_nchw, w_nchw=w_nchw, b16=b16,
                   s=plan.stride: torch.nn.functional.conv2d(
                       x_nchw, w_nchw, b16, stride=s)),
               "library": "cuDNN conv2d (channels-last)"}
        nbytes = (x.numel() + w.numel()) * 2 + n * oh * ow * f * 4 + f * 4
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2 * n * oh * ow * f * kh * kw * c, "bf16")
        print(f"  time conv wmma {label}: {row['ms']:.4f} ms "
              f"({_perf_md_parent(label)}), plain {row['plain_ms']:.4f} ms, "
              f"cuDNN {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        conv_rows[label] = row
    del ops, convs, outs

    label = WMMA_CASES[0][0]
    entries = [
        {"name": "mma_gemm 16-bit tile (wmma)", "route": "cuda",
         "source": "src/repro_torch/csrc/tile_gemm.cuh",
         "replaces": "src/repro/kernels/mma_gemm.py:417",
         "launches": gemm_wmma, "main_path_launches": main_wmma,
         "max_abs_err": max(errs.values()), **rows[label], "shape": label,
         "timed": rows},
        {"name": "mma_conv2d WMMA tile", "route": "cuda",
         "source": "src/repro_torch/csrc/mma_conv.cu",
         "replaces": "src/repro/kernels/mma_conv.py:191",
         "launches": conv_wmma, "max_abs_err": max(conv_errs.values()),
         **conv_rows[WMMA_CONV_CASES[0][0]],
         "shape": WMMA_CONV_CASES[0][0], "timed": conv_rows}]
    if main_wmma <= 0:
        failures.append("the 16-bit WMMA tile never launched on the main "
                        "path's runs (phases 3 and 5)")
    for e in entries:
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched in phase 12's run")
    return entries


def phase12(torch, failures, entries):
    """Phase 12: the redesigned 16-bit WMMA tile and K3's WMMA conv at the
    forms the main path gives them, checked and timed; the parent kernel's
    PERF.md time is printed beside each."""
    print("== phase 12: the 16-bit WMMA tile (cp.async ring, ldmatrix, "
          "mma.sync) and K3's WMMA conv", flush=True)
    t0 = time.perf_counter()
    timer = Timer(torch)
    entries += phase12_kernels(torch, timer, failures)
    del timer
    torch.cuda.empty_cache()
    print(f"  phase 12: {time.perf_counter() - t0:.1f} s")


# Phase 13: K2's 16-bit tile mode (flash_tile_kernel: persistent blocks,
# ping-ponged consumers, 128-key steps at D <= 128) at the main path's
# prefill and train shapes.  (label, (B, Sq, H, D), (Sk, KVH), flags, the
# parent kernel's time in PERF.md section 6 (NVIDIA H100 80GB HBM3 at 700
# W: printed for the reader, never put in the kernels line), the target:
# ("ms", t) or ("sdpa", factor of SDPA's time in the same run))
ATTN_TARGETS = (
    ("causal (1,4096,32,128)", (1, 4096, 32, 128), (4096, 32),
     dict(causal=True), 0.6333, ("ms", 0.30)),
    ("deepseek-7b train causal (4,512,32,128)", (4, 512, 32, 128),
     (512, 32), dict(causal=True), 0.1126, ("sdpa", 1.2)),
    ("zamba2 train causal (4,512,32,64)", (4, 512, 32, 64), (512, 32),
     dict(causal=True), 0.0848, ("sdpa", 1.2)),
    ("qwen2-vl prefill causal (4,1088,28,128) over (1088,4)",
     (4, 1088, 28, 128), (1088, 4), dict(causal=True), 0.2674,
     ("sdpa", 1.2)),
    ("whisper encoder (4,1500,12,64)", (4, 1500, 12, 64), (1500, 12),
     dict(causal=False), 0.2215, ("sdpa", 1.2)),
    ("whisper cross train (4,448,12,64) over 1500", (4, 448, 12, 64),
     (1500, 12), dict(causal=False), 0.0971, ("sdpa", 1.2)),
    ("deepseek-7b prefill causal (1,256,32,128)", (1, 256, 32, 128),
     (256, 32), dict(causal=True), 0.0252, ("ms", 0.018)),
    ("window 512 (1,2048,32,128)", (1, 2048, 32, 128), (2048, 32),
     dict(causal=True, window=512), 0.1407, ("ms", 0.08)),
)


def attn_sdpa(torch, q, k, v, kw):
    """SDPA on (B, H, S, D) views of the same inputs, the KV heads
    repeated over their GQA groups, with a boolean mask for a window or a
    q_offset (SDPA's own causal mask aligns query 0 with key 0): the
    library call beside the kernel (timed only)."""
    from repro_torch.kernels import mma_attention as A
    group = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (
        q, A.repeat_kv(k, group), A.repeat_kv(v, group)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if "window" not in kw and not kw.get("q_offset"):
        return lambda: sdpa(qt, kt, vt, is_causal=kw["causal"])
    sq, sk = q.shape[1], k.shape[1]
    qp = torch.arange(sq, device="cuda")[:, None] + kw.get("q_offset", 0)
    kp = torch.arange(sk, device="cuda")[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device="cuda")
    if "window" in kw:
        mask &= qp - kp < kw["window"]
    if kw["causal"]:
        mask &= qp >= kp
    return lambda: sdpa(qt, kt, vt, attn_mask=mask)


def attn_bound(q, k, kw) -> tuple[float, str]:
    """The least time for one call: q, k, v read and O written once, 4 D
    flops a live (q, k) pair a head, at the peaks of q's dtype."""
    from repro_torch.kernels import mma_attention as A
    b, sq, h, d = q.shape
    pairs = A.attn_live_pairs(sq, k.shape[1], **{
        f: kw[f] for f in ("causal", "q_offset", "window") if f in kw})
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return bound_ms(nbytes, 4 * d * pairs * b * h,
                    "f32" if q.element_size() == 4 else "bf16")


def phase13_kernels(torch, timer, failures):
    """The redesigned 16-bit attention tile: each ATTN_TARGETS shape
    through ``facility.contract`` (the model path's call), counts zeroed
    just before and read just after (every launch the tile mode's); each
    result against its plain version within its rounding budget; then
    each timed (CUDA events, L2 flushed) beside SDPA, the bound and the
    parent kernel's PERF.md time, with its target met or missed (a miss
    is reported, not failed).  Returns the ``kernels`` entry."""
    from repro_torch.core import facility
    from repro_torch.kernels import mma_attention as A

    g = torch.Generator(device="cuda").manual_seed(26)
    ops = []
    for label, (b, sq, h, d), (sk, kvh), kw, parent, target in ATTN_TARGETS:
        q = torch.randn(b, sq, h, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(b, sk, kvh, d, generator=g, device="cuda"
                            ).bfloat16() for _ in range(2))
        ops.append((label, q, k, v, kw, parent, target))

    kernels = kernel_wrappers()
    outs = {}
    torch.cuda.synchronize()
    zero_counts(kernels)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for label, q, k, v, kw, _, _ in ops:
            outs[label] = facility.contract(facility.ATTN, q, k, v,
                                            plan=facility.Plan(**kw))
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    tile = counts["attn_by_mode"]["tile"]
    _check(failures, "phase 13 main path",
           counts["launches"]["mma_flash_attention"] == len(ops) == tile,
           f"attention launches {counts['launches']['mma_flash_attention']}"
           f", tile mode {tile} ({len(ops)} calls)")

    rows, worst, met = {}, 0.0, {}
    for label, q, k, v, kw, parent, (kind, goal) in ops:
        budget = A.rounding_budget(q, k, v, **kw)
        want = A.flash_attention_plain(q, k, v, **kw)
        worst = max(worst, _report_attn(
            torch, f"attn tile {label} vs plain", outs[label], want, v,
            budget, torch.bfloat16, failures))
        row = {"ms": timer(lambda q=q, k=k, v=v, kw=kw:
                           A.mma_flash_attention(q, k, v, **kw)),
               "plain_ms": timer(lambda q=q, k=k, v=v, kw=kw:
                                 A.flash_attention_plain(q, k, v, **kw),
                                 iters=3, warmup=1),
               "library_ms": timer(attn_sdpa(torch, q, k, v, kw)),
               "library": "SDPA"}
        row["bound_ms"], row["bound_by"] = attn_bound(q, k, kw)
        limit = goal if kind == "ms" else goal * row["library_ms"]
        met[label] = row["ms"] <= limit
        print(f"  time attn tile {label}: {row['ms']:.4f} ms (parent in "
              f"PERF.md: {parent} ms), plain {row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.2f} of "
              f"bound; target {'met' if met[label] else 'MISSED'} "
              f"(<= {limit:.4f} ms)")
        rows[label] = row
    del ops, outs
    label = ATTN_TARGETS[0][0]
    entry = {"name": "mma_flash_attention 16-bit tile (persistent)",
             "route": "cuda",
             "source": "src/repro_torch/csrc/mma_attention.cu",
             "replaces": "src/repro/kernels/mma_attention.py:193",
             "launches": tile, "max_abs_err": worst, **rows[label],
             "shape": label, "timed": rows, "targets_met": met}
    if entry["launches"] <= 0:
        failures.append(f"{entry['name']} never launched in phase 13's run")
    return [entry]


def phase13(torch, failures, entries):
    """Phase 13: K2's redesigned 16-bit tile mode at the main path's
    prefill and train shapes, checked and timed; the parent kernel's
    PERF.md time is printed beside each."""
    print("== phase 13: K2's 16-bit tile (persistent, ping-ponged wgmma)",
          flush=True)
    t0 = time.perf_counter()
    timer = Timer(torch)
    entries += phase13_kernels(torch, timer, failures)
    del timer
    torch.cuda.empty_cache()
    print(f"  phase 13: {time.perf_counter() - t0:.1f} s")


# Phase 14: F64GER's DMMA kernel (gemm_dmma.cu: 128 x 128 or 64 x 64 fp64
# tensor-core tiles on an mbarrier cp.async ring) at the paper's DGEMM and
# the DMMA forms.  (label, entry point, (B, M, K, N), forms, the parent
# kernel's time in PERF.md section 6 (NVIDIA H100 80GB HBM3 at 700 W:
# printed for the reader, never put in the kernels line; None: not there),
# the aim: ("ms", t), ("natural", a factor of this run's natural DGEMM at
# the shape) or None).  "gemm" runs contract("mk,kn->mn"); "dft" blas3's
# batched dft on (B, K, N) stacks (one product of M = K rows by B N
# columns, four launches); "complex" blas3.complex_gemm (four launches).
DMMA_TARGETS = (
    ("DGEMM 2048^3", "gemm", (None, 2048, 2048, 2048), (), 0.6251,
     ("ms", 0.375)),
    ("DGEMM 2048^3 X+Y packed", "gemm", (None, 2048, 2048, 2048),
     ("x", "y"), 0.6965, ("natural", 1.05)),
    ("DGEMM 2048^3 masked, NaN/Inf in disabled lanes", "gemm",
     (None, 2048, 2048, 2048), ("mask",), 0.8090, ("ms", 0.48)),
    ("DGEMM 2048^3 sidecar", "gemm", (None, 2048, 2048, 2048),
     ("sidecar",), 0.6576, ("natural", 1.10)),
    ("DGEMM 8192^3", "gemm", (None, 8192, 8192, 8192), (), 39.5792,
     ("ms", 28.8)),
    ("dft f64 64 x (1024 x 1024 x 128)", "dft", (64, 1024, 1024, 128), (),
     None, None),
    ("complex_gemm c128 4096", "complex", (None, 4096, 4096, 4096), (),
     None, None),
    ("skinny 4 x 4096 x 11008", "gemm", (None, 4, 4096, 11008), (), None,
     None),
    ("ragged 1000 x 999 x 1001", "gemm", (None, 1000, 999, 1001), (), None,
     None),
)


def phase14_kernels(torch, timer, failures):
    """The redesigned DMMA kernel: each DMMA_TARGETS call through
    ``facility.contract`` (the sidecar's under ABFT, the dft and
    complex_gemm through their entry points), counts zeroed just before
    and read just after (every launch DMMA's, one packed, one masked, one
    with the sidecar); each GEMM within 1e-15 K max|x| max|y| of its
    plain version (the masked one on the selected operands), the same bits
    on both compiled tiles, packed bit for bit natural, the sidecar's
    ``out`` bit for bit ``checksum=False``'s and its sums within 1e-13 of
    the sums of |out| of the plain version's; the dft and complex_gemm
    against float64 ``torch.fft.fft`` / complex128 ``torch.matmul``
    (relative L2 < 1e-12); then each timed (CUDA events, L2 flushed)
    beside its plain version, ``torch.matmul`` f64 (``torch.where`` +
    ``torch.matmul`` masked, ``torch.fft.fft`` for the dft), the bound and
    the parent kernel's PERF.md time, its aim met or missed (reported,
    not failed).  Returns the ``kernels`` entry."""
    from repro_torch.core import abft, facility, packing, tiling
    from repro_torch.kernels import blas3 as B3
    from repro_torch.kernels import mma_gemm as G

    Ger = facility.Ger
    F64 = Ger.F64GER
    g = torch.Generator(device="cuda").manual_seed(27)
    plan = facility.Plan(ger=F64, out_dtype=facility.ACC)
    cuda = facility.FacilityConfig(device="cuda")
    ops = []
    for label, call, (b, m, k, n), forms, parent, aim in DMMA_TARGETS:
        def rn(*shape):
            return torch.randn(*shape, generator=g, device="cuda",
                               dtype=torch.float64)
        if call == "dft":
            args = (rn(b, k, n),)
        elif call == "complex":
            args = tuple(rn(m, k) if i < 2 else rn(k, n) for i in range(4))
        else:
            x, y = rn(m, k), rn(k, n) * k ** -0.5
            masks = None
            if "mask" in forms:
                masks = _lane_masks(torch, g, m, n, k)
                x[~masks[0], :] = float("nan")
                x[:, ~masks[2]] = float("-inf")
                y[~masks[2], :] = float("inf")
                y[:, ~masks[1]] = float("nan")
            px = (packing.pack_gemm(x, packing.gemm_layout(F64, m, k,
                                                           side="x"))
                  if "x" in forms else x)
            py = (packing.pack_gemm(y, packing.gemm_layout(F64, k, n))
                  if "y" in forms else y)
            args = (x, y, px, py, masks)
        ops.append((label, call, (b, m, k, n), forms, parent, aim, args))

    def run(call, forms, args):
        if call == "dft":
            return B3.dft(args[0])
        if call == "complex":
            return B3.complex_gemm(*args, kind=F64)
        _, _, px, py, masks = args
        return facility.contract("mk,kn->mn", px, py, masks=masks,
                                 plan=plan)

    # the main path: every target through contract, counts zeroed just
    # before and read just after
    kernels = kernel_wrappers()
    outs = {}
    torch.cuda.synchronize()
    zero_counts9(kernels)
    for label, call, _, forms, _, _, args in ops:
        config = (facility.FacilityConfig(device="cuda", guards=True,
                                          abft=True)
                  if "sidecar" in forms else cuda)
        with facility.configure(config):
            outs[label] = run(call, forms, args)
    torch.cuda.synchronize()
    counts = read_counts9(kernels)
    verdicts = abft.drain_verdicts()
    want = sum(4 if call in ("dft", "complex") else 1
               for _, call, *_ in ops)
    dmma = counts["by_path"]["mma_gemm"]["dmma"]
    _check(failures, "phase 14 main path",
           counts["launches"]["mma_gemm"] == dmma == want
           and counts["packed"]["gemm dmma"] == 1
           and counts["masked"]["dmma"] == 1
           and counts["sidecar"]["dmma"] == 1 and verdicts == [],
           f"GEMM launches {counts['launches']['mma_gemm']}, by path "
           f"{counts['by_path']['mma_gemm']} (want {want} on dmma), packed "
           f"{counts['packed']['gemm dmma']}, masked "
           f"{counts['masked']['dmma']}, sidecar {counts['sidecar']['dmma']}"
           f" (1 each), {len(verdicts)} ABFT verdicts (0)")

    rows, worst, met, natural_ms = {}, 0.0, {}, {}
    tiles = [tuple(t) for t in tiling.GEMM_TILES[F64]]
    for label, call, (b, m, k, n), forms, parent, aim, args in ops:
        row = {}
        if call == "gemm":
            x, y, px, py, masks = args
            tile = tiling.choose_gemm_path(m, n, k, F64, 1, True, None,
                                           masks is not None)[1]
            row["tile"] = [tile.bm, tile.bn, tile.bk]
            out = outs[label]
            plain = (lambda x=x, y=y, masks=masks: G.mma_gemm_plain(
                x, y, kind=F64, masks=masks))
            xs, ys = G.select_masks(x, y, masks)
            want_out = plain()
            bound = 1e-15 * k * xs.abs().max().item() * ys.abs().max().item()
            err = (out - want_out).abs().max().item()
            worst = max(worst, err)
            _check(failures, f"dmma {label}", err <= bound and bool(
                torch.isfinite(out).all()),
                f"max|err| {err:.3e} vs plain (tol {bound:.3e}) on the "
                f"{tile.bm} x {tile.bn} tile")
            same = all(torch.equal(G.mma_gemm(x, y, kind=F64, masks=masks,
                                              block=t), out)
                       for t in tiles)
            _check(failures, f"dmma {label}", same,
                   "both tiles bit for bit the contract's result")
            if px is not x or py is not y:
                lay = {}
                xk, yk = px, py
                if px is not x:
                    xk, lay["x_layout"] = px.data, px.layout
                if py is not y:
                    yk, lay["y_layout"] = py.data, py.layout
                nat = G.mma_gemm(x, y, kind=F64)
                _check(failures, f"dmma {label}", torch.equal(out, nat),
                       "packed bit for bit the natural launch")
                fn = (lambda xk=xk, yk=yk, lay=lay: G.mma_gemm(
                    xk, yk, kind=F64, **lay))
            elif "sidecar" in forms:
                got, ck_col, ck_row = G.mma_gemm(x, y, kind=F64,
                                                 checksum=True)
                fin, want_col, want_row = G.mma_gemm_sidecar_plain(
                    x, y, kind=F64)
                mag_col, mag_row = G.checksum_tiles(fin.abs(), tile.bm,
                                                    tile.bn)
                ok = (torch.equal(got, G.mma_gemm(x, y, kind=F64))
                      and torch.equal(got, out)
                      and bool(((ck_col - want_col).abs()
                                <= 1e-13 * mag_col).all())
                      and bool(((ck_row - want_row).abs()
                                <= 1e-13 * mag_row).all()))
                _check(failures, f"dmma {label}", ok,
                       "out bit for bit checksum=False's and the contract's"
                       ", sums within 1e-13 of the plain version's")
                fn = (lambda x=x, y=y: G.mma_gemm(x, y, kind=F64,
                                                  checksum=True))
            else:
                fn = (lambda x=x, y=y, masks=masks: G.mma_gemm(
                    x, y, kind=F64, masks=masks))
            lib = ((lambda xs=xs, ys=ys: torch.matmul(xs, ys))
                   if masks is None else
                   (lambda x=x, y=y, masks=masks: torch.matmul(
                       *G.select_masks(x, y, masks))))
            row["library"] = ("torch.where + torch.matmul f64"
                              if masks is not None else "torch.matmul f64")
            me, ne, ke = ((int(t.sum()) for t in masks)
                          if masks is not None else (m, n, k))
            nbytes, flops = (me * ke + ke * ne + m * n) * 8, 2 * me * ne * ke
        else:
            if call == "dft":
                (xd,) = args
                re, im = outs[label]
                ref64 = torch.fft.fft(xd, dim=-2)
                rel = _rel(torch.complex(re, im), ref64)
                fn = (lambda xd=xd: _with(facility, cuda, B3.dft, xd))
                plain = (lambda xd=xd: _with(facility, cuda, B3.dft, xd,
                                             backend="torch"))
                err = (torch.complex(re, im) - ref64).abs().max().item()
                xc = xd.to(torch.complex128)
                lib = (lambda xc=xc: torch.fft.fft(xc, dim=-2))
                row["library"] = "torch.fft.fft c128 (not the same algorithm)"
                # a real input: two of the four real products multiply
                # zeros, so the work is two products of 2 m k (b n) flops
                nbytes = (2 * m * k + 3 * b * k * n) * 8
                flops = 4 * m * k * b * n
            else:
                ar, ai, br, bi = args
                re, im = outs[label]
                ca, cb = torch.complex(ar, ai), torch.complex(br, bi)
                ref = torch.matmul(ca, cb)
                rel = _rel(torch.complex(re, im), ref)
                err = (torch.complex(re, im) - ref).abs().max().item()
                del ref
                fn = (lambda a=args: _with(facility, cuda, B3.complex_gemm,
                                           *a, kind=F64))
                plain = (lambda a=args: _with(
                    facility, cuda, B3.complex_gemm, *a, kind=F64,
                    backend="torch"))
                lib = (lambda ca=ca, cb=cb: torch.matmul(ca, cb))
                row["library"] = "torch.matmul c128"
                nbytes, flops = 6 * m * k * 8, 8 * m * n * k
            _check(failures, f"dmma {label}", rel < 1e-12,
                   f"relative L2 to the float64 library result {rel:.3e} "
                   f"(< 1e-12)")
            worst = max(worst, err)
        iters = 5 if k >= 4096 and m >= 4096 else 10
        row["ms"] = timer(fn, iters=iters)
        row["plain_ms"] = timer(plain, iters=iters)
        row["library_ms"] = timer(lib, iters=iters)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, "f64")
        if call == "gemm" and not forms:
            natural_ms[(m, k, n)] = row["ms"]
        text = ""
        if aim is not None:
            kind, goal = aim
            limit = (goal if kind == "ms"
                     else goal * natural_ms[(m, k, n)])
            met[label] = row["ms"] <= limit
            text = (f"; aim {'met' if met[label] else 'MISSED'} (<= "
                    f"{limit:.4f} ms)")
        where = (f" on the {row['tile'][0]} x {row['tile'][1]} tile"
                 if "tile" in row else "")
        print(f"  time dmma {label}: {row['ms']:.4f} ms{where} (parent in "
              f"PERF.md: "
              f"{'not measured' if parent is None else f'{parent} ms'}), "
              f"plain {row['plain_ms']:.4f} ms, {row['library']} "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.2f} of "
              f"bound{text}", flush=True)
        rows[label] = row
    del ops, outs
    label = DMMA_TARGETS[0][0]
    entry = {"name": "mma_gemm.dmma",
             "route": "cuda", "source": "src/repro_torch/csrc/gemm_dmma.cu",
             "replaces": "src/repro/kernels/mma_gemm.py:417",
             "launches": dmma, "max_abs_err": worst, **rows[label],
             "shape": label, "timed": rows, "aims_met": met}
    if entry["launches"] <= 0:
        failures.append(f"{entry['name']} never launched in phase 14's run")
    return [entry]


def _with(facility, config, fn, *args, **kw):
    """fn(*args, **kw) under ``facility.configure(config)``."""
    with facility.configure(config):
        return fn(*args, **kw)


def phase14(torch, failures, entries):
    """Phase 14: F64GER's redesigned DMMA kernel at DMMA_TARGETS, checked
    and timed; the parent kernel's PERF.md time is printed beside each."""
    print("== phase 14: F64GER's DMMA kernel (128 x 128 / 64 x 64 fp64 "
          "tensor-core tiles, mbarrier cp.async ring)", flush=True)
    t0 = time.perf_counter()
    timer = Timer(torch)
    entries += phase14_kernels(torch, timer, failures)
    del timer
    torch.cuda.empty_cache()
    print(f"  phase 14: {time.perf_counter() - t0:.1f} s")


# Phase 15: K1's wgmma tile (gemm_wgmma.cu, wgmma_tile.cuh) on the plan
# that fills the card at prefill, and K3's fp32 conv on the two-stage fp32
# SIMT tile.  (label, (B, M, K, N), forms, the parent kernel's time
# (PERF.md section 6: the mean of the parent's two runs in X17,
# scripts/gemm_path_times.py's A B B A with bf16 out, NVIDIA H100 80GB
# HBM3 at 700 W: printed for the reader, never put in the kernels line),
# the aim: ("ms", t), ("library", f): at most f times torch.matmul in this
# run, or None).  Forms: "x" / "y" X / Y as
# core/packing.py's panels (prepacked serving), "checksum" the ABFT
# sidecar, "f16" F16GER2.
WGMMA_TARGETS = (
    ("deepseek-7b prefill q/k/v/o 256x4096x4096", (None, 256, 4096, 4096),
     (), 0.0337, ("library", 1.0)),
    ("deepseek-7b prefill gate/up 256x4096x11008",
     (None, 256, 4096, 11008), (), 0.0668, ("library", 1.0)),
    ("deepseek-7b prefill down 256x11008x4096", (None, 256, 11008, 4096),
     (), 0.0713, ("library", 1.0)),
    ("prefill 1024x4096x11008", (None, 1024, 4096, 11008), (), 0.1777,
     ("ms", 0.1431)),
    ("prefill 1024x4096x11008 packed X", (None, 1024, 4096, 11008),
     ("x",), 0.1902, ("ms", 0.1400)),
    ("whisper encoder 6000x768x768", (None, 6000, 768, 768), (), 0.0290,
     ("ms", 0.0290)),
    ("whisper encoder 6000x768x3072", (None, 6000, 768, 3072), (), 0.0720,
     ("ms", 0.0720)),
    ("deepseek-7b train forward 2048x4096x4096", (None, 2048, 4096, 4096),
     (), 0.1205, ("ms", 0.1205)),
    ("deepseek-7b train dW 4096x2048x4096", (None, 4096, 2048, 4096), (),
     0.1139, ("ms", 0.1139)),
    ("prefill 1024x4096x11008 sidecar", (None, 1024, 4096, 11008),
     ("checksum",), 0.2130, None),
    ("f16 prefill 256x4096x11008", (None, 256, 4096, 11008), ("f16",),
     0.0680, ("library", 1.0)),
    ("deepseek-7b prefill q/k/v/o 256x4096x4096 packed Y",
     (None, 256, 4096, 4096), ("y",), 0.0339, None),
    ("deepseek-7b prefill down 256x11008x4096 packed Y",
     (None, 256, 11008, 4096), ("y",), 0.0716, None),
)
# K3 at the path choose_conv_path picks: (label, image NHWC, filters HWIO,
# stride, dtype, packed filters, parent ms as above (the bf16 targets':
# ac76357's, the mean of its two runs in run Q7), aim: ("ms", t),
# ("library", f) times cuDNN in this run, ("parent", f) times the parent
# ms); bias + gelu, out in the input dtype.
CONV_F32_TARGETS = (
    ("f32 whisper conv2 4x3001x768 k3 s2", (4, 1, 3001, 768),
     (1, 3, 768, 768), (1, 2), "float32", False, 1.3266, ("ms", 0.75)),
    ("f32 whisper conv2 4x3001x768 k3 s2 packed", (4, 1, 3001, 768),
     (1, 3, 768, 768), (1, 2), "float32", True, 1.1046, ("ms", 0.75)),
    ("f32 qwen2-vl patch 4x448x448x3 k14 s14", (4, 448, 448, 3),
     (14, 14, 3, 3584), (14, 14), "float32", False, 0.9695,
     ("ms", 0.9775)),
    ("f32 qwen2-vl patch 4x448x448x3 k14 s14 packed", (4, 448, 448, 3),
     (14, 14, 3, 3584), (14, 14), "float32", True, 0.8325, ("ms", 0.8542)),
    ("f32 whisper conv1 4x3002x80 k3", (4, 1, 3002, 80), (1, 3, 80, 768),
     (1, 1), "float32", False, 0.2772, None),
    ("bf16 whisper conv2 4x3001x768 k3 s2 (wgmma)", (4, 1, 3001, 768),
     (1, 3, 768, 768), (1, 2), "bfloat16", False, 0.0729,
     ("library", 1.0)),
    ("bf16 whisper conv2 4x3001x768 k3 s2 packed (wgmma)",
     (4, 1, 3001, 768), (1, 3, 768, 768), (1, 2), "bfloat16", True, 0.0737,
     ("parent", 1.02)),
    ("bf16 whisper conv1 4x3002x80 k3 (wgmma)", (4, 1, 3002, 80),
     (1, 3, 80, 768), (1, 1), "bfloat16", False, 0.0655, ("parent", 1.02)),
    ("bf16 qwen2-vl patch 4x448x448x3 k14 s14 (wgmma)", (4, 448, 448, 3),
     (14, 14, 3, 3584), (14, 14), "bfloat16", False, 0.1901,
     ("parent", 1.02)),
)


# The output hashes of WGMMA_TARGETS and CONV_F32_TARGETS at the parent
# (cc186cf; the three bf16 conv targets after conv2's at ac76357, which
# gives every earlier target the same hash), from scripts/gemm_path_times.py (the first 16 hex digits of
# a SHA-256 of the output's bytes; the sidecar's of its ``out`` alone):
# every launch keeps them (the k order and the epilogue's arithmetic do
# not depend on the tile).  WGMMA_TARGETS' hashes are of bf16 outputs.
PHASE15_PARENT_SHA = {
    "deepseek-7b prefill q/k/v/o 256x4096x4096": "9679284878210c15",
    "deepseek-7b prefill gate/up 256x4096x11008": "a27e6df382b234c0",
    "deepseek-7b prefill down 256x11008x4096": "c9921281e4e9dab6",
    "prefill 1024x4096x11008": "5acfc27dffc8d05d",
    "prefill 1024x4096x11008 packed X": "73b53fd4ba0bbae5",
    "whisper encoder 6000x768x768": "b3a36e0c0591e7eb",
    "whisper encoder 6000x768x3072": "1b3e1210dae576ab",
    "deepseek-7b train forward 2048x4096x4096": "665aa01b9701df5c",
    "deepseek-7b train dW 4096x2048x4096": "1e355e4ce932f00d",
    "prefill 1024x4096x11008 sidecar": "75490e309726f4a8",
    "f16 prefill 256x4096x11008": "6c98d7084b0f3210",
    "deepseek-7b prefill q/k/v/o 256x4096x4096 packed Y": "66e26cb14b8428d8",
    "deepseek-7b prefill down 256x11008x4096 packed Y": "4040faad5acd74bd",
    "f32 whisper conv2 4x3001x768 k3 s2": "c90e5afdc292e902",
    "f32 whisper conv2 4x3001x768 k3 s2 packed": "d31ba7a0214a32cd",
    "f32 qwen2-vl patch 4x448x448x3 k14 s14": "ca26505d29df56c6",
    "f32 qwen2-vl patch 4x448x448x3 k14 s14 packed": "872c250a66136dfd",
    "f32 whisper conv1 4x3002x80 k3": "83d8a58aae33ea91",
    "bf16 whisper conv2 4x3001x768 k3 s2 (wgmma)": "ea70b7939e570df0",
    "bf16 whisper conv2 4x3001x768 k3 s2 packed (wgmma)": "1251b6b01514cb38",
    "bf16 whisper conv1 4x3002x80 k3 (wgmma)": "9e89038f2518026d",
    "bf16 qwen2-vl patch 4x448x448x3 k14 s14 (wgmma)": "0490752b576df30e",
}


def sha16(torch, *ts) -> str:
    """The first 16 hex digits of a SHA-256 of the tensors' bytes."""
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def wgmma_target_operands(torch, i):
    """WGMMA_TARGETS[i]'s operands from seed 301 + i: (x, y, the X the
    kernel reads (its panels with "x"), mma_gemm's keywords, the Y the
    kernel reads (its panels with "y"))."""
    from repro_torch.core import packing, precision
    _, (b, m, k, n), forms, _, _ = WGMMA_TARGETS[i]
    g = torch.Generator(device="cuda").manual_seed(301 + i)
    kind = (precision.Ger.F16GER2 if "f16" in forms
            else precision.Ger.BF16GER2)
    dt = precision.policy(kind).x_dtype
    lead = () if b is None else (b,)
    x = torch.randn(*lead, m, k, generator=g, device="cuda").to(dt)
    y = (torch.randn(*lead, k, n, generator=g, device="cuda")
         * k ** -0.5).to(dt)
    # bf16 out: FacilityConfig's default, as prefill and training store
    kw = dict(kind=kind, checksum="checksum" in forms,
              out_dtype=torch.bfloat16)
    xk = x
    if "x" in forms:
        po = packing.pack_gemm(x, packing.gemm_layout(
            kind, m, k, side="x", batched=b is not None))
        xk, kw["x_layout"] = po.data, po.layout
    if "y" in forms:
        po = packing.pack_gemm(y, packing.gemm_layout(
            kind, k, n, batched=b is not None))
        kw["y_layout"] = po.layout
        return x, y, xk, kw, po.data
    return x, y, xk, kw, y


def conv_target_operands(torch, i):
    """CONV_F32_TARGETS[i]'s operands from seed 401 + i: (image, filters,
    the filters the kernel reads (the packed stream where the target is
    packed), bias, mma_conv2d's keywords: bias + gelu, out in the input
    dtype)."""
    from repro_torch.core import packing, precision
    from repro_torch.kernels import epilogue as E
    _, ishape, wshape, stride, dtype, packed, _, _ = CONV_F32_TARGETS[i]
    g = torch.Generator(device="cuda").manual_seed(401 + i)
    dt = getattr(torch, dtype)
    x = torch.randn(*ishape, generator=g, device="cuda").to(dt)
    kh, kw_, c, f = wshape
    w = (torch.randn(*wshape, generator=g, device="cuda")
         * (kh * kw_ * c) ** -0.5).to(dt)
    bias = torch.randn(f, generator=g, device="cuda")
    ckw = dict(stride=stride, out_dtype=dt, bias=bias,
               ep=E.Epilogue(bias=True, activation="gelu"))
    wk = w
    if packed:
        kind = (precision.Ger.F32GER if dt == torch.float32
                else precision.Ger.BF16GER2)
        pc = packing.pack_conv(w, packing.conv_layout(kind, kh, kw_, c, f))
        wk, ckw["w_layout"] = pc.data, pc.layout
    return x, w, wk, ckw


def phase15_kernels(torch, timer, failures):
    """K1's wgmma tile on its prefill plan and K3's fp32 conv on the fp32
    SIMT tile:
    every WGMMA_TARGETS and CONV_F32_TARGETS call through the kernel
    wrappers, counts zeroed just before and read just after (each GEMM on
    the wgmma path, each f32 conv on the fp32 tile, the bf16 conv on K3's
    wgmma kernel); each within its tolerance of its plain version, the
    same bits on a second launch and the parent's output hash; then each
    timed (CUDA events, L2 flushed) beside its plain version, the library
    call (``torch.matmul``; cuDNN conv2d, channels-last, TF32 off), the
    bound and the parent kernel's PERF.md time, its aim met or missed
    (reported, not failed).  Returns the ``kernels`` entries."""
    from repro_torch.core import tiling
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G

    gemms = [wgmma_target_operands(torch, i)
             for i in range(len(WGMMA_TARGETS))]
    convs = [conv_target_operands(torch, i)
             for i in range(len(CONV_F32_TARGETS))]
    kernels = kernel_wrappers()
    torch.cuda.synchronize()
    zero_counts9(kernels)
    outs = [G.mma_gemm(xk, yk, **kw) for _, _, xk, kw, yk in gemms]
    couts = [K.mma_conv2d(x, wk, **ckw) for x, _, wk, ckw in convs]
    torch.cuda.synchronize()
    counts = read_counts9(kernels)
    f32_want = sum(t[4] == "float32" for t in CONV_F32_TARGETS)
    by_gemm, by_conv = (counts["by_path"]["mma_gemm"],
                        counts["by_path"]["mma_conv2d"])
    _check(failures, "phase 15 main path",
           counts["launches"]["mma_gemm"] == by_gemm["wgmma"]
           == len(gemms)
           and counts["launches"]["mma_conv2d"] == len(convs)
           and by_conv["f32"] == f32_want
           and by_conv["wgmma"] == len(convs) - f32_want,
           f"GEMM launches {counts['launches']['mma_gemm']}, by path "
           f"{by_gemm} (want {len(gemms)} on wgmma); conv launches by path "
           f"{by_conv} (want {f32_want} f32, {len(convs) - f32_want} "
           f"wgmma)")

    def hash_check(label, sha):
        parent = PHASE15_PARENT_SHA[label]
        same = sha == parent
        _check(failures, f"phase 15 {label}", same,
               f"output sha256 {sha} against the parent's {parent}")
        return same

    rows, worst, met = {}, 0.0, {}
    for (label, (b, m, k, n), forms, parent, aim), (x, y, xk, kw, yk), \
            got in zip(WGMMA_TARGETS, gemms, outs):
        out = got[0] if kw["checksum"] else got
        want = G.mma_gemm_plain(x, y, kind=kw["kind"])
        worst = max(worst, _report_close(
            torch, f"wgmma {label} vs plain", out, want, out.dtype,
            failures))
        again = G.mma_gemm(xk, yk, **kw)
        again = again[0] if kw["checksum"] else again
        _check(failures, f"phase 15 {label}", torch.equal(again, out),
               "two launches the same bits")
        if kw["checksum"] or xk is not x or yk is not y:
            _check(failures, f"phase 15 {label}", torch.equal(
                out, G.mma_gemm(x, y, kind=kw["kind"],
                                out_dtype=kw["out_dtype"])),
                "out bit for bit the natural launch without the sidecar")
        cfg = tiling.choose_gemm_path(m, n, k, kw["kind"], b or 1)[1]
        sha = sha16(torch, out)
        same = hash_check(label, sha)
        row = {"ms": timer(lambda xk=xk, yk=yk, kw=kw: G.mma_gemm(
                   xk, yk, **kw)),
               "plain_ms": timer(lambda x=x, y=y, kind=kw["kind"]:
                                 G.mma_gemm_plain(x, y, kind=kind), iters=3,
                                 warmup=1),
               "library_ms": timer(lambda x=x, y=y: torch.matmul(x, y)),
               "library": "torch.matmul",
               "tile": [cfg.bm, cfg.bn],
               "sha256": sha, "parent_sha": same}
        bb = (b or 1)
        row["bound_ms"], row["bound_by"] = bound_ms(
            (m * k + k * n + m * n) * 2 * bb, 2 * m * n * k * bb, "bf16")
        met[label], text = aim_text(aim, row["ms"], row["library_ms"],
                                    parent)
        print(f"  time wgmma {label}: {row['ms']:.4f} ms on the 128 x "
              f"{cfg.bn} tile (parent in PERF.md: "
              f"{'not measured' if parent is None else f'{parent} ms'}), "
              f"plain {row['plain_ms']:.4f} ms, torch.matmul "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.2f} of "
              f"bound{text}", flush=True)
        rows[label] = row
    crows, cworst, cmet = {}, 0.0, {}
    for (label, ishape, wshape, stride, dtype, packed, parent, aim), \
            (x, w, wk, ckw), got in zip(CONV_F32_TARGETS, convs, couts):
        pkw = {key: v for key, v in ckw.items() if key != "w_layout"}
        want = K.mma_conv2d_plain(x, w, **pkw)
        cworst = max(cworst, _report_close(
            torch, f"conv {label} vs plain", got.float(), want.float(),
            got.dtype, failures))
        _check(failures, f"phase 15 {label}", torch.equal(
            K.mma_conv2d(x, wk, **ckw), got), "two launches the same bits")
        sha = sha16(torch, got)
        same = hash_check(label, sha)
        n_, h, w_, c = ishape
        kh, kw_, _, f = wshape
        mm = n_ * ((h - kh) // stride[0] + 1) * ((w_ - kw_) // stride[1]
                                                 + 1)
        path, cfg = K.conv_path(x, kh, kw_, c, f, stride, None, True)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = ckw["bias"].to(x.dtype)
        row = {"ms": timer(lambda x=x, wk=wk, ckw=ckw: K.mma_conv2d(
                   x, wk, **ckw), iters=5),
               "plain_ms": timer(lambda x=x, w=w, pkw=pkw:
                                 K.mma_conv2d_plain(x, w, **pkw), iters=3,
                                 warmup=1),
               "library_ms": timer(lambda: torch.nn.functional.conv2d(
                   xc, wc, bc, stride=stride), iters=5),
               "library": "cuDNN conv2d (channels-last, TF32 off)",
               "path": path, "tile": [cfg.bm, cfg.bn], "sha256": sha,
               "parent_sha": same}
        esz = x.element_size()
        row["bound_ms"], row["bound_by"] = bound_ms(
            (x.numel() + w.numel() + mm * f) * esz + f * 4,
            2 * mm * kh * kw_ * c * f,
            "f32" if dtype == "float32" else "bf16")
        cmet[label], text = aim_text(aim, row["ms"], row["library_ms"],
                                     parent)
        print(f"  time conv {label}: {row['ms']:.4f} ms on {path} "
              f"{cfg.bm} x {cfg.bn} (parent in PERF.md: "
              f"{'not measured' if parent is None else f'{parent} ms'}), "
              f"plain {row['plain_ms']:.4f} ms, cuDNN "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.2f} of "
              f"bound{text}", flush=True)
        crows[label] = row
        del xc, wc
    del gemms, convs, outs, couts
    glabel, clabel = WGMMA_TARGETS[0][0], CONV_F32_TARGETS[0][0]
    entries = [
        {"name": "mma_gemm wgmma tile (prefill plan)", "route": "cuda",
         "source": "src/repro_torch/csrc/gemm_wgmma.cu",
         "replaces": "src/repro/kernels/mma_gemm.py:417",
         "launches": by_gemm["wgmma"], "max_abs_err": worst,
         **rows[glabel], "shape": glabel, "timed": rows, "aims_met": met},
        {"name": "mma_conv2d fp32 SIMT tile", "route": "cuda",
         "source": "src/repro_torch/csrc/mma_conv.cu",
         "replaces": "src/repro/kernels/mma_conv.py:191",
         "launches": by_conv["f32"], "max_abs_err": cworst,
         **crows[clabel], "shape": clabel, "timed": crows,
         "aims_met": cmet}]
    for e in entries:
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched in phase 15's run")
    return entries


def phase15(torch, failures, entries):
    """Phase 15: K1's wgmma tile on its prefill plan and K3's fp32 conv on
    the fp32 SIMT tile at the main path's shapes, checked, hashed against
    the parent and timed."""
    print("== phase 15: K1's wgmma tile on its prefill plan and K3's fp32 "
          "conv on the fp32 SIMT tile", flush=True)
    t0 = time.perf_counter()
    timer = Timer(torch)
    entries += phase15_kernels(torch, timer, failures)
    del timer
    torch.cuda.empty_cache()
    print(f"  phase 15: {time.perf_counter() - t0:.1f} s")


# Phase 16: the 16-bit weight stream (gemm_stream.cu's TMA kernel; the
# cp.async kernel where TMA cannot read a row) at the main path's decode
# shapes.  (label, (B, M, K, N), forms, the parent kernel's time (ac76357,
# PERF.md section 6: the mean of its two runs in run Q7's A B B A,
# scripts/gemm_path_times.py --only stream, bf16 out, NVIDIA H100 80GB
# HBM3 at 700 W: printed for the reader, never put in the kernels line),
# the aim: ("library", f): at most f times torch.matmul in this run;
# ("parent", f): at most f times the parent's time; None).  Forms: "x" /
# "y" X / Y as core/packing.py's panels, "shared" Y without the batch
# axis (stride 0), "checksum" the ABFT sidecar, "f16" F16GER2.
STREAM_TARGETS = (
    ("deepseek-7b decode gate/up 4x4096x11008", (None, 4, 4096, 11008), (),
     0.0549, ("library", 1.0)),
    ("deepseek-7b decode q/k/v/o 4x4096x4096", (None, 4, 4096, 4096), (),
     0.0294, ("parent", 1.02)),
    ("deepseek-7b decode down 4x11008x4096", (None, 4, 11008, 4096), (),
     0.0539, ("parent", 1.02)),
    ("deepseek-7b logits 4x4096x102400", (None, 4, 4096, 102400), (), 0.2992,
     ("parent", 1.02)),
    ("deepseek-moe-16b bank decode w1 64x1x2048x1408",
     (64, 1, 2048, 1408), (), 0.1726, ("library", 1.0)),
    ("deepseek-moe-16b bank decode w2 64x1x1408x2048",
     (64, 1, 1408, 2048), (), 0.1761, ("library", 1.0)),
    ("deepseek-moe-16b bank prefill w1 64x30x2048x1408",
     (64, 30, 2048, 1408), (), 0.3521, ("library", 1.0)),
    ("deepseek-moe-16b bank prefill w2 64x30x1408x2048",
     (64, 30, 1408, 2048), (), 0.3892, ("library", 1.0)),
    ("bucket 16 16x4096x11008", (None, 16, 4096, 11008), (), 0.0599,
     ("parent", 1.02)),
    ("bucket 32 32x4096x11008", (None, 32, 4096, 11008), (), 0.0704,
     ("parent", 1.02)),
    ("bucket 64 64x4096x11008", (None, 64, 4096, 11008), (), 0.1186,
     ("parent", 1.02)),
    ("whisper decoder MLP 4x768x3072", (None, 4, 768, 3072), (), 0.0142,
     ("parent", 1.02)),
    ("whisper logits 4x768x51865 (unaligned)", (None, 4, 768, 51865), (),
     0.1187, ("parent", 1.02)),
    ("mamba2 in_proj 4x768x3352", (None, 4, 768, 3352), (), 0.0146,
     ("parent", 1.02)),
    ("SSD batched M=1 4x1x128x1536", (4, 1, 128, 1536), (), 0.0116,
     ("parent", 1.02)),
    ("decode 4x4096x11008 packed Y", (None, 4, 4096, 11008), ("y",), 0.054,
     ("parent", 1.02)),
    ("decode 4x4096x11008 packed X+Y", (None, 4, 4096, 11008), ("x", "y"),
     0.0541, ("parent", 1.02)),
    ("bank decode w1 64x1x2048x1408 packed Y", (64, 1, 2048, 1408), ("y",),
     0.1711, ("parent", 1.02)),
    ("3x4x4096x4096 shared packed Y", (3, 4, 4096, 4096), ("y", "shared"),
     0.0508, ("parent", 1.02)),
    ("decode 4x4096x11008 sidecar", (None, 4, 4096, 11008), ("checksum",),
     0.0553, ("parent", 1.02)),
    ("f16 decode 4x4096x11008", (None, 4, 4096, 11008), ("f16",), 0.0542,
     ("parent", 1.02)),
)

# The output hashes of STREAM_TARGETS at the parent (ac76357), from
# scripts/gemm_path_times.py --only stream (as PHASE15_PARENT_SHA; the
# sidecar's of its ``out`` alone).
PHASE16_PARENT_SHA = {
    "deepseek-7b decode gate/up 4x4096x11008": "4dfbdf876ddf8b67",
    "deepseek-7b decode q/k/v/o 4x4096x4096": "cb67288b2498df41",
    "deepseek-7b decode down 4x11008x4096": "e99eaae121b38f65",
    "deepseek-7b logits 4x4096x102400": "f5affbfd81d0465e",
    "deepseek-moe-16b bank decode w1 64x1x2048x1408": "af286ecb7693fbe3",
    "deepseek-moe-16b bank decode w2 64x1x1408x2048": "89e0606233f100c8",
    "deepseek-moe-16b bank prefill w1 64x30x2048x1408": "bfde502305ce0838",
    "deepseek-moe-16b bank prefill w2 64x30x1408x2048": "affff97ed751e0b6",
    "bucket 16 16x4096x11008": "feeb69b83f2afe5d",
    "bucket 32 32x4096x11008": "c55169b57b3b71ba",
    "bucket 64 64x4096x11008": "a5eda889c99f1d6e",
    "whisper decoder MLP 4x768x3072": "08462caa56d512ee",
    "whisper logits 4x768x51865 (unaligned)": "11f718a066ca1433",
    "mamba2 in_proj 4x768x3352": "1b65be5453091f22",
    "SSD batched M=1 4x1x128x1536": "76eb28f693d86964",
    "decode 4x4096x11008 packed Y": "b0b67e5ec65918ac",
    "decode 4x4096x11008 packed X+Y": "189fa261e17d3b82",
    "bank decode w1 64x1x2048x1408 packed Y": "f2aa8cebd12df640",
    "3x4x4096x4096 shared packed Y": "838fb6c3e93a630b",
    "decode 4x4096x11008 sidecar": "4c7fe93db12f2e35",
    "f16 decode 4x4096x11008": "a60e19277852f0a3",
}


def stream_target_operands(torch, i):
    """STREAM_TARGETS[i]'s operands from seed 501 + i: (x, y, the X the
    kernel reads, mma_gemm's keywords, the Y the kernel reads), as
    wgmma_target_operands; a "shared" Y has no batch axis."""
    from repro_torch.core import packing, precision
    _, (b, m, k, n), forms, _, _ = STREAM_TARGETS[i]
    g = torch.Generator(device="cuda").manual_seed(501 + i)
    kind = (precision.Ger.F16GER2 if "f16" in forms
            else precision.Ger.BF16GER2)
    dt = precision.policy(kind).x_dtype
    lead = () if b is None else (b,)
    ylead = () if "shared" in forms else lead
    x = torch.randn(*lead, m, k, generator=g, device="cuda").to(dt)
    y = (torch.randn(*ylead, k, n, generator=g, device="cuda")
         * k ** -0.5).to(dt)
    # bf16 out: FacilityConfig's default, as decode stores
    kw = dict(kind=kind, checksum="checksum" in forms,
              out_dtype=torch.bfloat16)
    xk, yk = x, y
    if "x" in forms:
        po = packing.pack_gemm(x, packing.gemm_layout(
            kind, m, k, side="x", batched=b is not None))
        xk, kw["x_layout"] = po.data, po.layout
    if "y" in forms:
        po = packing.pack_gemm(y, packing.gemm_layout(
            kind, k, n, batched=len(ylead) > 0))
        yk, kw["y_layout"] = po.data, po.layout
    if "shared" in forms:
        y = y.expand(b, k, n)
    return x, y, xk, kw, yk


def aim_text(aim, ms, lib_ms, parent_ms):
    """(met, text) of an aim: ("ms", t), ("library", f) times
    ``lib_ms``, ("parent", f) times ``parent_ms``; None where there is
    none (or no parent time to hold it to)."""
    if aim is None:
        return None, ""
    kind, goal = aim
    limit = {"ms": goal, "library": goal * lib_ms,
             "parent": goal * (parent_ms or 0)}[kind]
    if kind == "parent" and parent_ms is None:
        return None, "; aim: no parent time"
    return ms <= limit, (f"; aim {'met' if ms <= limit else 'MISSED'} "
                         f"(<= {limit:.4f} ms)")


def phase16_kernels(torch, timer, failures):
    """The 16-bit weight stream at STREAM_TARGETS through the kernel
    wrapper: counts zeroed just before and read just after (each on the
    stream path); each within its tolerance of its split-K plain version,
    the same bits twice, packed and shared forms bit for bit the natural
    launch, its hash against the parent's; each batch of 64 expert banks
    bit for bit its experts run one at a time (b = 1: K split over blocks
    with partials, where the bank folds the split in registers); then
    timed beside the plain version, ``torch.matmul``, the bound and the
    parent's PERF.md time, its aim met or missed (reported, not failed).
    Returns the ``kernels`` entry."""
    from repro_torch.core import tiling
    from repro_torch.kernels import mma_gemm as G

    ops = [stream_target_operands(torch, i)
           for i in range(len(STREAM_TARGETS))]
    kernels = kernel_wrappers()
    torch.cuda.synchronize()
    zero_counts9(kernels)
    outs = [G.mma_gemm(xk, yk, **kw) for _, _, xk, kw, yk in ops]
    torch.cuda.synchronize()
    counts = read_counts9(kernels)
    by_gemm = counts["by_path"]["mma_gemm"]
    _check(failures, "phase 16 main path",
           counts["launches"]["mma_gemm"] == by_gemm["stream"] == len(ops),
           f"GEMM launches {counts['launches']['mma_gemm']}, by path "
           f"{by_gemm} (want {len(ops)} on the stream)")
    rows, worst, met = {}, 0.0, {}
    for (label, (b, m, k, n), forms, parent, aim), (x, y, xk, kw, yk), \
            got in zip(STREAM_TARGETS, ops, outs):
        out = got[0] if kw["checksum"] else got
        cfg = tiling.choose_gemm_path(m, n, k, kw["kind"], b or 1)[1]
        plain = G._plain_of("stream", cfg, k)
        want = plain(x, y, kind=kw["kind"], out_dtype=torch.bfloat16)
        worst = max(worst, _report_close(
            torch, f"stream {label} vs split-K plain", out.float(),
            want.float(), torch.bfloat16, failures))
        again = G.mma_gemm(xk, yk, **kw)
        again = again[0] if kw["checksum"] else again
        _check(failures, f"phase 16 {label}", torch.equal(again, out),
               "two launches the same bits")
        if forms and forms != ("f16",):
            _check(failures, f"phase 16 {label}", torch.equal(
                out, G.mma_gemm(x, y, kind=kw["kind"],
                                out_dtype=torch.bfloat16)),
                "bit for bit the natural launch without the sidecar")
        if b == 64:
            one = torch.stack([G.mma_gemm(x[e], y[e], kind=kw["kind"],
                                          out_dtype=torch.bfloat16)
                               for e in range(b)])
            _check(failures, f"phase 16 {label}", torch.equal(one, out),
                   f"the bank bit for bit its experts one at a time (the "
                   f"bank: {cfg.units(n, b)[0][3] - cfg.units(n, b)[0][2]} "
                   f"slices a unit of {cfg.split}; one expert: "
                   f"{cfg.run(n)} a unit)")
        sha = sha16(torch, out)
        parent_sha = PHASE16_PARENT_SHA.get(label)
        same = sha == parent_sha
        _check(failures, f"phase 16 {label}", same,
               f"output sha256 {sha} against the parent's {parent_sha}")
        row = {"ms": timer(lambda xk=xk, yk=yk, kw=kw: G.mma_gemm(
                   xk, yk, **kw)),
               "plain_ms": timer(lambda x=x, y=y, kind=kw["kind"]:
                                 plain(x, y, kind=kind), iters=3, warmup=1),
               "library_ms": timer(lambda x=x, y=y: torch.matmul(x, y)),
               "library": "torch.matmul",
               "plan": [cfg.bn, cfg.split, cfg.run(n, b or 1)],
               "sha256": sha, "parent_sha": same}
        bb = b or 1
        ybytes = k * n * 2 * (1 if "shared" in forms else bb)
        row["bound_ms"], row["bound_by"] = bound_ms(
            (m * k + m * n) * 2 * bb + ybytes, 2 * m * n * k * bb, "bf16")
        met[label], text = aim_text(aim, row["ms"], row["library_ms"],
                                    parent)
        print(f"  time stream {label}: {row['ms']:.4f} ms (bn {cfg.bn}, "
              f"split {cfg.split}, {cfg.run(n, bb)} a unit; parent in "
              f"PERF.md: {'not measured' if parent is None else f'{parent} ms'}"
              f"), plain {row['plain_ms']:.4f} ms, torch.matmul "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.2f} of "
              f"bound{text}", flush=True)
        rows[label] = row
    del ops, outs
    label = STREAM_TARGETS[0][0]
    entry = {"name": "mma_gemm weight stream (TMA, work units)",
             "route": "cuda", "source": "src/repro_torch/csrc/gemm_stream.cu",
             "replaces": "src/repro/kernels/mma_gemm.py:417",
             "launches": by_gemm["stream"], "max_abs_err": worst,
             **rows[label], "shape": label, "timed": rows, "aims_met": met}
    if entry["launches"] <= 0:
        failures.append(f"{entry['name']} never launched in phase 16's run")
    return [entry]


def phase16(torch, failures, entries):
    """Phase 16: the 16-bit weight stream at the main path's decode
    shapes, checked, hashed against the parent and timed."""
    print("== phase 16: the 16-bit weight stream (TMA producer, work "
          "units sized to the card)", flush=True)
    t0 = time.perf_counter()
    timer = Timer(torch)
    entries += phase16_kernels(torch, timer, failures)
    del timer
    torch.cuda.empty_cache()
    print(f"  phase 16: {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------
# Phase 17: elastic training (runtime/elastic.py) at mamba2-130m's full
# width and depth
# ----------------------------------------------------------------------

# mamba2-130m, the training launcher's default arch (24 layers, d_model
# 768, 0.168 B fp32 parameters), through launch.train.build and
# ElasticTrainer on phase 5's batch (4 x 512 tokens, lr 3e-5) with
# step-addressable batches from seed 0: run(10), a checkpoint every 4 steps,
# under a node death at step 5 (restart from step 4), a 2 s straggler at
# step 9 (the watchdog at patience 1) and a crash in the final sync save
# at step 10 (restart from step 8); then the same 10 steps with no fault.
ELASTIC = dict(arch="mamba2-130m", steps=10, ckpt_every=4, fail_at=5,
               slow_at=9, slow_s=2.0, crash_save_at=10)
ELASTIC_SEEN = [0, 1, 2, 3, 4] + [4, 5, 6, 7, 8, 9] + [8, 9]


def elastic_run(torch, cfg, run, plan):
    """One ``ElasticTrainer.run`` of ``ELASTIC`` into a fresh temporary
    directory, every kernel's launches reset just before it and read just
    after; returns (the trainer's output, the checkpoint directory's
    latest step, the launches, each step's (step, loss, host seconds), the
    checkpoint I/O as (what, step, seconds), the state's GiB, the run's
    seconds, the run's peak device memory in GiB above what was allocated
    before it)."""
    import threading

    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.runtime import elastic as EL

    io = []

    class Timed(C.Checkpointer):
        """The port's Checkpointer with each save's, snapshot's and
        restore's seconds recorded (the async write on its thread)."""

        def save_async(self, step, tree):
            t0 = time.perf_counter()
            super().save_async(step, tree)
            io.append(("async snapshot", step, time.perf_counter() - t0))

        def _write(self, step, paths, host_leaves):
            what = ("sync save" if threading.current_thread()
                    is threading.main_thread() else "async write")
            t0, done = time.perf_counter(), False
            try:
                super()._write(step, paths, host_leaves)
                done = True
            finally:
                io.append((what if done else what + " (crashed)", step,
                           time.perf_counter() - t0))

        def restore(self, step, like, shardings=None):
            t0 = time.perf_counter()
            out = super().restore(step, like, shardings)
            torch.cuda.synchronize()
            io.append(("restore", step, time.perf_counter() - t0))
            return out

    make_state, make_step, _ = T.build(cfg, lr=TRAIN["lr"],
                                       total_steps=ELASTIC["steps"], seed=0,
                                       device="cuda")
    steps = []

    def batches(start):
        return pipeline.Prefetcher(cfg, batch=TRAIN["batch"],
                                   seq=TRAIN["seq"], device="cuda",
                                   start_step=start, seed=0)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as d:
        trainer = EL.ElasticTrainer(
            make_step=make_step, make_state=make_state, batches=batches,
            checkpointer=Timed(d),
            cfg=EL.ElasticConfig(ckpt_every=ELASTIC["ckpt_every"],
                                 straggler_patience=1),
            faults=plan,
            on_step=lambda step, loss, dt: steps.append((step, loss, dt)))
        kernels = kernel_wrappers()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        t0 = time.perf_counter()
        out = trainer.run(ELASTIC["steps"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        launches = {name: fn.launches for name, fn in kernels.items()}
        take_records(run, kernels)
        latest = trainer.ckpt.latest_step()
        gib = sum(t.numel() * t.element_size()
                  for _, t in C._flatten(out["state"])) / 2**30
    return out, latest, launches, steps, io, gib, wall, peak


def elastic_report(failures, run, cfg, out, latest, launches, steps, io,
                   gib, wall, peak, plan=None):
    """Print one elastic run and hold its launches to the per-call model
    times the steps that ran; with ``plan`` (the faulted run), also its
    restarts, the steps it ran, its stragglers and its latest step."""
    import math
    seen = [m["step"] for m in out["metrics"]]
    per_step = {k: v for k, v in expected_train_launches(cfg).items()
                if k != "forward_gemm"}
    model_counts = {k: len(seen) * per_step.get(k, 0) for k in launches}
    ok_counts = model_counts == launches and all(
        launches[k] > 0 for k, n in per_step.items() if n)
    dts = [dt for _, _, dt in steps]
    med = sorted(dts)[len(dts) // 2]
    print(f"  {run}: {wall:.1f} s, steps run {seen}, restarts "
          f"{out['restarts']}, stragglers {out['stragglers']}, latest step "
          f"{latest}; step time {med * 1e3:.2f} ms (host clock, median of "
          f"{len(dts)}, the sync on the loss; "
          f"{[round(dt * 1e3, 1) for dt in dts]} ms); peak device memory "
          f"{peak:.2f} GiB above what was allocated before the run")
    for what, step, sec in io:
        print(f"    {what} of step {step}: {sec:.3f} s, {gib:.2f} GiB, "
              f"{gib / sec:.2f} GiB/s")
    print(f"  [{'ok' if ok_counts else 'FAIL'}] {run}: launches {launches}; "
          f"{len(seen)} steps x {per_step} give {model_counts}; GEMM by path "
          f"{RECORDS[run]['by_path']['mma_gemm']}, depthwise conv by path "
          f"{RECORDS[run]['by_path']['mma_depthwise_conv2d']}")
    if not ok_counts:
        failures.append(f"{run} launch counts {launches} differ from the "
                        f"per-call model {model_counts}")
    finite = all(math.isfinite(m["loss"]) for m in out["metrics"])
    print(f"  [{'ok' if finite else 'FAIL'}] {run}: every loss finite "
          f"({[round(m['loss'], 4) for m in out['metrics']]})")
    if not finite:
        failures.append(f"{run}: a loss not finite")
    if plan is None:
        return
    by_step = {}
    for step, _, dt in steps:
        by_step.setdefault(step, []).append(dt)
    others = [(s, [round(t, 3) for t in by_step[s]])
              for s in out["stragglers"] if s != ELASTIC["slow_at"]]
    checks = (
        ("restarts == 2", out["restarts"] == 2),
        (f"steps run {ELASTIC_SEEN} (resumed from 4 and 8, never from 0)",
         seen == ELASTIC_SEEN),
        (f"{ELASTIC['slow_at']} in stragglers",
         ELASTIC["slow_at"] in out["stragglers"]),
        (f"latest_step() == {ELASTIC['steps']}", latest == ELASTIC["steps"]),
        ("fault events", [(f.point, f.step) for f in plan.events] == [
            ("train.step", ELASTIC["fail_at"]),
            ("train.step", ELASTIC["slow_at"]),
            ("checkpoint.save", ELASTIC["crash_save_at"])]))
    for what, ok in checks:
        print(f"  [{'ok' if ok else 'FAIL'}] {run}: {what}")
        if not ok:
            failures.append(f"{run}: {what}")
    if others:
        print(f"  {run}: other steps flagged, with their seconds: {others}")


def phase17(torch, failures, entries):
    """Phase 17: elastic training (``runtime/elastic.py``) of mamba2-130m
    at full width and depth under three faults, then the same steps
    clean: the same losses and final state, bit for bit (or within 1e-4,
    said so); the runs' shapes held and timed as phase 5's."""
    from repro_torch.configs import get as get_arch
    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.runtime import faults as F

    print("== phase 17: elastic training (runtime/elastic.py) at "
          "mamba2-130m's full width and depth", flush=True)
    t_phase = time.perf_counter()
    cfg = get_arch(ELASTIC["arch"])
    tmp = tempfile.gettempdir()
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}; batch {TRAIN['batch']} x {TRAIN['seq']}, "
          f"lr {TRAIN['lr']}, {ELASTIC['steps']} steps, a checkpoint every "
          f"{ELASTIC['ckpt_every']} into {tmp} "
          f"({shutil.disk_usage(tmp).free / 2**30:.0f} GiB free)",
          flush=True)
    plan = F.FaultPlan([
        F.FaultSpec(point=F.TRAIN_STEP, kind=F.RAISE,
                    at_steps=(ELASTIC["fail_at"],)),
        F.FaultSpec(point=F.TRAIN_STEP, kind=F.LATENCY,
                    at_steps=(ELASTIC["slow_at"],),
                    latency_s=ELASTIC["slow_s"]),
        F.FaultSpec(point=F.CHECKPOINT_SAVE, kind=F.RAISE,
                    at_steps=(ELASTIC["crash_save_at"],))])
    runs = {}
    for run, p in ((f"{cfg.name} elastic", plan),
                   (f"{cfg.name} elastic clean", None)):
        runs[run] = elastic_run(torch, cfg, run, p)
        elastic_report(failures, run, cfg, *runs[run], plan=p)
        torch.cuda.empty_cache()
    (fault_run, (faulted, *_)), (clean_run, (clean, *_)) = runs.items()
    launches = {run: res[2] for run, res in runs.items()}
    # A restart that kept the failed attempt's state while make_state()
    # built the next would raise the faulted run's peak by the state's size.
    gib, peak_f, peak_c = (runs[fault_run][5], runs[fault_run][7],
                           runs[clean_run][7])
    ok = peak_f <= peak_c + gib / 2
    print(f"  [{'ok' if ok else 'FAIL'}] {fault_run}: peak device memory "
          f"{peak_f:.2f} GiB against the clean run's {peak_c:.2f} GiB (at "
          f"most half the {gib:.2f} GiB state more)")
    if not ok:
        failures.append(f"{fault_run}: a restart raised the peak memory")
    want = {m["step"]: m["loss"] for m in clean["metrics"]}
    loss_diffs = [abs(m["loss"] - want[m["step"]]) / abs(want[m["step"]])
                  for m in faulted["metrics"]]
    a, b = C._flatten(faulted["state"]), C._flatten(clean["state"])
    same_paths = [p for p, _ in a] == [p for p, _ in b]
    leaf_diffs = [((x.double() - y.double()).norm()
                   / y.double().norm().clamp_min(1e-30)).item()
                  for (_, x), (_, y) in zip(a, b)]
    bitwise = (same_paths and max(loss_diffs) == 0
               and all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b)))
    close = same_paths and max(loss_diffs + leaf_diffs) <= 1e-4
    print(f"  [{'ok' if close else 'FAIL'}] {fault_run} against "
          f"{clean_run}: each step's loss and every one of {len(a)} leaves "
          f"of the final state "
          + ("bit for bit" if bitwise else
             f"NOT bit for bit: worst loss {max(loss_diffs):.3e}, worst leaf "
             f"rel L2 {max(leaf_diffs):.3e} (tol 1e-4)"))
    if not close:
        failures.append(f"{fault_run}: losses or final state differ from "
                        f"the clean run")
    del runs, faulted, clean, a, b
    torch.cuda.empty_cache()
    print("== phase 17: the elastic runs' GEMM and depthwise conv shapes, "
          "checked and timed", flush=True)
    time_run_shapes(torch, entries, failures, [fault_run, clean_run])
    for e in entries:
        if e["name"] not in ("mma_gemm", "mma_depthwise_conv2d"):
            continue
        for run in (fault_run, clean_run):
            e["launches_by_run"][run] = launches[run][e["name"]]
            e["launches"] += launches[run][e["name"]]
            for path, k in RECORDS[run]["by_path"][e["name"]].items():
                e["launches_by_path"][path] = (
                    e["launches_by_path"].get(path, 0) + k)
    print(f"  phase 17: {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# Phase 18: the mesh (parallel/api.py, core/lowering.py's per-shard
# dispatch).  One card, so the mesh is MESH["world"] processes that all
# bind cuda:0 over gloo (NCCL refuses two ranks on one GPU): the compute is
# the card's, the collectives are gloo's through host memory.
# ----------------------------------------------------------------------

MESH = dict(world=4, shape=(2, 2), axes=("data", "model"), timeout_s=240,
            join_s=600)
# (a): deepseek-7b's prefill products (M, K, N, bias + residual), causal
# GQA attention, a sequence-parallel case, whisper's conv2, zamba2's
# depthwise conv, an indivisible product and Plan(mesh=False)
MESH_GEMMS = ((256, 4096, 4096, False), (256, 4096, 11008, False),
              (256, 11008, 4096, True))
# (b): deepseek-moe-16b at 3 layers, phase 3's first 4 prompts
MESH_MOE = dict(arch="deepseek-moe-16b", layers=3, prompts=4,
                expert_meshes=((2, 2), (1, 4)))
# (c): deepseek-7b at 4 layers, one step on phase 5's 4 x 512 tokens.
# What the step computed before Adam normalised it is held against one
# process: each leaf's first moment (1 - b1) g within MESH_MOMENT_TOL of
# its scale and the world's gradient norm within MESH_NORM_TOL relative
# (the CPU's sound readings 1.2e-2 and 5.2e-5, its planted faults >= 1.0
# and >= 5.8e-2: tests/torch_mesh_cases.py), and the same step with the
# data axis's gradient sum skipped must fail them.
MESH_TRAIN = dict(arch="deepseek-7b", layers=4, batch=4, seq=512)
MESH_MOMENT_TOL, MESH_NORM_TOL = 5e-2, 1e-3
# (d): mamba2-130m at full width and depth, 6 steps, a collective raise
# in step 3, on phase 17's 4 x 512 tokens (two of its 256-token SSD
# chunks a row)
MESH_ELASTIC = dict(arch="mamba2-130m", steps=6, fail_step=3, ckpt_every=2,
                    batch=4, seq=512)


def mesh_cases(torch):
    """(a)'s contractions: [(name, fn() -> output, sharded?)], operands
    from seed 1801 on the card (the same in every process)."""
    from repro_torch.core import facility as F
    g = torch.Generator(device="cuda").manual_seed(1801)

    def rnd(*shape, dt=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(dt)

    cases = []
    for m, k, n, fused in MESH_GEMMS:
        x, y = rnd(m, k), rnd(k, n, scale=k ** -0.5)
        kw = dict(bias=rnd(n), residual=rnd(m, n)) if fused else {}
        cases.append((f"gemm {m}x{k}x{n}" + (" +bias+res" if fused else ""),
                      lambda x=x, y=y, kw=kw: F.contract("mk,kn->mn", x, y,
                                                         **kw), True))
    q, kv = rnd(1, 256, 32, 128), rnd(1, 256, 32, 128)
    cases.append(("attn causal (1, 256, 32, 128) kv 32",
                  lambda: F.contract(F.ATTN, q, kv, kv,
                                     plan=F.Plan(causal=True)), True))
    qs, ks = rnd(2, 256, 6, 128), rnd(2, 256, 3, 128)
    cases.append(("attn causal seq-parallel (2, 256, 6, 128) kv 3",
                  lambda: F.contract(F.ATTN, qs, ks, ks,
                                     plan=F.Plan(causal=True)), True))
    img, filt, b = rnd(4, 3001, 768), rnd(3, 768, 768, scale=0.02), \
        rnd(768)
    gelu = F.Epilogue(bias=True, activation="gelu")
    cases.append(("conv2 (4, 3001, 768) k3 s2 +bias+gelu",
                  lambda: F.contract(F.CONV1D, img, filt, bias=b,
                                     plan=F.Plan(stride=2, padding="same",
                                                 epilogue=gelu)), True))
    dimg, taps, db = rnd(4, 259, 4224), rnd(4, 4224, dt=torch.float32), \
        rnd(4224, dt=torch.float32)
    silu = F.Epilogue(bias=True, activation="silu")
    cases.append(("depthwise (4, 1, 259, 4224) +bias+silu",
                  lambda: F.contract(F.CONV1D_DEPTHWISE, dimg, taps,
                                     bias=db, plan=F.Plan(
                                         ger=F.Ger.F32GER, padding="valid",
                                         epilogue=silu,
                                         out_dtype=torch.bfloat16)), True))
    xo, yo = rnd(7, 4096), rnd(4096, 13)
    cases.append(("gemm 7x4096x13 (indivisible)",
                  lambda: F.contract("mk,kn->mn", xo, yo), False))
    x0, y0 = rnd(256, 4096), rnd(4096, 4096, scale=4096 ** -0.5)
    cases.append(("gemm 256x4096x4096 Plan(mesh=False)",
                  lambda: F.contract("mk,kn->mn", x0, y0,
                                     plan=F.Plan(mesh=False)), False))
    return cases


def _moe_forward(torch, model, cfg, tokens):
    from repro_torch.models import model as M
    with torch.no_grad():
        logits, _, _ = M.forward(model, {"tokens": tokens}, cfg)
    return logits


def _moe_setup(torch):
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_arch(MESH_MOE["arch"]),
                              num_layers=MESH_MOE["layers"])
    settings = dict(MOE_RUN[1])
    reqs = S._make_requests(cfg, settings["n_requests"],
                            settings["prompt_len"], settings["gen_len"], 0)
    tokens = torch.cat([torch.from_numpy(r.prompt) for r in
                        reqs[:MESH_MOE["prompts"]]]).cuda()
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    return cfg, model, tokens


def _train_setup(torch, mesh=None):
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    cfg = dataclasses.replace(get_arch(MESH_TRAIN["arch"]),
                              num_layers=MESH_TRAIN["layers"])
    batch = pipeline.device_batch(pipeline.synthetic_batch(
        cfg, batch=MESH_TRAIN["batch"], seq=MESH_TRAIN["seq"], step=0),
        "cuda")
    mk, mstep, shardings = T.build(cfg, lr=TRAIN["lr"],
                                   total_steps=TRAIN["steps"],
                                   weight_decay=0.0, seed=0, device="cuda",
                                   mesh=mesh)
    return cfg, batch, mk, mstep, shardings


def mesh_single(torch, tmp):
    """The parent's unsharded runs on the card: (a)'s hashes, (b)'s
    logits hash and (c)'s step, its parameters and first moments written
    to ``tmp`` leaf by leaf for rank 0 to hold its mesh step's against."""
    out = {"a": {name: sha16(torch, fn()) for name, fn, _ in
                 mesh_cases(torch)}}
    cfg, model, tokens = _moe_setup(torch)
    out["b"] = sha16(torch, _moe_forward(torch, model, cfg, tokens))
    del model
    torch.cuda.empty_cache()
    cfg, batch, mk, mstep, _ = _train_setup(torch)
    state = mk()
    m = mstep()(state, batch)[1]
    out["c_loss"] = float(m["loss"])
    out["c_grad_norm"] = float(m["grad_norm"])
    os.makedirs(os.path.join(tmp, "c_ref"), exist_ok=True)
    for name, p in state["params"].named_parameters():
        for tag, t in (("p", p), ("m", state["opt"]["m"][name])):
            torch.save(t.detach().cpu(), os.path.join(
                tmp, "c_ref", f"{tag}.{name}.pt"))
    del state, m
    torch.cuda.empty_cache()
    return out


def _gloo_cuda(torch, mesh):
    """Which c10d collectives gloo takes on CUDA tensors, on the mesh's
    groups (``parallel/api.py`` calls these four; a refused one fails
    the phase)."""
    import torch.distributed as dist
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    ops = {
        "all_gather_into_tensor": lambda g: dist.all_gather_into_tensor(
            torch.empty(16, device="cuda"), x, group=g),
        "reduce_scatter_tensor": lambda g: dist.reduce_scatter_tensor(
            torch.empty(4, device="cuda"), x, group=g),
        "all_to_all_single": lambda g: dist.all_to_all_single(
            torch.empty_like(x), x, group=g),
        "all_reduce": lambda g: dist.all_reduce(x.clone(), group=g)}
    got = {}
    for op, fn in ops.items():
        try:
            for ax in MESH["axes"]:
                fn(mesh.get_group(ax))
            torch.cuda.synchronize()
            got[op] = "cuda"
        except RuntimeError as e:       # gloo refuses a CUDA tensor
            got[op] = f"refused ({str(e)[:80]})"
    return got


def mesh_rank(torch, rank, tmp):
    """One rank's phase 18: every check's result, hashed or compared here
    (rank 0 compares (c) against the parent's files)."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.configs import get as get_arch
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import api as par
    from repro_torch.runtime import faults as Fl
    from repro_torch.runtime.elastic import ElasticConfig, ElasticTrainer

    mesh = init_device_mesh("cuda", MESH["shape"], mesh_dim_names=MESH["axes"])
    rules = par.default_rules(mesh)
    kernels = kernel_wrappers()
    res = {"gloo_cuda": _gloo_cuda(torch, mesh), "a": {}, "b": {},
           "launches": {}}

    def probe():
        return Fl.FaultPlan([Fl.FaultSpec(Fl.COLLECTIVE, kind=Fl.LATENCY,
                                          latency_s=0.0, every=1,
                                          max_fires=None)])

    def counted(run, fn):
        zero_counts(kernels)
        out = fn()
        torch.cuda.synchronize()
        c = read_counts(kernels)
        res["launches"][run] = {"launches": c["launches"],
                                "by_path": c["by_path"]}
        return out

    t0 = time.perf_counter()
    for name, fn, _ in mesh_cases(torch):
        p = probe()
        with par.use_rules(rules), Fl.install(p):
            out = counted(f"phase18 {name}", fn)
        res["a"][name] = (sha16(torch, out), len(p.fired(Fl.COLLECTIVE)))
    res["a_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg, model, tokens = _moe_setup(torch)
    for shape in MESH_MOE["expert_meshes"]:
        m = (mesh if tuple(shape) == tuple(MESH["shape"]) else
             init_device_mesh("cuda", shape, mesh_dim_names=MESH["axes"]))
        p = probe()
        before = par.COLLECTIVE_BYTES["all_to_all_single"]
        try:
            MOE.EXCHANGE_DISPATCH = True
            with par.use_rules(par.default_rules(m)), Fl.install(p):
                logits = counted(f"phase18 moe {shape[0]}x{shape[1]}",
                                 lambda: _moe_forward(torch, model, cfg,
                                                      tokens))
        finally:
            MOE.EXCHANGE_DISPATCH = False
        res["b"][f"{shape[0]}x{shape[1]}"] = (
            sha16(torch, logits), len(p.fired(Fl.COLLECTIVE)),
            par.COLLECTIVE_BYTES["all_to_all_single"] - before)
        del logits
    del model
    torch.cuda.empty_cache()
    res["b_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, batch, mk, mstep, shardings = _train_setup(torch, mesh)
    state = mk()
    share = sum(par.local(t).numel() * par.local(t).element_size()
                for t in list(state["params"].parameters())
                + list(state["opt"]["m"].values())
                + list(state["opt"]["v"].values()))
    whole = sum(t.numel() * t.element_size() * 3
                for t in state["params"].parameters())
    # [1]: the step returns the state it updated, which must not outlive
    # ``state`` (the planted step below builds a second one)
    met = counted("phase18 train", lambda: mstep()(state, batch))[1]
    res["c"] = {"loss": float(met["loss"]), "share_gib": share / 2**30,
                "whole_gib": whole / 2**30,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "sound": step_readings(torch, state, met, rank, tmp, True)}
    del state, met
    torch.cuda.empty_cache()
    state = mk()
    with skipped_data_sum(mesh):
        met = mstep()(state, batch)[1]
    res["c"]["skip"] = step_readings(torch, state, met, rank, tmp, False)
    del state, met, mk, mstep
    torch.cuda.empty_cache()
    res["c_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ecfg = get_arch(MESH_ELASTIC["arch"])
    emk, estep, eshard = T.build(ecfg, lr=TRAIN["lr"],
                                 total_steps=MESH_ELASTIC["steps"],
                                 seed=0, device="cuda", mesh=mesh)

    def trainer(tag, plan):
        return ElasticTrainer(
            make_step=estep, make_state=emk,
            batches=lambda s: pipeline.Prefetcher(
                ecfg, batch=MESH_ELASTIC["batch"], seq=MESH_ELASTIC["seq"],
                device="cuda", start_step=s),
            checkpointer=Checkpointer(os.path.join(tmp, tag)),
            cfg=ElasticConfig(ckpt_every=MESH_ELASTIC["ckpt_every"]),
            state_shardings=eshard, faults=plan)

    count = probe()
    clean = counted("phase18 elastic clean",
                    lambda: trainer("d_clean", count).run(
                        MESH_ELASTIC["steps"]))
    visits = len(count.fired(Fl.COLLECTIVE)) // MESH_ELASTIC["steps"]
    plan = Fl.FaultPlan([Fl.FaultSpec(
        Fl.COLLECTIVE, kind=Fl.RAISE,
        every=MESH_ELASTIC["fail_step"] * visits + 1, max_fires=1)])
    failed = counted("phase18 elastic",
                     lambda: trainer("d_fail", plan).run(
                         MESH_ELASTIC["steps"]))
    res["d"] = {"clean": [m["loss"] for m in clean["metrics"]],
                "failed": {m["step"]: m["loss"] for m in failed["metrics"]},
                "restarts": failed["restarts"],
                "clean_restarts": clean["restarts"], "visits": visits,
                "fired": [f.kind for f in plan.fired()]}
    del clean, failed
    res["d_s"] = time.perf_counter() - t0
    res["bytes"] = dict(par.COLLECTIVE_BYTES)
    return res


def step_readings(torch, state, met, rank, tmp, params: bool) -> dict:
    """(c)'s readings of a mesh step against the parent's (rank 0 reads
    them; every rank takes part in the gathers): the worst leaf's first
    moment error over its scale, the gradient norm, and with ``params``
    the worst parameter's excess over rtol/atol 2e-3."""
    from repro_torch.parallel import api as par
    out = {"moment": 0.0, "param": 0.0, "leaves": 0,
           "grad_norm": float(met["grad_norm"])}

    def ref(tag, name):
        return torch.load(os.path.join(tmp, "c_ref", f"{tag}.{name}.pt")
                          ).cuda()

    with torch.no_grad():
        for name, p in state["params"].named_parameters():
            m = par.full(state["opt"]["m"][name])
            full = par.full(p) if params else None
            if rank == 0:
                want = ref("m", name)
                out["moment"] = max(out["moment"], (
                    (m - want).abs().max()
                    / want.abs().max().clamp_min(1e-30)).item())
                if params:
                    want = ref("p", name)
                    out["param"] = max(out["param"], (
                        (full - want).abs() - 2e-3 * want.abs()
                    ).max().item())
                out["leaves"] += 1
            del m, full
    return out


@contextlib.contextmanager
def skipped_data_sum(mesh):
    """A fault planted in a mesh step: the data axis's gradient sums (the
    FSDP reduce-scatter and the all-reduce of ``parallel.api``'s operand
    backward) leave each rank's partial unsummed."""
    from repro_torch.parallel import api as par
    data = MESH["axes"].index("data")
    rs, ar = par._reduce_scatter, par._all_reduce
    par._reduce_scatter = lambda x, m, axis, dim: (
        par._slice(x, m, axis, dim) if axis == data else rs(x, m, axis, dim))
    par._all_reduce = lambda x, m, axis: (
        x.clone() if axis == data else ar(x, m, axis))
    try:
        yield
    finally:
        par._reduce_scatter, par._all_reduce = rs, ar


def _mesh_child(rank, port, tmp, queue):
    """A phase-18 rank: binds the card (a rank that cannot fails the
    run), joins the gloo world and returns its results on ``queue``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}",
            world_size=MESH["world"], rank=rank,
            timeout=datetime.timedelta(seconds=MESH["timeout_s"]))
        out.update(mesh_rank(torch, rank, tmp))
    except BaseException:   # repro: allow(overbroad-except)
        # reported to the parent, which fails the phase
        out["error"] = traceback.format_exc()[-3000:]
    queue.put(out)
    if dist.is_initialized():
        dist.destroy_process_group()


def phase18(torch, failures, entries):
    """Phase 18: the mesh.  The parent runs (a)-(c) unsharded, then
    ``MESH["world"]`` spawned ranks run them on the 2 x 2 mesh (and (b)
    on a 1 x 4 mesh, (d) only there); every kernel library is built before
    the spawn."""
    import queue as queues
    import socket

    import torch.multiprocessing as mp

    from repro_torch.kernels import _build

    print("== phase 18: the mesh (parallel/api.py, the per-shard contract "
          "dispatch): 4 gloo ranks on cuda:0, a 2 x 2 (data, model) mesh",
          flush=True)
    t_phase = time.perf_counter()
    _build.build()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        single = mesh_single(torch, tmp)
        torch.cuda.empty_cache()    # the card's memory to the ranks
        print(f"  unsharded runs in the parent: {time.perf_counter() - t0:.1f}"
              f" s; (c) loss {single['c_loss']:.6f}", flush=True)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=_mesh_child, args=(r, port, tmp, queue))
                 for r in range(MESH["world"])]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        ranks = {}
        deadline = time.time() + MESH["join_s"]
        while len(ranks) < len(procs) and time.time() < deadline:
            try:
                r = queue.get(timeout=5)
                ranks[r["rank"]] = r
            except queues.Empty:
                # poll until the deadline, or until every rank is gone
                if not any(p.is_alive() for p in procs):
                    break
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        print(f"  ranks ran in {time.perf_counter() - t0:.1f} s", flush=True)
        mesh_report(failures, entries, single, ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)


def mesh_report(failures, entries, single, ranks):
    def check(ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            failures.append(f"phase 18: {what}")

    for r in range(MESH["world"]):
        if r not in ranks or "error" in ranks[r]:
            check(False, f"rank {r}: "
                  + (ranks[r]["error"] if r in ranks else "no result"))
    if failures and any("rank" in f and "phase 18" in f for f in failures):
        return
    r0 = ranks[0]
    check(set(r0["gloo_cuda"].values()) == {"cuda"},
          f"gloo takes CUDA tensors for {r0['gloo_cuda']}")
    # (a)
    for name, want_sha in single["a"].items():
        shas = {ranks[r]["a"][name][0] for r in ranks}
        fired = ranks[0]["a"][name][1]
        want_fire = not ("indivisible" in name or "mesh=False" in name)
        check(shas == {want_sha} and (fired > 0) == want_fire,
              f"(a) {name}: sha256 {sorted(shas)} on the ranks against "
              f"{want_sha} unsharded, collective fired {fired}")
    # (b)
    for shape, _ in ranks[0]["b"].items():
        shas = {ranks[r]["b"][shape][0] for r in ranks}
        fired, moved = ranks[0]["b"][shape][1], ranks[0]["b"][shape][2]
        check(shas == {single["b"]} and fired > 0 and moved > 0,
              f"(b) deepseek-moe-16b ({MESH_MOE['layers']} layers) forward "
              f"with EXCHANGE_DISPATCH on a {shape} mesh: logits sha256 "
              f"{sorted(shas)} against {single['b']} single-process; "
              f"collective fired {fired}, all_to_all_single {moved} bytes")
        paths = ranks[0]["launches"][f"phase18 moe {shape}"]["by_path"][
            "mma_gemm"]
        check(paths.get("stream", 0) + paths.get("wgmma", 0) > 0,
              f"(b) {shape}: GEMM launches by path on rank 0 {paths}")
    # (c)
    c = [ranks[r]["c"] for r in sorted(ranks)]
    dl = max(abs(x["loss"] - single["c_loss"]) for x in c)
    gn = single["c_grad_norm"]

    def holds(r):
        return (r["moment"] <= MESH_MOMENT_TOL
                and abs(r["grad_norm"] - gn) <= MESH_NORM_TOL * gn)

    sound, skip = c[0]["sound"], c[0]["skip"]
    check(dl < 1e-3 and sound["param"] <= 2e-3 and sound["leaves"] > 0
          and holds(sound) and not holds(skip),
          f"(c) deepseek-7b ({MESH_TRAIN['layers']} layers) train step on "
          f"the 2 x 2 mesh (TP + FSDP, launch.train.build(mesh=)), "
          f"{MESH_TRAIN['batch']} x {MESH_TRAIN['seq']} tokens: loss "
          f"{c[0]['loss']:.6f} against {single['c_loss']:.6f} single-process"
          f" (|d| {dl:.2e} < 1e-3), {sound['leaves']} parameters within "
          f"rtol/atol 2e-3 (worst excess {sound['param']:.2e}); first "
          f"moments within {MESH_MOMENT_TOL:g} of each leaf's scale (worst "
          f"{sound['moment']:.3e}), gradient norm {sound['grad_norm']:.6f} "
          f"against {gn:.6f} (rel {abs(sound['grad_norm'] - gn) / gn:.3e}"
          f" <= {MESH_NORM_TOL:g}); the data axis's gradient sum skipped "
          f"fails them (worst moment {skip['moment']:.3e}, gradient norm "
          f"rel {abs(skip['grad_norm'] - gn) / gn:.3e})")
    for r, x in enumerate(c):
        print(f"  (c) rank {r}: peak device memory {x['peak_gib']:.2f} GiB,"
              f" its share of the state {x['share_gib']:.2f} GiB of "
              f"{x['whole_gib']:.2f} GiB (params + moments)")
    # (d)
    d = ranks[0]["d"]
    same = [d["failed"].get(i) for i in range(MESH_ELASTIC["steps"])] \
        == d["clean"]
    close = all(abs(d["failed"][i] - v) <= 1e-4 * abs(v)
                for i, v in enumerate(d["clean"]))
    check(d["restarts"] == 1 and d["clean_restarts"] == 0 and close,
          f"(d) mamba2-130m elastic on the mesh: {d['restarts']} restart "
          f"(a collective raise in step {MESH_ELASTIC['fail_step']}, "
          f"{d['visits']} per-shard dispatches a step), each loss "
          + ("bit for bit the clean run's" if same
             else "within 1e-4 of the clean run's, NOT bit for bit"))
    for r in sorted(ranks):
        x = ranks[r]
        print(f"  rank {r}: collective bytes sent {x['bytes']}; (a) "
              f"{x['a_s']:.1f} s, (b) "
              f"{x['b_s']:.1f} s, (c) {x['c_s']:.1f} s, (d) {x['d_s']:.1f} s")
    for run in r0["launches"]:
        for r in sorted(ranks):
            c = ranks[r]["launches"][run]
            paths = {k: {p: n for p, n in v.items() if n}
                     for k, v in c["by_path"].items()}
            print(f"  {run}: rank {r} launches "
                  f"{ {k: n for k, n in c['launches'].items() if n} }, "
                  f"by path {paths}")
    for e in entries:
        if e["name"] not in ("mma_gemm", "mma_flash_attention",
                             "mma_depthwise_conv2d", "mma_conv2d"):
            continue
        for run in r0["launches"]:
            n = sum(ranks[r]["launches"][run]["launches"][e["name"]]
                    for r in ranks)
            if n:
                e["launches_by_run"][run] = n
                e["launches"] += n


def thread_launches(torch, failures):
    """A first launch on a fresh host thread, for each library: one
    instance above 48 KB of dynamic shared memory, launched on the main
    thread, then on a new ``threading.Thread`` (its first launch there),
    bit for bit the main thread's (ROADMAP queue 3: a process-wide
    "attribute set" flag failed such a launch)."""
    import threading

    from repro_torch.core import precision
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G
    Ger = precision.Ger
    g = torch.Generator(device="cuda").manual_seed(601)

    def rnd(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    ints = torch.randint(-300, 300, (256, 512), generator=g, device="cuda",
                         dtype=torch.int16)
    xs, ys = (rnd(4, 4096), rnd(256, 1024)), (rnd(4096, 4096),
                                              rnd(1024, 1024))
    f64 = torch.randn(512, 512, generator=g, device="cuda",
                      dtype=torch.float64)
    q, kv = rnd(1, 512, 8, 128), rnd(1, 512, 8, 128)
    img, filt = rnd(4, 1, 3001, 768), rnd(1, 3, 768, 768)
    calls = {
        "gemm_stream": lambda: G.mma_gemm(xs[0], ys[0]),
        "gemm_wgmma": lambda: G.mma_gemm(xs[1], ys[1]),
        "mma_gemm": lambda: G.mma_gemm(xs[1], ys[1], block=(128, 128, 32)),
        "gemm_imma": lambda: G.mma_gemm(ints, ints.t().contiguous(),
                                        kind=Ger.I16GER2),
        "gemm_dmma": lambda: G.mma_gemm(f64, f64, kind=Ger.F64GER),
        "mma_attention": lambda: A.mma_flash_attention(q, kv, kv,
                                                       causal=True),
        "mma_conv": lambda: K.mma_conv2d(img, filt),
    }
    for lib, call in calls.items():
        main = call()
        torch.cuda.synchronize()
        got, errs = [], []

        def run(call=call):
            try:
                got.append(call())
                torch.cuda.synchronize()
            except RuntimeError as e:   # a failed launch raises
                errs.append(str(e))

        t = threading.Thread(target=run)
        t.start()
        t.join()
        ok = not errs and len(got) == 1 and torch.equal(got[0], main)
        print(f"  [{'ok' if ok else 'FAIL'}] {lib}: a first launch on a "
              f"fresh thread, after the main thread's"
              + (f": {errs[0]}" if errs else ""), flush=True)
        if not ok:
            failures.append(f"{lib}: first launch on a fresh thread")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test runs on the card only")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # F32GER is true fp32
    torch.backends.cudnn.allow_tf32 = False
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ[TUNE_ENV] = os.path.join(tune_dir, "autotune.json")
    try:
        run_phases(torch)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run_phases(torch) -> None:
    t_start = time.perf_counter()
    failures: list[str] = []

    print("== phase 1: card and build", flush=True)
    card = card_line()
    print(f"  card: {card} ({torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"  built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s with {_build.nvcc()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    thread_launches(torch, failures)

    print("== phase 2: kernels against their plain versions", flush=True)
    timer = Timer(torch)
    entries = [check_gemm(torch, timer, failures),
               check_attention(torch, timer, failures),
               check_depthwise_conv(torch, timer, failures),
               check_conv2d(torch, timer, failures)]
    del timer

    print("== phase 3: serve and generate (and phase 8's F32GER runs of "
          "deepseek-7b and whisper-small, phase 9's guarded and ABFT serves "
          "and fault matrix of deepseek-7b, and phase 7's prepacked runs of "
          "deepseek-7b, deepseek-moe-16b, whisper-small and qwen2-vl-7b "
          "after their natural runs)", flush=True)
    by_run = {}
    for arch, settings, layers, profile in (
            (ARCH, SERVE, NUM_LAYERS, True),
            *((a, st, None, a == "zamba2-1.2b") for a, st in SSM_RUNS),
            (*MOE_RUN, None, True)):
        record = [] if arch == ARCH else None
        stats, by_run[arch], (model, cfg) = serve(
            torch, failures, arch, settings, layers, record)
        if profile:
            steps = serve_steps(torch, model, cfg, settings)
            step_breakdown(torch, cfg, *steps)
            if arch == MOE_RUN[0]:
                bank_time(torch, cfg, steps[1])
            del steps
        if arch == ARCH:
            natural = {"stats": stats, "launches": by_run[arch],
                       "record": record, "by_path": RECORDS[arch]["by_path"]}
            f32_natural = f32_serve(torch, failures, model, cfg)
            f32_prepacked_serve(torch, failures, model, cfg, f32_natural)
            del f32_natural
            t9 = time.perf_counter()
            guarded_serves(torch, failures, model, cfg, natural)
            print(f"  phase 9's serving runs: {time.perf_counter() - t9:.1f}"
                  f" s", flush=True)
            prepacked_serve(torch, failures, arch, settings, model, cfg,
                            natural)
            tuned_serves(torch, failures, arch, settings, model, cfg,
                         natural)
            del natural
        elif arch == MOE_RUN[0]:
            # phase 3's first `batch` requests' prompts, decoded on a
            # fresh cache
            from repro_torch.launch import serve as S
            reqs = S._make_requests(cfg, settings["n_requests"],
                                    settings["prompt_len"],
                                    settings["gen_len"], 0)
            prompts = torch.cat([torch.from_numpy(r.prompt)
                                 for r in reqs[:settings["batch"]]])
            prepacked_steps(torch, failures, arch, model, cfg,
                            {"tokens": prompts.cuda()},
                            settings["prompt_len"] + PREPACK_STEPS + 1)
        del model, record
        torch.cuda.empty_cache()
    for arch, settings in MM_RUNS.items():
        by_run[arch], steps, (model, batch, seq_len) = generate(
            torch, failures, arch, settings)
        step_breakdown(torch, *steps)
        cfg = steps[0]
        del steps
        if arch == "whisper-small":
            f32_generate(torch, failures, model, cfg)
            f32_prepacked_generate(torch, failures, model, cfg)
        prepacked_steps(torch, failures, arch, model, cfg, batch, seq_len)
        del model, batch
        torch.cuda.empty_cache()
    check_main_paths(failures)

    print("== phase 4: the runs' GEMM, attention and depthwise conv "
          "shapes, checked and timed", flush=True)
    time_run_shapes(torch, entries, failures, list(RECORDS))

    print("== phase 5: train", flush=True)
    for arch, layers in TRAIN_RUNS:
        by_run[f"{arch} train"], _ = train(torch, failures, arch, layers)
        torch.cuda.empty_cache()
    print("== phase 5: the train runs' GEMM (forward, dX, dW, recompute), "
          "attention and depthwise conv shapes, checked and timed",
          flush=True)
    time_run_shapes(torch, entries, failures,
                    [f"{arch} train" for arch, _ in TRAIN_RUNS])

    print("== phase 6: the family table and its paths", flush=True)
    timer = Timer(torch)
    worst = check_families(torch, failures)
    new, others = family_runs(torch, timer, failures, by_run, worst)
    imma_targets(torch, timer, failures, new)
    entries += new
    entries[0]["phase6_shapes"] = others
    del timer
    for e in entries:
        e["launches_by_run"] = {
            a: (FORMS.get(a, {}).get(PATH_ENTRIES[e["name"]][1], 0)
                if e["name"] in PATH_ENTRIES else n[e["name"]])
            for a, n in by_run.items()}
        e["launches"] = sum(e["launches_by_run"].values())
        if e["name"] in BY_PATH:
            e["launches_by_path"] = {
                p: sum(r["by_path"][e["name"]][p] for r in RECORDS.values())
                for p in next(iter(RECORDS.values()))["by_path"][e["name"]]}
    for e in new:
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched on phase 6's "
                            f"paths")

    print("== phase 7: prepacked serving (core/packing.py; K1d and K3's "
          "packed filter stream)", flush=True)
    for name, r in PHASE7.items():
        print(f"  {name}: packed launches {r['packed']}"
              + (f", pack {r['pack_s']:.3f} s, {r['stats']}"
                 if "pack_s" in r else ""))
    timer = Timer(torch)
    qdot_ops = qdot_packed_run(torch, failures)
    entries += phase7_kernels(torch, timer, failures, qdot_ops)
    del timer, qdot_ops

    phase8(torch, failures, entries)
    phase9(torch, failures, entries)
    phase10(torch, failures, entries)
    phase11(torch, failures, entries)
    phase12(torch, failures, entries)
    phase13(torch, failures, entries)
    phase14(torch, failures, entries)
    phase15(torch, failures, entries)
    phase16(torch, failures, entries)
    phase17(torch, failures, entries)
    phase18(torch, failures, entries)
    finish(torch, failures, card, entries, t_start)


def phase8(torch, failures, entries):
    """Phase 8: the F32GER runs (a) and (b) ran after their models' phase-3
    runs; here (c), then the masked products and K2e's timings."""
    print("== phase 8: the pm* masked forms (K1b) and the tight-parity "
          "F32GER config (K2e)", flush=True)
    f32_train(torch, failures)
    torch.cuda.empty_cache()
    timer = Timer(torch)
    entries += phase8_f32_gemm(torch, timer, failures)
    entries += phase8_kernels(torch, timer, failures)
    del timer


def finish(torch, failures, card, entries, t_start):
    print(f"== done in {time.perf_counter() - t_start:.1f} s", flush=True)
    if failures:
        fail(f"{len(failures)} check(s) failed: {failures}")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
