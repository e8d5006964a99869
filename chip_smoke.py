#!/usr/bin/env python3
"""Drive the PyTorch port (``stable_diffusion_training_tpu_torch``) on one
NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases gpu,build,kernels
    python3 chip_smoke.py --phases gpu,build,train_f32   # the f32 train step alone
    python3 chip_smoke.py --phases gpu,build,train,trace_audit   # the bf16 step, then its audited trace
    python3 chip_smoke.py --phases gpu,build,sdxl_parity,sdxl,sdxl_refiner   # SDXL serving
    python3 chip_smoke.py --phases gpu,build,sdxl_train_parity,sdxl_train,sdxl_trainer   # SDXL training
    python3 chip_smoke.py --phases gpu,build,sd21_parity,sd21,sd21_trainer   # SD2.1 at 768x768
    python3 chip_smoke.py --phases gpu,build,ddp_parity,ddp_trainer   # data parallelism, two ranks
    python3 chip_smoke.py --phases gpu,build,fsdp_parity,fsdp_trainer   # FSDP, two ranks
    python3 chip_smoke.py --phases gpu,build,tp_parity,tp_trainer   # tensor parallelism, two ranks
    python3 chip_smoke.py --phases gpu,build,tp_fsdp_parity,tp_fsdp_trainer,vae_polyphase   # TP with FSDP

Phases, one JSON line each:

1. ``gpu``: the card's name and power limit (nvidia-smi), torch and CUDA.
2. ``build``: ``nvcc`` builds the three kernel libraries from
   ``stable_diffusion_training_tpu_torch/csrc/`` for sm_90a, one ``nvcc``
   each, all started together; the compiler's register and spill report
   goes to ``chiprun_out/chip_smoke_build.log``. Prints every kernel's
   registers and spill bytes and, for the flash-attention Hopper kernels
   (the forward's and the fused bf16 backward), the count of wgmma
   (``HGMMA``) and TMA load (``UTMALDG``) instructions in ``cuobjdump
   -sass`` of the built library; fails if one is missing, spills or lacks
   either, or if an f32 kernel (the fused backward, the forward's narrow
   and wide kernels) is missing or spills. Prints the parts of the
   toolchain's key (``utils.hostcache``: ``nvcc --version``, the host
   compiler, the flags); before building it plants a stale
   ``_build/flash_attention_fwd-0000000000000000/`` and fails unless the
   build purged it and kept every library's own directory.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   with max errors against the stated tolerances, kernel / plain / library
   device times (CUDA events; the calls queued behind a spin kernel so the
   host's time per call is left out and reported apart where it matters)
   and the card's least time for the same work:
   flash-attention forward (K1) at the serving path's shapes, (16, 4096, 40)
   and (1, 4096, 512), in bf16 and f32 (TF32 off), at the train step's,
   (64, 4096, 40) and (8, 4096, 512) in bf16 and f32, at the bucket steps'
   640-channel level, (64, 2704, 80) and (64, 4624, 80) in bf16, at
   SDXL's, (20, 4096, 64) in bf16 and f32, (24, 4096, 64) and (1, 16384,
   512) in bf16, at SD2.1's
   768x768 ones (the 9,216- and 2,304-key levels at train batch 8 and CFG
   batch 2, the 896x640 bucket's 8,960 and 2,240, the VAE mid-block at
   batch 8 and 1 in bf16, sd21_parity's in f32; the plain version over a
   slice of the heads at a time where its f32 scores pass 8 GB), at data
   parallelism's per-rank shapes, (32, 4096, 40) and (4, 4096, 512) in bf16
   (ddp_trainer) and (8, 4096, 40) in f32 (ddp_parity), plus ragged cases
   (D = 40 and 512 with query and key counts off the tiles, D = 64 and 36),
   each with its route (``forward_route``: bf16 narrow or wide tensor-core
   kernel, the f32 kernels, the older CUDA-core kernel), whose counter
   alone must move, a repeat on the same inputs (bitwise equal on the f32
   route), the host's ms per call and the bytes the kernel streams from
   L2; at the four f32 shapes the older CUDA-core kernel, which the f32
   route replaced, checked and timed on the same inputs;
   flash-attention backward on its four routes (``backward_route``): the
   fused tensor-core kernel (bf16, K2 and K3 in one) at the train step's
   (64, 4096, 40), ddp_trainer's per-rank (32, 4096, 40) and at ragged
   cases (D = 64, and D = 40 with both counts off the tiles); its wide-head
   counterpart (bf16, 64 < D <= 128) at SD1.5's 640-channel level in
   train's 832x832 and 1088x1088 bucket steps, (64, 2704, 80) and (64,
   4624, 80), with the CUDA-core pair it replaced timed on the same inputs,
   and at D = 96 and 128 with counts off its tiles; the fused
   f32 kernel (K2 and K3 in one, CUDA cores) at
   train_parity's (8, 4096, 40), train_f32's (64, 4096, 40) and the same
   two ragged cases (and SDXL's and SD2.1's training shapes at D = 64, bf16
   and f32); the CUDA-core K2 and K3 at D = 36 bf16 (and, timed
   only, at (8, 4096, 40) f32 beside the fused f32 kernel): the whole
   call's time, each kernel's (torch.profiler), host ms per call, the fused
   kernels' dQ reduce-add or partial bytes, and two runs on the same inputs
   (dK and dV must be bitwise equal, and dQ too except on the bf16 route,
   whose dQ adds land in any order); the 8-bit Lion update of each SD1.5
   model (``lion_model``: every quantized leaf at its real torch shape and
   permutation, bs 16, bf16 grads with both companders and f32 grads; the
   SDXL UNet and SD2.1's UNet and ViT-H tower in bf16, exact): the
   leaf-table entry ``lion8bit_update_leaves_`` (one launch, grads and
   signs in torch layout) against its plain version (signs and scales
   bitwise, codes at most one apart) and against the old route on the same
   inputs (permute copies, then the single-leaf entry per leaf over the
   bucket limit and the multi-leaf entry over the rest; codes and scales
   bitwise), with each route's device and host ms, the old route's copies
   and kernels apart, the bound and GB/s, and the aims met or missed; the
   earlier entries on grads in JAX order over every SD1.5 leaf above the
   bucket limit (single-leaf entry, one launch each) and over the UNet's
   and CLIP's small-leaf buckets (multi-leaf entry), bs 16, bf16 grads,
   exact and fast companders, plus a bs-64 leaf set, each counted on its
   own case; the functional entry ``fused_lion8bit_update``
   over the largest SD1.5 UNet leaf: narrow (K6) at bs 16 and 128 (the
   cooperative variant) in bf16 and at bs 16 in f32, wide (K7) at bs 16 and
   4 in bf16. That entry is the path that runs K6 and K7 (the JAX package
   calls them from nowhere else): each case first drives it for three
   updates with the counts zeroed just before and read just after.
4. ``parity``: one full-width SD1.5 UNet call at 512x512 in f32 (TF32 off),
   seeded weights, attention_backend "auto" (kernel) against "xla" (plain);
   K1 5 times, all on the f32 route.
5. ``slice``: the SD1.5 text-to-image pipeline at full width in bf16,
   seeded weights, 512x512, one prompt (CFG batch 2), a few DDIM steps after
   a warm-up run. Launch counts are zeroed just before one run and read
   just after it: the kernel must run 5 times per step (the 64x64 latent
   self-attentions, on the narrow tensor-core kernel) and once in the VAE
   decode (the wide one). Then the pipeline and its
   stages (encode, denoise loop, decode) are timed five times each on the
   host clock (medians and every run), and one denoise step runs under
   torch.profiler (``profile`` line: kernel times by name, the device's
   idle share).
6. ``sdxl_parity``: one full-width SDXL base UNet call on 128x128 latents
   at batch 2 in f32 (TF32 off), seeded weights, with ``text_embeds`` and
   ``time_ids``: "auto" against "xla" (a model holding the same tensors)
   within the ``parity`` bound; K1 exactly 10 times at (20, 4096, 64) on
   the f32 route.
7. ``sdxl``: SDXL text-to-image at full width in bf16 (both text towers,
   the base UNet, the VAE), seeded weights, 1024x1024, CFG batch 2, 4 DDIM
   steps, timed and checked as ``slice`` is: K1 exactly 10 times a step at
   (20, 4096, 64) on the narrow kernel and once at (1, 16384, 512) on the
   wide one; one denoise step profiled.
8. ``sdxl_refiner``: the SDXL refiner (img2img, tower 2 alone, 5 time ids)
   at full width in bf16 on ``sdxl``'s image, strength 0.3 of 10 DDIM steps
   (3 run), timed and checked the same way, the image's VAE encode timed
   apart: K1 exactly 20 times a step at (24, 4096, 64) and twice at
   (1, 16384, 512) (the encode and the decode); one denoise step profiled.
9. ``train_parity``: one full-width SD1.5 UNet forward and backward at
   512x512, batch 1, f32 (TF32 off), "auto" (K1 + K2 + K3) against "xla"
   (plain): the loss within 1e-5 relative, every grad within 1e-4 of its
   tensor's max |grad|, and exactly 5 forward launches and 5 of the fused
   f32 backward (none of the bf16 one or the CUDA-core pair). The
   same "auto" step with gradient checkpointing (every down, mid and up
   block recomputed in the backward) against it within the same bounds,
   with K1 launched 5 more times by the recompute. Then the same in bf16,
   where the tensor-core kernels run (K1 5 times, the fused backward 5
   times, the f32 one and the CUDA-core pair never): each route's bf16 grads against the
   f32 plain grads, the kernels' no further off than twice the plain
   route's, tensor by tensor.
10. ``train``: the SD1.5 train step at full width through
   ``train.on_device_model_training_state`` and ``train.train_step``, with
   the example config's training settings (v-prediction, zero-SNR,
   BOS/EOS-stripped concat of 3 windows, both models' Lion state 8-bit at
   bs 16 with the example exclusion lists, EMA 0.99998, bucket limit 65536,
   exact compander), bf16, 512x512, batch 8, a synthetic batch from a seed:
   2 warm-up steps, then 5 timed steps with the launch counts zeroed just
   before and read just after (K1 5 + 1 on the narrow and wide tensor-core
   kernels, the fused bf16 backward 5, the
   f32 one and the CUDA-core K2 and K3 none, Lion's leaf-table entry
   twice (one launch per model) and its single- and multi-leaf entries
   never, per step, and no grad copied before Lion). Then one step under
   torch.profiler (``profile`` line, with device ms by
   ``utils.kernel_trace`` category). Then, on the same state, the step at
   the example config's 832x832 and 1088x1088 buckets (``train_bucket``
   lines: 2 warm-up and 3 timed steps each, p50, images/s, peak memory,
   launches by route and shape): per step K1 5 on the narrow kernel at
   level 0 (heads of 40), 5 on the wide one at level 1 (heads of 80) and
   once in the VAE encode, the fused backward 5 at level 0 and the
   wide-head fused backward 5 at level 1, the CUDA-core pair and the f32
   backward never; without gradient checkpointing, as the example config
   trains.
11. ``trace_audit``: the same bf16 step once more under torch.profiler with
   the host's ops and their shapes (``record_shapes``), its Chrome trace
   read with the package (``utils.kernel_trace``, ``utils.roofline``): the
   category report and the 12 ops with the most device time, each with its
   roofline share, on lines before the phase's own; the idle share beside
   that of ``train``'s device-only profile of the same step (the gap is
   what tracing the host costs). Fails unless (a) the trace's named
   launches, each around the flash or Lion kernels it started, are the
   launches the wrappers counted in that step, and no such kernel lies
   outside one, (b) the reader's device ms by kernel name are
   ``key_averages()``'s within 1% on a small profile recorded the same way,
   (c) no op's and no category's roofline share is above 1, (d) the trace's
   flash and Lion bounds are the launches times the ``kernels`` phase's
   bounds at those shapes. Needs ``train`` before it; the trace is gzipped
   into ``chiprun_out/``.
12. ``train_f32``: the same step with ``mixed_precision: "float32"`` (TF32
   off), the fidelity configuration: 2 warm-up steps, then 3 timed (K1 5 +
   1 on the f32 route, none on the older CUDA-core forward; the fused f32
   backward 5, the bf16 one and the CUDA-core pair
   none, Lion as above with f32 grads), step p50, images/s, peak memory, then
   one step under torch.profiler (``profile`` line: the backward's device
   time, the idle share). f32 dQ repeats bitwise; bf16 dQ does not.
13. ``trainer``: the port's trainer through ``trainer.main``, the body of
   ``python -m stable_diffusion_training_tpu_torch.training``, with the same
   settings (SD1.5 ``sd15`` seeded weights, bf16, 512x512, batch 8) on
   ``InMemoryDataLoader.synthetic`` batches, in a run directory under
   ``.cache/`` that is deleted at the end: one chunk of 3 steps, then a
   second invocation on the mutated JSON that resumes from the chunk's
   ``train_state/``. Checks: the JSON fields and its backup, ``loss.csv``,
   the save probe deleted, rotation, the EMA checkpoints, the chunk
   checkpoint reloaded by the port's loader equal to the saved state's
   params cast to f32, the restored momentum equal to the saved one, and
   every kernel of the train step launched. Prints the step p50 inside the
   trainer beside the ``train`` phase's, seconds per ``save_model`` and per
   ``save_train_state``, bytes written and peak disk use.
14. ``sdxl_train_parity``: one SDXL train step's loss and grads (the step's
   own loss function) at full width in f32 (TF32 off), batch 1, 128x128
   cached moments, a 227-token 2048-wide context, pooled 1280 and 6 time
   ids, the draws injected: "auto" against "xla" (a model holding the same
   tensors) within ``train_parity``'s bounds, the add-embedding's grads
   non-zero; K1 and the fused f32 backward exactly 10 times each at (10,
   4096, 64).
15. ``sdxl_train``: SDXL training (BASELINE config 5). The offline pass
   first: ``precompute_latent_cache`` over three shards of 4 synthetic
   images (1024x1024, 1152x896, 1024x1024) with seeded bf16 towers 1 and 2
   and the SDXL VAE (ms per image; K1 once per image at the mid-block's
   (1, 16384, 512) or (1, 16128, 512)). Then the bf16 step through
   ``on_device_model_training_state`` and ``train.aot``'s bucketed steps
   with the example settings, batch 4, gradient checkpointing and the
   frozen towers' context: 2 warm-up and 5 timed steps at 1024x1024 and 2
   at 1152x896, each window's launches checked by route and shape (K1 20 a
   step, each of the 64x64 level's 10 again in the recompute; the fused
   bf16 backward 10; Lion's leaf table once per 1,024 leaves; nothing
   else) and its grad copies against the quantized leaves autograd hands
   over strided; finite losses, codes and the add-embedding moving; one
   step's Lion update against its plain version; the optimizer chain's
   host ms; one step profiled.
16. ``sdxl_trainer``: one ``trainer.main`` chunk over ``sdxl_train``'s
   cache (3 steps) with its checkpoint: ``loss.csv``, the JSON, the probe,
   the chunk's ``unet/`` and its EMA variant reloaded through ``hf_io``
   equal to the saved state, that state restored, the step's kernels
   launched; seconds per save, bytes, peak disk. The run directory and the
   cache are deleted at the end.
17. ``sd21_parity``: SD2.1's UNet at full width (linear projections, heads
   of 64 at every level, a 1024-wide context) in f32 (TF32 off), batch 1,
   96x96 latents: the forward, then one train step's loss and grads (the
   step's own loss: cached moments, a 227-token context, v-prediction,
   zero-SNR, the draws injected), "auto" against "xla" within the
   ``parity`` and ``train_parity`` bounds; K1 5 times at (5, 9216, 64) and 5
   at (10, 2304, 64) a forward (the 48x48 level is the first second level
   any path sends to flash), the fused f32 backward the same.
18. ``sd21``: SD2.1 text-to-image at full width in bf16 (OpenCLIP ViT-H,
   23 layers, exact-erf gelu), seeded weights, 768x768, CFG batch 2, 4
   v-prediction DDIM steps, timed and checked as ``slice`` is: K1 5 times a
   step at (10, 9216, 64), 5 at (20, 2304, 64), once at (1, 9216, 512).
19. ``sd21_trainer``: ``trainer.main(path, dataloader=None, tokenizer=
   StubTokenizer())``: the trainer builds the streaming ``DataLoader`` from
   the config and reads a chunk of 64 seeded PNGs (32 at 768x768, 32 at the
   896x640 bucket, whose 8,960- and 2,240-key levels are off the tiles)
   and their CSV from the ramdisk; SD2.1 at full width, the example recipe,
   bf16, batch 8, 8 steps, DDIM eval sampling every 2 steps at 768x768 (4
   steps) and the profiler trace of the first 2 steps (gzipped into
   ``chiprun_out/sd21_trace/``). Prints each step's ms and bucket, the p50
   per bucket, the loader's wait, each eval's ms, the trace's size, top
   device ops, device ms by category and idle share (``utils.kernel_trace``),
   the saves, peak memory. Checks: finite losses, ``loss.csv``,
   the eval images and PNGs, the trace, the checkpoint and JSON; each
   step's launches by shape (K1 5 + 5 + the VAE encode's 1, the fused bf16
   backward 5 + 5, Lion's leaf table once per model, nothing else), each
   eval's (K1 5 + 5 a DDIM step and the decode's 1), and no launch outside
   the steps and evals (the loader's threads launch nothing).
20. ``ddp_parity``: data parallelism's step against one process. Two
   ranks, each a process of its own (``spawn``) on cuda:0, joined over
   gloo by ``core.initialize_distributed`` (NCCL takes one rank per card);
   SD1.5 at full width in f32 (TF32 off), the example recipe, a global
   batch of 2 at 512x512 with fixed global draws. Rank 0 first takes the
   step as one process over both rows; then each rank takes it on its row
   (``train_step(..., mesh=...)``: the loss scaled by 1/2, the grads summed
   in flat buckets). Checks: the ranks' params, EMA, codes and scales
   bitwise equal (sha256 of every state tensor); the loss within 1e-5 of
   the one-process step's, and params, update signs, codes and scales
   within ``tests/test_torch_port_train_step.py``'s bounds, codes more
   than one apart only at |code| <= 31 (1e-3 of a block's absmax: at full
   width the one-process step, run twice, breaks that module's |code| 10
   against itself on the card); each rank's
   launches at its shapes (K1 5 at (8, 4096, 40) and once at (1, 4096,
   512) on the f32 route, the fused f32 backward 5, Lion's leaf table once
   per model, nothing else). Prints each rank's step ms, the all-reduce's
   ms (host clock, the card synchronized around it) and peak memory.
21. ``ddp_trainer``: ``trainer.main(path, dataloader=None, tokenizer=
   StubTokenizer())`` on two ranks (gloo, cuda:0; BASELINE config 2's
   data-parallel layout on one card): SD1.5 at full width in bf16, the
   example recipe, global batch 8 (4 a rank), a chunk of 16 seeded 512x512
   PNGs (2 steps), DDIM eval every 2 steps (2 steps); beside them, 2 steps
   of ``trainer.main`` in a one-rank NCCL world that the trainer starts
   from torchrun's variables. Checks: one ``loss.csv`` (a header, rank 0's 2
   rows), one checkpoint, rank 0 alone writing the JSON,
   the probe, the checkpoints and the eval PNGs (rank 1 none), the ranks'
   states bitwise equal at the chunk checkpoint, each rank's pixel rows
   its half of a one-process loader's batch (sha256), each step's launches
   at the rank's shapes (K1 5 at (32, 4096, 40) and once at (4, 4096, 512),
   the fused bf16 backward 5, Lion's table once per model), rank 0's evals'
   besides and nothing else; the NCCL leg's backend, rows and launches.
   Prints per rank the step p50, global images/s, the all-reduce's ms a
   step and peak memory: two ranks share one card (their all-reduce is
   copies between buffers they map, ``_CardExchange``), so these describe
   the check, not scaling. Run
   directory ``.cache/chip_smoke_ddp/``, deleted at the end.
22. ``fsdp_parity``: FSDP's step against one process. Two gloo ranks on
   cuda:0 as in ``ddp_parity``, SD1.5 at full width in f32 (TF32 off), a
   global batch of 2 with fixed global draws; rank 0 first takes the step
   as one process, then both take it on their row with the UNet and the
   text encoder sharded over a ``[1, 2, 1]`` mesh's fsdp axis
   (``fsdp_shard_params``; FSDP2's all-gathers and reduce-scatters are
   copies between the ranks' mapped buffers, gloo barriers around them).
   Checks: the ranks' gathered params, EMA,
   codes and scales bitwise equal; rank 0's against the one-process step
   within ``ddp_parity``'s bounds and code-noise rule; each rank's local
   codes and scales its slices of the gathered ones; the leaves kept whole
   those of the co-sharding rule (none in the example config); no grad
   copied before Lion; launches by shape (K1 5 + 1 f32, the fused f32
   backward 5, Lion's leaf table once per model over the rank's local
   leaves). Prints each rank's step ms, the ms in FSDP2's all-gathers and
   reduce-scatters (host clock, the card synchronized around each) and
   peak memory.
23. ``fsdp_trainer``: ``trainer.main`` on the SDXL UNet at full width
   (BASELINE config 4, config 5's recipe: bf16, gradient checkpointing,
   frozen cached towers, the offline cache; ``sdxl_train``'s cache, made
   here if that phase did not run) on two gloo ranks of cuda:0, a ``[1,
   2, 1]`` mesh with ``fsdp_shard_params``, global batch 4 (2 a rank),
   one chunk of 2 steps (1024x1024, 1152x896) with its
   checkpoint; then a one-rank NCCL world (torchrun's variables, a ``[1, 1,
   1]`` mesh, FSDP2 on one rank) that resumes from that checkpoint and
   trains 2 steps of the step table (no second SDXL
   checkpoint beside the first). Checks: finite ``loss.csv`` rows, the
   JSON, the checkpoint, rank 0 alone writing, the ranks' losses equal,
   each step's launches at the rank's shapes (K1 20 a step at ``(20,
   4096, 64)`` or ``(20, 4032, 64)``, the fused bf16 backward 10, Lion's
   leaf table once over the rank's half of the UNet), no grad copied
   before Lion, the checkpoint read back whole by the NCCL leg equal, in
   each gloo rank's slices, to that rank's shards at the save
   (fingerprints of every param, EMA, code and scale), the NCCL leg's
   backend, rows and launches. Prints per rank the step p50, the ms a step
   in FSDP2's all-gathers and reduce-scatters and peak memory; two ranks
   share the card, so these describe the check, not sharded scaling. Run directory ``.cache/chip_smoke_fsdp/``,
   deleted at the end.
24. ``tp_parity``: the SD1.5 train step at full width in f32 (TF32 off)
   on one row, as one process (rank 0 first), then on two gloo ranks of
   cuda:0 on a ``[1, 1, 2]`` mesh with ``tensor_parallel_shard_params``
   (the attention and CLIP projections split over the two ranks, each
   running 4 of the 8 heads). Checks: rank 0's step against the one
   process within ``ddp_parity``'s bounds, every rank's local codes and
   scales its slice of the gathered ones, the step's sums over the axis
   (``sd15_tp_sums``), each rank's launches at its shapes, and K1 f32 and
   the fused f32 backward held against their plain versions at the rank's
   ``(4, 4096, 40)``.
25. ``tp_trainer``: ``trainer.main`` on SD1.5 at full width, bf16, global
   batch 8 on the same two ranks and mesh: one chunk of 2 steps, its
   checkpoint and one eval on every rank (rank 0 writing); then a one-rank
   NCCL world on ``[1, 1, 1]`` that reads the checkpoint back whole and
   steps once. Checks: the writers, the JSON, the rows, each step's sums
   and launches, the two ranks' whole leaves alike and the checkpoint equal
   to each rank's UNet and text encoder slices (fingerprints), the NCCL
   leg's loss, launches and sums (none). Run directory
   ``.cache/chip_smoke_tp/``, deleted at the end.
26. ``tp_fsdp_parity``: the SD1.5 train step at full width in f32 (TF32
   off) over a global batch of 2, as one process (rank 0 first; the
   reference kept in host memory), then on four gloo ranks of cuda:0 on a
   ``[1, 2, 2]`` mesh with ``tensor_parallel_shard_params`` and
   ``fsdp_shard_params``: each fsdp rank one row, each model_parallel rank
   4 of the 8 heads, every leaf sharded over the fsdp pair. Checks:
   ``tp_parity``'s, the four gathered states bitwise equal, the leaves kept
   whole those of the composed rule, FSDP2's collectives run; K1 f32 and
   the fused f32 backward held against their plain versions at the rank's
   ``(4, 4096, 40)``.
27. ``tp_fsdp_trainer``: ``trainer.main`` on SD1.5 at full width, bf16,
   global batch 8 on the same four ranks and mesh (4 rows an fsdp rank):
   one chunk of 2 steps, its checkpoint and one eval on every rank; then a
   one-rank NCCL world on ``[1, 1, 1]`` with both flags that reads the
   checkpoint back whole and steps once. Checks: ``tp_trainer``'s, each
   step's FSDP2 collectives, each model_parallel pair's shards of the whole
   leaves alike, the checkpoint equal to every rank's parts. Prints per
   rank the step p50, the TP sums' and FSDP2's collectives' ms a step and
   peak memory. Run directory ``.cache/chip_smoke_tp_fsdp/``, deleted at the
   end.
28. ``vae_polyphase``: the SD1.5 VAE encode at 512x512, batch 8, in bf16
   and f32 (TF32 off), the encoder with ``polyphase_downsample`` against the
   stride-2 form holding the same weights: the moments' max error (f32
   within 1e-4 of the largest |mean|; bf16 no further off the f32 stride-2
   encode than twice the bf16 stride-2 form), each form's device ms, K1
   once per polyphase encode at ``(8, 4096, 512)``.

Any failed check raises, so the script exits non-zero and prints no result;
a rank that exits non-zero fails its phase. The ranks' launches are
summed into the ``kernels`` record.
Before the last line it prints the ``kernels`` record (every kernel and
shape with its launches on the main path and its times) and the card's
nvidia-smi line; the last line is ``{"ok": true, "device": {...}}``. The
phase lines and the ``kernels`` record also go, whole, to
``chiprun_out/chip_smoke.jsonl``.
"""

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "stable_diffusion_training_tpu_torch"
CSRC = f"{PACKAGE}/csrc"
JAX_OPS = "stable_diffusion_training_tpu/ops"
ALL_PHASES = (
    "gpu", "build", "kernels", "parity", "slice", "sdxl_parity", "sdxl", "sdxl_refiner", "train_parity", "train",
    "trace_audit", "train_f32", "trainer", "sdxl_train_parity", "sdxl_train", "sdxl_trainer", "sd21_parity", "sd21",
    "sd21_trainer", "ddp_parity", "ddp_trainer", "fsdp_parity", "fsdp_trainer", "tp_parity", "tp_trainer",
    "tp_fsdp_parity", "tp_fsdp_trainer", "vae_polyphase",
)
# the phases that start ranks or one-rank legs
RANK_PHASES = ("ddp_parity", "ddp_trainer", "fsdp_parity", "fsdp_trainer", "tp_parity", "tp_trainer",
               "tp_fsdp_parity", "tp_fsdp_trainer")
# the phases whose runs give the kernels line its launches
PATH_PHASES = {
    "kernels", "parity", "slice", "sdxl_parity", "sdxl", "sdxl_refiner", "train_parity", "train", "train_f32",
    "sdxl_train_parity", "sdxl_train", "sd21_parity", "sd21", "sd21_trainer", "ddp_parity", "ddp_trainer",
    "fsdp_parity", "fsdp_trainer", "tp_parity", "tp_trainer", "tp_fsdp_parity", "tp_fsdp_trainer", "vae_polyphase",
}

# Kernel vs plain version, max abs error. f32: both sum exact f32 products
# in different orders and use different exp implementations (~1e-6 seen on
# O ~ 0.1, lse ~ 9), so 1e-4 leaves room without hiding a wrong tile. bf16: O
# is rounded to bf16 (half an ulp is 2^-9 relative) and the kernel rounds the
# unnormalised P to bf16 where the plain version rounds the normalised P, so
# O may differ by a few bf16 ulps of |O| <= 1: 1e-2; lse stays f32 (1e-3).
TOLERANCE = {
    "float32": {"o": 1e-4, "lse": 1e-4},
    "bfloat16": {"o": 1e-2, "lse": 1e-3},
}
# backward kernels vs plain backward, both computed the same way but summed
# in other orders. Max abs error over the tensor's max |grad|: f32 as the
# forward's O; bf16: dQ/dK/dV come back in bf16, where an ulp is at most
# 2^-7 = 7.8e-3 relative, so one ulp of any element passes and two of the
# largest may not. Relative Frobenius error, ||got - want|| / ||want||: an
# element that rounds the other way moves by one ulp, so bf16's norm stays
# under half an ulp (2^-8 = 3.9e-3); f32 ~100x the max error seen.
BWD_TOLERANCE = {"float32": 1e-4, "bfloat16": 1e-2}
BWD_FRO_TOLERANCE = {"float32": 1e-5, "bfloat16": 3.9e-3}
# full-width f32 UNet, kernel vs plain attention: max |diff| / max |ref|.
# Only the attention's summation order differs; 1e-4 relative is ~1000 f32
# ulps of headroom through 16 transformer blocks and 22 resnets.
PARITY_REL_TOL = 1e-4
# train_parity: the loss (a mean of 32 K squares) to 1e-5 relative; each
# grad to 1e-4 of its tensor's max |grad| (the backward sums the same
# products in other orders through 16 transformer blocks and 22 resnets)
TRAIN_LOSS_REL_TOL = 1e-5
TRAIN_GRAD_REL_TOL = 1e-4
# train_parity in bf16: each route's grads against the f32 plain grads
# (relative Frobenius error per tensor). Both routes round the same bf16
# weights and activations, so most of their error is shared; the kernels'
# may be at most twice the plain route's (a floor of 1e-2 for tensors the
# plain route gets nearly exact). A wrong dQ, dK or dV gives ~1 on the
# attention weights it feeds.
BF16_GRAD_ERR_RATIO, BF16_GRAD_ERR_FLOOR = 2.0, 1e-2
# the example config (model_properties_example.json): what the train phase runs
EXAMPLE_EXCLUDED_FROM_QUANTIZATION = [
    "bias", "scale", "embedding", "conv_in", "conv_out", "time_embedding", "embeddings",
    "time_emb_proj",
]
TRAIN_BATCH, TRAIN_RES, TRAIN_CONCAT = 8, 512, 3
LION_BS, BUCKET_MAX_NB = 16, 65536


RECORD = os.path.join(REPO, "chiprun_out", "chip_smoke.jsonl")  # every phase line, in full
# the flash-attention kernels built on TMA and wgmma (names as in csrc/)
HOPPER_KERNELS = ("flash_fwd_tma_kernel", "flash_bwd_fused_kernel", "flash_bwd_fused_wide_kernel")
# the f32 kernels (CUDA cores, cp.async): the fused backward and the
# forward's two; each built, and spilling nothing
F32_KERNELS = ("flash_bwd_f32_fused_kernel", "flash_fwd_f32_narrow_kernel", "flash_fwd_f32_wide_kernel")


_T0 = time.perf_counter()


def emit(phase, **fields):
    """A phase line on stdout and, with ``at_s`` (the script's seconds so
    far, so that the record shows where the time went), in ``RECORD``."""
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    with open(RECORD, "a") as f:
        f.write(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - _T0}) + "\n")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2, host=None):
    """Device ms per call of ``fn``: CUDA events around ``reps`` calls that
    are queued behind a spin kernel outlasting the host's queueing, so the
    host's own time per call (Python, ctypes, table building) is not
    counted. ``host``, a list, gets the host's ms per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host is not None:
        host.append(queue_ms / reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * queue_ms + 5) * spin_cycles_per_ms()))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_SPIN = {}


def spin_cycles_per_ms():
    """Cycles of ``torch.cuda._sleep`` per ms on this card, measured once."""
    import torch

    if not _SPIN:
        cycles = 20_000_000
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SPIN["cycles"] = cycles / start.elapsed_time(end)
    return _SPIN["cycles"]


def host_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def set_tf32(enabled):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def phase_gpu(state):
    import torch

    smi = nvidia_smi_line()
    state["smi"] = smi
    emit(
        "gpu",
        nvidia_smi=smi,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        capability=list(torch.cuda.get_device_capability(0)),
    )


def phase_build(state):
    """Builds every kernel library (after planting a stale directory of
    the forward's library, which the build must purge, keeping every
    library's own); prints the toolchain key's parts; reads back, from the ptxas report and
    the built code, what each kernel became: registers and spill bytes of
    every kernel, and for each flash-attention Hopper kernel (the forward's
    and the fused backward) its count of wgmma (``HGMMA``) and TMA load
    (``UTMALDG``) instructions. Those kernels must be built, use both and
    spill nothing; the f32 kernels (``F32_KERNELS``) must be built and
    spill nothing."""
    from stable_diffusion_training_tpu_torch.ops import cuda_build, flash_attention, lion_kernel
    from stable_diffusion_training_tpu_torch.utils import hostcache

    libraries = {**flash_attention.LIBRARIES, **lion_kernel.LIBRARIES}
    toolchain = dict(key=cuda_build.toolchain_key(),
                     **hostcache.toolchain_parts(cuda_build.nvcc_path(), cuda_build.NVCC_FLAGS))
    # a stale build of the forward's library (another key): building it purges that
    fwd = "flash_attention_fwd"
    stale = os.path.join(cuda_build.BUILD_DIR, f"{fwd}-{'0' * hostcache.KEY_DIGITS}")
    planted = not os.path.exists(cuda_build.library_path(fwd, libraries[fwd]))
    if planted:
        os.makedirs(stale, exist_ok=True)
        open(os.path.join(stale, f"lib{fwd}.so"), "w").close()
    start = time.perf_counter()
    paths = cuda_build.build_many(libraries)
    seconds = time.perf_counter() - start
    purge = dict(
        planted=os.path.relpath(stale, REPO) if planted else None, stale_removed=not os.path.exists(stale),
        libraries_kept=all(os.path.isfile(p) for p in paths.values()),
        build_dirs=sorted(os.listdir(cuda_build.BUILD_DIR)),
    )
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    ptxas, kernels, advisories = {}, {}, []
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_build.log"), "w") as f:
        for name in paths:
            secs, log = cuda_build.BUILD_LOG.get(name, (0.0, "(already built)"))
            f.write(f"== {name} ({secs:.1f} s)\n{log}\n")
            spills = [ln.strip() for ln in log.splitlines() if "spill" in ln and "0 bytes spill" not in ln]
            ptxas[name] = dict(seconds=round(secs, 3), spilling_functions=len(spills))
            advisories += [ln.strip() for ln in log.splitlines() if "Performance" in ln or "serializ" in ln]
            for fn, props in ptxas_functions(log).items():
                kernels[fn] = dict(library=name, **props)
    for lib in ("flash_attention_fwd", "flash_attention_bwd"):
        for fn, counts in sass_counts(paths[lib], ("HGMMA", "UTMALDG")).items():
            kernels.setdefault(fn, dict(library=lib)).update(counts)
    names = demangle_all(kernels)
    kernels = {names[fn]: props for fn, props in kernels.items()}
    hopper = {n: k for n, k in kernels.items() if any(h in n for h in HOPPER_KERNELS)}
    f32 = {n: k for n, k in kernels.items() if any(h in n for h in F32_KERNELS)}
    emit(
        "build", seconds=round(seconds, 3),
        libraries={n: os.path.relpath(p, REPO) for n, p in paths.items()}, ptxas=ptxas,
        kernels=kernels, ptxas_advisories=advisories, toolchain=toolchain, stale_purge=purge,
    )
    if not (purge["stale_removed"] and purge["libraries_kept"]):
        raise AssertionError(f"the build cache's purge failed: {purge}")
    spills = lambda k: k.get("spill_stores", 1) or k.get("spill_loads", 1)
    bad = {n: k for n, k in hopper.items() if spills(k) or not k.get("HGMMA") or not k.get("UTMALDG")}
    bad.update({n: k for n, k in f32.items() if spills(k)})
    missing = [h for h in HOPPER_KERNELS + F32_KERNELS if not any(h in n for n in kernels)]
    if missing or bad:
        raise AssertionError(f"flash kernels missing {missing}, or spilling or lacking wgmma/TMA: {bad}")


def ptxas_functions(log):
    """{mangled kernel name: registers, stack, spill bytes} from a
    ``-Xptxas=-v`` report."""
    out, current = {}, None
    for line in log.splitlines():
        props = re.search(r"Function properties for (\S+)", line)
        spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if props:
            current = out.setdefault(props.group(1), {})
        elif current is not None and spills:
            current.update(zip(("stack_bytes", "spill_stores", "spill_loads"), map(int, spills.groups())))
        elif current is not None and regs:
            current["registers"] = int(regs.group(1))
    return out


def sass_counts(lib, opcodes):
    """For each flash-attention Hopper kernel in the built library (a name
    holding one of ``HOPPER_KERNELS``), how many of its SASS instructions
    start with each of ``opcodes`` (``cuobjdump -sass``)."""
    from stable_diffusion_training_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, timeout=300, check=True).stdout
    counts, current = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = name if any(h in name for h in HOPPER_KERNELS) else None
            if current:
                counts[current] = dict.fromkeys(opcodes, 0)
        elif current and "*/" in line:
            op = line.split("*/", 1)[1].split()
            op = op[1] if op and op[0].startswith("@") and len(op) > 1 else (op[0] if op else "")
            for code in opcodes:
                counts[current][code] += op.startswith(code)
    return counts


def demangle_all(names):
    """{mangled: the kernel's name and template arguments} (``cu++filt``;
    the mangled name where that fails)."""
    from stable_diffusion_training_tpu_torch.ops import cuda_build

    names = list(names)
    filt = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cu++filt")
    try:
        plain = subprocess.run([filt, *names], capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {n: n for n in names}
    out = {}
    for name, line in zip(names, plain.splitlines()):
        line = line.strip()
        if line.endswith(")"):  # drop the parameter list: the last top-level (...)
            depth, i = 0, len(line)
            for i in range(len(line) - 1, -1, -1):
                depth += {")": 1, "(": -1}.get(line[i], 0)
                if depth == 0:
                    break
            line = line[:i]
        for junk in ("void ", "(anonymous namespace)::", "<unnamed>::", "(int)", "(bool)"):
            line = line.replace(junk, "")
        out[name] = line.strip() or name
    return out


PLAIN_SCORE_BYTES = 8e9  # the plain attention's f32 scores above this run a slice of heads at a time


def plain_by_heads(fn, *args):
    """``fn`` (a plain attention version over ``(BH, S, ...)`` tensors and
    a scale) on slices of the heads, its outputs joined: heads are
    independent, and the f32 scores of SD2.1's 9,216-key level at train
    batch 8 (40 heads, 13.6 GB) would otherwise be held three to four times."""
    import torch

    q, k = args[0], args[1]
    per = max(1, int(PLAIN_SCORE_BYTES // (4 * q.shape[1] * k.shape[1])))
    if per >= q.shape[0]:
        return fn(*args)
    parts = [fn(*(a[i:i + per] if torch.is_tensor(a) else a for a in args)) for i in range(0, q.shape[0], per)]
    return tuple(torch.cat(outs) for outs in zip(*parts))


def fwd_l2_bytes(bh, sq, sk, d, dtype_name, route):
    """Bytes that K1 moves from L2 into the SMs in one call: every block
    streams its head's whole K and V, so query blocks x K+V bytes of a head.
    Query rows a block as in csrc/flash_attention_fwd.cu (TmaTile and
    F32NarrowTile: 256 at D <= 64; F32WideTile and the wide TmaTile: 64
    above); None on the older CUDA-core route."""
    if route == "cuda_cores":
        return None
    rows = 256 if d <= 64 else 64
    return -(-sq // rows) * bh * 2 * sk * d * (2 if dtype_name == "bfloat16" else 4)


def phase_kernels(state):
    import torch
    import torch.nn.functional as F

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.utils import roofline

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    both = ("bfloat16", "float32")
    cases = [
        ("unet_l0", 16, 4096, 4096, 40, both),  # serving: 64x64 self-attention, CFG batch 2
        ("vae_mid", 1, 4096, 4096, 512, both),  # serving: VAE decode mid-block
        ("unet_train", 64, 4096, 4096, 40, both),  # train: 64x64 self-attention, batch 8
        ("vae_encode", 8, 4096, 4096, 512, both),  # train: VAE encode mid-block
        ("ragged", 4, 3000, 2100, 64, both),
        ("ragged_d36", 2, 1000, 777, 36, both),  # bf16 off the tensor-core path
        # query and key counts that are no multiple of either Hopper kernel's tiles
        ("ragged_d40", 3, 4000, 3900, 40, both),
        ("ragged_d512", 2, 1000, 4100, 512, both),
        ("sdxl_unet_l1", 20, 4096, 4096, 64, both),  # SDXL: 64x64 self-attention, CFG batch 2; f32 in sdxl_parity
        ("sdxl_refiner_l1", 24, 4096, 4096, 64, ("bfloat16",)),  # the refiner's
        ("sdxl_vae_mid", 1, 16384, 16384, 512, ("bfloat16",)),  # the VAE mid-block at 1024x1024
        # SDXL training: the 64x64 level at batch 4, the 1152x896 bucket's 72x56
        # level, sdxl_train_parity's batch 1 in f32, the cache pass's encode of
        # a 1152x896 image (144x112 latents)
        ("sdxl_train_l1", 40, 4096, 4096, 64, ("bfloat16",)),
        ("sdxl_train_bucket_l1", 40, 4032, 4032, 64, ("bfloat16",)),
        ("sdxl_train_parity_l1", 10, 4096, 4096, 64, ("float32",)),
        ("sdxl_vae_mid_bucket", 1, 16128, 16128, 512, ("bfloat16",)),
        # SD2.1 at 768x768 (96x96 latents): the 96x96 level (5 heads of 64)
        # and the 48x48 level (10 heads) at train batch 8, the 896x640
        # bucket's 112x80 and 56x40 levels, serving's and eval's CFG batch 2,
        # the VAE mid-block (encode at batch 8, decode at 1), sd21_parity's f32
        ("sd21_train_l1", 40, 9216, 9216, 64, ("bfloat16",)),
        ("sd21_train_l2", 80, 2304, 2304, 64, ("bfloat16",)),
        ("sd21_train_bucket_l1", 40, 8960, 8960, 64, ("bfloat16",)),
        ("sd21_train_bucket_l2", 80, 2240, 2240, 64, ("bfloat16",)),
        ("sd21_unet_l1", 10, 9216, 9216, 64, ("bfloat16",)),
        ("sd21_unet_l2", 20, 2304, 2304, 64, ("bfloat16",)),
        ("sd21_vae_encode", 8, 9216, 9216, 512, ("bfloat16",)),
        ("sd21_vae_encode_bucket", 8, 8960, 8960, 512, ("bfloat16",)),
        ("sd21_vae_mid", 1, 9216, 9216, 512, ("bfloat16",)),
        ("sd21_parity_l1", 5, 9216, 9216, 64, ("float32",)),
        ("sd21_parity_l2", 10, 2304, 2304, 64, ("float32",)),
        # data parallelism, each rank's shapes: ddp_trainer's batch 4 a rank
        # (the 64x64 level, the VAE encode's mid-block), ddp_parity's f32
        # batch 1 a rank (its VAE encode is vae_mid's f32 shape)
        ("ddp_unet_train", 32, 4096, 4096, 40, ("bfloat16",)),
        ("ddp_vae_encode", 4, 4096, 4096, 512, ("bfloat16",)),
        ("ddp_parity_unet", 8, 4096, 4096, 40, ("float32",)),
        # FSDP: fsdp_trainer's 2 SDXL rows a rank (the 64x64 level is
        # sdxl_unet_l1's bf16 shape; the 1152x896 bucket's 72x56 level here;
        # its one-rank NCCL leg runs sdxl_train's), fsdp_parity's f32 row a
        # rank (ddp_parity_unet's and vae_mid's shapes)
        ("fsdp_sdxl_train_bucket_l1", 20, 4032, 4032, 64, ("bfloat16",)),
        # tensor parallelism, each rank's 4 of the 8 heads: tp_parity's f32
        # row (its VAE encode is vae_mid's f32 shape) and tp_trainer's eval
        # at CFG batch 2 (its 8 rows are ddp_unet_train's and vae_encode's
        # bf16 shapes, the eval's decode vae_mid's)
        ("tp_parity_unet", 4, 4096, 4096, 40, ("float32",)),
        ("tp_eval_unet", 8, 4096, 4096, 40, ("bfloat16",)),
        # SD1.5's 640-channel level (8 heads of 80) at the example config's
        # buckets 832x832 and 1088x1088, train batch 8 (train's bucket steps)
        ("sd15_bucket_832_l1", 64, 2704, 2704, 80, ("bfloat16",)),
        ("sd15_bucket_1088_l1", 64, 4624, 4624, 80, ("bfloat16",)),
    ]
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        name_dt = str(dtype).replace("torch.", "")
        tol = TOLERANCE[name_dt]
        for name, bh, sq, sk, d, dtypes in cases:
            if name_dt not in dtypes:
                continue
            q = torch.randn(bh, sq, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(bh, sk, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(bh, sk, d, generator=gen, device="cuda").to(dtype)
            scale = d**-0.5
            route = fa.forward_route(q, k, v)
            fa.reset_launch_counts()
            o, lse = fa.flash_attention_fwd(q, k, v, scale)
            again = fa.flash_attention_fwd(q, k, v, scale)
            torch.cuda.synchronize()
            by_route = dict(fa.flash_attention_fwd.launches_by_route)
            o_ref, lse_ref = plain_by_heads(fa.flash_attention_fwd_reference, q, k, v, scale)
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            # the f32 kernels sum in fixed orders: a repeat is bitwise equal
            repeats = bool(torch.equal(o, again[0]) and torch.equal(lse, again[1]))
            del again
            ok = (
                err_o <= tol["o"] and err_lse <= tol["lse"] and by_route == {route: 2}
                and (repeats or route != "f32")
            )
            reps = 20 if d <= 64 else 5
            host = []
            kernel_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, scale), reps, host=host)
            # the plain version, 10-100x slower, needs fewer calls to time
            plain_ms = cuda_ms(lambda: plain_by_heads(fa.flash_attention_fwd_reference, q, k, v, scale), 3, warmup=1)
            cuda_cores = {}
            if name_dt == "float32" and not name.startswith("ragged"):
                # the kernel the f32 route replaced, on the same inputs
                o_cc, lse_cc = fa.flash_attention_fwd_cuda_cores(q, k, v, scale)
                cuda_cores = dict(
                    cuda_cores_ms=cuda_ms(lambda: fa.flash_attention_fwd_cuda_cores(q, k, v, scale), reps),
                    cuda_cores_max_abs_err_o=(o_cc - o_ref).abs().max().item(),
                    cuda_cores_max_abs_err_lse=(lse_cc - lse_ref).abs().max().item(),
                )
                ok = ok and cuda_cores["cuda_cores_max_abs_err_o"] <= tol["o"]
                ok = ok and cuda_cores["cuda_cores_max_abs_err_lse"] <= tol["lse"]
                del o_cc, lse_cc
            try:  # as (1, B*H, S, D), the 4-D layout its fused backends take
                library_ms = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale),
                    reps,
                )
            except RuntimeError:  # no SDPA backend takes this shape/dtype
                library_ms = None
            bound_ms, bound_by, flops = roofline.attention_bound(bh, sq, sk, d, name_dt, reads_q=1, writes_q=1)
            row = dict(
                case=name, shape_q=[bh, sq, d], shape_k=[bh, sk, d], dtype=name_dt, route=route,
                launches_by_route=by_route, repeats_bitwise=repeats,
                max_abs_err_o=err_o, max_abs_err_lse=err_lse, tol_o=tol["o"],
                tol_lse=tol["lse"], ok=ok, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                kernel_tflops=flops / kernel_ms / 1e9, host_ms_per_call=host[0],
                l2_to_sm_bytes=fwd_l2_bytes(bh, sq, sk, d, name_dt, route), **cuda_cores,
            )
            results.append(row)
            emit("kernels", **row)
            del q, k, v, o, lse, o_ref, lse_ref
            torch.cuda.empty_cache()
    state["kernel_cases"] = results
    state["bwd_cases"] = flash_backward_cases()
    state["lion_cases"] = lion_cases()
    state["lion_fused_cases"] = lion_fused_cases()
    state["lion_model_cases"] = lion_model_cases()
    bad = [
        r for r in results + state["bwd_cases"] + state["lion_cases"] + state["lion_fused_cases"]
        + state["lion_model_cases"] if not r["ok"]
    ]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


# launches of one flash_attention_bwd call, by route (fa.backward_route)
BWD_ROUTE_LAUNCHES = {
    "fused": dict(bwd_fused=1, bwd_fused_wide=0, bwd_f32=0, bwd_dq=0, bwd_dkv=0),
    "fused_wide": dict(bwd_fused=0, bwd_fused_wide=1, bwd_f32=0, bwd_dq=0, bwd_dkv=0),
    "f32_fused": dict(bwd_fused=0, bwd_fused_wide=0, bwd_f32=1, bwd_dq=0, bwd_dkv=0),
    "cuda_cores": dict(bwd_fused=0, bwd_fused_wide=0, bwd_f32=0, bwd_dq=1, bwd_dkv=1),
}


def bwd_launches(fa):
    return dict(bwd_fused=fa.flash_attention_bwd_fused.launches,
                bwd_fused_wide=fa.flash_attention_bwd_fused_wide.launches,
                bwd_f32=fa.flash_attention_bwd_f32_fused.launches,
                bwd_dq=fa.flash_attention_bwd_dq.launches, bwd_dkv=fa.flash_attention_bwd_dkv.launches)


def flash_backward_cases():
    """The backward against ``flash_attention_bwd_reference``, by route: the
    fused tensor-core kernel (bf16, D % 8 == 0, D <= 64), the fused f32
    kernel (f32, D % 4 == 0, D <= 64) or the CUDA-core K2 (dQ) and K3
    (dK/dV). Times the whole call (fused bf16: zeroing the dQ buffer, the
    kernel, the conversion; fused f32: the kernel and the dQ sum) and, from
    torch.profiler, each kernel in it; runs the call twice on the same
    inputs (dQ's sum over key blocks lands in another order each run on the
    bf16 route, in one order on the others). The library yardstick is SDPA's
    backward (timed only); at the train_parity f32 shape the CUDA-core pair
    is timed beside the fused f32 kernel on the same inputs."""
    import torch
    import torch.nn.functional as F

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.utils import roofline

    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = [
        ("unet_train", 64, 4096, 4096, 40, torch.bfloat16),
        ("ragged", 4, 3000, 2100, 64, torch.bfloat16),
        # query and key counts that are no multiple of the fused kernel's tiles
        ("ragged_d40", 3, 4000, 3900, 40, torch.bfloat16),
        ("ragged_d36", 2, 1000, 777, 36, torch.bfloat16),  # off both fused kernels: the CUDA-core pair
        ("unet_train_f32", 8, 4096, 4096, 40, torch.float32),  # the train_parity shape
        ("unet_train_f32_b8", 64, 4096, 4096, 40, torch.float32),  # the train_f32 shape
        ("ragged_f32", 4, 3000, 2100, 64, torch.float32),  # SD2.1/SDXL's head dim, counts off the tiles
        ("ragged_d40_f32", 3, 4000, 3900, 40, torch.float32),
        # SDXL training at D = 64: the 64x64 level at batch 4, the 1152x896
        # bucket's 72x56 level (4,032 rows, no multiple of the tiles), and
        # sdxl_train_parity's f32 batch 1
        ("sdxl_train", 40, 4096, 4096, 64, torch.bfloat16),
        ("sdxl_train_bucket", 40, 4032, 4032, 64, torch.bfloat16),
        ("sdxl_train_parity_f32", 10, 4096, 4096, 64, torch.float32),
        # SD2.1 training at 768x768, batch 8: the 96x96 and 48x48 levels, the
        # 896x640 bucket's (8,960 and 2,240 rows, no multiple of the tiles),
        # and sd21_parity's f32 batch 1
        ("sd21_train_l1", 40, 9216, 9216, 64, torch.bfloat16),
        ("sd21_train_l2", 80, 2304, 2304, 64, torch.bfloat16),
        ("sd21_train_bucket_l1", 40, 8960, 8960, 64, torch.bfloat16),
        ("sd21_train_bucket_l2", 80, 2240, 2240, 64, torch.bfloat16),
        ("sd21_parity_l1_f32", 5, 9216, 9216, 64, torch.float32),
        ("sd21_parity_l2_f32", 10, 2304, 2304, 64, torch.float32),
        # ddp_trainer's 64x64 level at batch 4 a rank (ddp_parity's f32 batch
        # 1 a rank is train_parity's shape, unet_train_f32)
        ("ddp_unet_train", 32, 4096, 4096, 40, torch.bfloat16),
        # fsdp_trainer's SDXL levels at 2 rows a rank (fsdp_parity's f32 row a
        # rank is train_parity's shape, unet_train_f32)
        ("fsdp_sdxl_train", 20, 4096, 4096, 64, torch.bfloat16),
        ("fsdp_sdxl_train_bucket", 20, 4032, 4032, 64, torch.bfloat16),
        # tp_fsdp_trainer's 4 rows an fsdp rank, 4 of the 8 heads a
        # model_parallel rank (tp_fsdp_parity's f32 row is tp_parity's shape)
        ("tp_fsdp_unet_train", 16, 4096, 4096, 40, torch.bfloat16),
        # tp_parity's f32 row, 4 of the 8 heads a rank (tp_trainer's 8 rows
        # are ddp_unet_train's shape)
        ("tp_parity_unet_f32", 4, 4096, 4096, 40, torch.float32),
        # SD1.5's 640-channel level (8 heads of 80) at the example config's
        # buckets 832x832 and 1088x1088, batch 8 (train's bucket steps): the
        # wide-head fused kernel, with the CUDA-core pair it replaced timed
        # on the same inputs; D = 96 and 128 with counts off its tiles
        ("sd15_bucket_832_l1", 64, 2704, 2704, 80, torch.bfloat16),
        ("sd15_bucket_1088_l1", 64, 4624, 4624, 80, torch.bfloat16),
        ("ragged_d96", 3, 1000, 1100, 96, torch.bfloat16),
        ("ragged_d128", 2, 1500, 1300, 128, torch.bfloat16),
    ]
    rows = []
    for name, bh, sq, sk, d, dtype in cases:
        name_dt = str(dtype).replace("torch.", "")
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype) for s in (sq, sk, sk))
        do = torch.randn(bh, sq, d, generator=gen, device="cuda").to(dtype)
        scale = d**-0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        delta = (do.float() * o.float()).sum(-1)
        route = fa.backward_route(q, k, v, do)
        fused = route in ("fused", "fused_wide")  # bf16: dQ's adds land in any order
        args = (q, k, v, do, lse, delta, scale)
        fa.reset_launch_counts()
        grads = fa.flash_attention_bwd(*args)
        again = fa.flash_attention_bwd(*args)
        torch.cuda.synchronize()
        launches = bwd_launches(fa)
        expected = plain_by_heads(fa.flash_attention_bwd_reference, *args)
        errs, fro_errs, max_grads = {}, {}, {}
        ok = launches == {k: 2 * n for k, n in BWD_ROUTE_LAUNCHES[route].items()}
        for gname, got, want in zip(("dq", "dk", "dv"), grads, expected):
            diff = got.float() - want.float()
            errs[gname] = diff.abs().max().item()
            max_grads[gname] = want.float().abs().max().item()
            fro_errs[gname] = (diff.norm() / want.float().norm()).item()
            ok = (
                ok and got.dtype == want.dtype
                and errs[gname] <= BWD_TOLERANCE[name_dt] * max_grads[gname]
                and fro_errs[gname] <= BWD_FRO_TOLERANCE[name_dt]
            )
            del diff
        # run to run: dK and dV are summed in one order; dQ's adds may land
        # in another on the bf16 fused route, and must not on the others
        repeat = dict(
            dq_max_abs_diff=(grads[0].float() - again[0].float()).abs().max().item(),
            dq_equal=bool(torch.equal(grads[0], again[0])),
            dk_equal=bool(torch.equal(grads[1], again[1])), dv_equal=bool(torch.equal(grads[2], again[2])),
        )
        ok = ok and repeat["dk_equal"] and repeat["dv_equal"] and (fused or repeat["dq_equal"])
        del grads, again, expected
        reps = 10 if d <= 128 else 3
        host = []
        call_ms = cuda_ms(lambda: fa.flash_attention_bwd(*args), reps, host=host)
        kernel_ms = profiled_kernel_ms(lambda: fa.flash_attention_bwd(*args), reps)
        plain_ms = cuda_ms(lambda: plain_by_heads(fa.flash_attention_bwd_reference, *args), 2, warmup=1)
        library_ms = None
        try:  # SDPA's backward on (1, B*H, S, D), the yardstick only
            leaves = [t[None].detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, scale=scale)
            library_ms = cuda_ms(
                lambda: torch.autograd.grad(out, leaves, do[None], retain_graph=True), reps
            )
            del out, leaves
        except RuntimeError:  # no SDPA backend takes this shape/dtype
            pass
        pair_ms = None
        if name == "unet_train_f32" or name.startswith("sd15_bucket"):  # the route it replaces, on the same inputs
            pair_ms = cuda_ms(
                lambda: (fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)), 3, warmup=1
            )
        # The function: dQ, dK and dV from q, k, v, dO, lse and delta, 5
        # products (S, dO V^T, P^T dO, dS^T Q, dS K) and the exps once; the
        # fused bf16 route also writes and reads its f32 dQ buffer, the
        # fused f32 route its dQ partials (one (bh, sq, d) f32 tensor per
        # block of keys). The CUDA-core route's own work, kernel by kernel:
        # K2 S, dO V^T, dS K (3 products) and the exps, writing dQ; K3 S,
        # dO V^T, P^T dO, dS^T Q (4 products) and the exps again, writing dK
        # and dV.
        n_parts = -(-sk // fa.F32_BWD_KEYS)
        f32_q = {"fused": 2, "fused_wide": 2, "f32_fused": 2 * n_parts, "cuda_cores": 0}[route]
        bound = roofline.attention_bound(bh, sq, sk, d, name_dt, products=5, writes_q=1, writes_k=2, stats=2,
                                         f32_q=f32_q)
        per_kernel = {}
        if route == "f32_fused":
            for kernel in ("flash_bwd_f32_fused_kernel", "flash_bwd_f32_dq_sum_kernel"):
                per_kernel[kernel] = dict(ms=sum(ms for n, ms in kernel_ms.items() if kernel in n))
        if route == "cuda_cores":
            for kernel, products, writes in (("dq", 3, dict(writes_q=1)), ("dkv", 4, dict(writes_k=2))):
                own = roofline.attention_bound(bh, sq, sk, d, name_dt, products=products, stats=2, **writes)
                per_kernel[kernel] = dict(
                    ms=sum(ms for n, ms in kernel_ms.items() if f"bwd_{kernel}_kernel" in n),
                    bound_ms=own[0], bound_by=own[1], flops=own[2],
                )
        ok = ok and all(k["ms"] > 0 for k in per_kernel.values())  # the profiler saw both kernels
        flops_run = bound[2] if route != "cuda_cores" else sum(k["flops"] for k in per_kernel.values())
        row = dict(
            case=name, shape_q=[bh, sq, d], shape_k=[bh, sk, d], dtype=name_dt, route=route, launches=launches,
            max_abs_err=errs, max_abs_grad=max_grads, tol=BWD_TOLERANCE[name_dt],
            rel_fro_err=fro_errs, fro_tol=BWD_FRO_TOLERANCE[name_dt], repeat=repeat, ok=ok,
            call_ms=call_ms, kernel_ms=kernel_ms, host_ms_per_call=host[0], plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound[0], bound_by=bound[1], per_kernel=per_kernel,
            tflops=flops_run / call_ms / 1e9, cuda_core_pair_ms=pair_ms,
            dq_reduce_bytes=-(-sk // fa.FUSED_BWD_KEYS) * bh * sq * d * 4 if fused else None,
            dq_partial_bytes=n_parts * bh * sq * d * 4 if route == "f32_fused" else None,
        )
        rows.append(row)
        emit("kernels_bwd", **row)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return rows


def profiled_kernel_ms(fn, reps):
    """Device ms per call of each kernel ``fn`` launches (torch.profiler over
    ``reps`` calls after a warm-up), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {name[:100]: ms / reps for ms, _, name in device_kernels(prof)}


def device_kernels(prof):
    """(device ms, launches, name) of each kernel in a torch.profiler trace."""
    import torch

    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3, e.count, e.key))
    return kernels


def sd15_lion_leaves():
    """Quantized SD1.5 leaves under the example config's masks: sizes of the
    UNet's and CLIP's, split at the bucket limit (the earlier entries'
    grouping)."""
    leaves = {}
    for model_name, quantized in sd15_quantized_leaves().items():
        sizes = [math.prod(shape) for _, shape, _ in quantized]
        big = [n for n in sizes if n // LION_BS > BUCKET_MAX_NB]
        small = [n for n in sizes if n // LION_BS <= BUCKET_MAX_NB]
        leaves[model_name] = dict(
            quantized=len(sizes), elements=sum(sizes), single=len(big), single_elements=sum(big),
            bucket=len(small), bucket_elements=sum(small), largest=max(sizes), single_sizes=big,
            bucket_sizes=small,
        )
    return leaves


def lion_cases():
    """K4 (single leaf) and K5 (many leaves) against
    ``lion8bit_update_reference``: update signs and scales equal, codes at
    most one apart (CUDA's powf vs torch's pow), counted."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.utils import roofline

    leaves = sd15_lion_leaves()
    emit("lion_leaves", **{
        m: {k: v for k, v in d.items() if not k.endswith("_sizes")} for m, d in leaves.items()
    })
    single_sizes = leaves["unet"]["single_sizes"] + leaves["text_encoder"]["single_sizes"]
    bs64_sizes = [n for n in leaves["unet"]["bucket_sizes"] if n % 64 == 0]
    cases = [  # (name, entry, leaf sizes, bs, compander); "single": one launch per leaf
        ("single_leaves", "single", single_sizes, LION_BS, "exact"),
        ("single_leaves", "single", single_sizes, LION_BS, "fast"),
        ("unet_bucket", "multi", leaves["unet"]["bucket_sizes"], LION_BS, "exact"),
        ("unet_bucket", "multi", leaves["unet"]["bucket_sizes"], LION_BS, "fast"),
        ("clip_bucket", "multi", leaves["text_encoder"]["bucket_sizes"], LION_BS, "exact"),
        ("unet_bucket_bs64", "multi", bs64_sizes, 64, "exact"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(99)
    rows = []
    for name, entry, sizes, bs, compander in cases:
        grads = [(torch.randn(n, generator=gen, device="cuda") * 1e-3).bfloat16() for n in sizes]
        moms = [lk.block_quantize(torch.randn(n, generator=gen, device="cuda") * 1e-4, bs) for n in sizes]
        expected = [lk.lion8bit_update_reference(g, c, s, compander=compander) for g, (c, s) in zip(grads, moms)]
        codes = [c.clone() for c, _ in moms]
        scales = [s.clone() for _, s in moms]
        if entry == "single":
            run = lambda cs=codes, ss=scales: [
                lk.lion8bit_update_(g, c, s, compander=compander) for g, c, s in zip(grads, cs, ss)
            ]
        else:
            run = lambda cs=codes, ss=scales: lk.lion8bit_update_multi_(grads, cs, ss, compander=compander)
        lk.reset_launch_counts()
        upds = run()
        torch.cuda.synchronize()
        wrapper = lk.lion8bit_update_ if entry == "single" else lk.lion8bit_update_multi_
        path_launches = wrapper.launches
        updates_equal = all(bool(torch.equal(u, e[0])) for u, e in zip(upds, expected))
        scales_equal = all(bool(torch.equal(s, e[2])) for s, e in zip(scales, expected))
        max_code_diff, codes_off = 0, 0
        for c, e in zip(codes, expected):
            d = (c.int() - e[1].int()).abs()
            max_code_diff = max(max_code_diff, int(d.max()))
            codes_off += int((d > 0).sum())
        n = sum(sizes)
        del expected, d
        host = []
        kernel_ms = cuda_ms(run, 10, host=host)
        plain_ms = cuda_ms(
            lambda: [lk.lion8bit_update_reference(g, c, s, compander=compander)
                     for g, (c, s) in zip(grads, moms)], 2, warmup=1,
        )
        nbytes = roofline.lion_bytes(n, n // bs, 2)  # bf16 grads
        row = dict(
            case=name, entry=entry, compander=compander, bs=bs, leaves=len(sizes), elements=n,
            path_launches=path_launches,
            launch_shapes=sorted({(m // bs, bs) for m in sizes}) if entry == "single"
            else [(len(sizes), n // bs, bs)],
            updates_equal=updates_equal, scales_equal=scales_equal, max_code_diff=max_code_diff,
            codes_off_by_one=codes_off, ok=updates_equal and scales_equal and max_code_diff <= 1,
            kernel_ms=kernel_ms, host_ms_per_call=host[0], plain_ms=plain_ms,
            bound_ms=nbytes / roofline.PEAK_BYTES * 1e3,
            bound_by="bytes", gbytes_per_s=nbytes / kernel_ms / 1e6,
        )
        rows.append(row)
        emit("kernels_lion", **row)
        del grads, moms, codes, scales, upds
        torch.cuda.empty_cache()
    return rows


def lion_fused_cases():
    """K6 (narrow) and K7 (wide) through ``fused_lion8bit_update`` over the
    largest SD1.5 UNet leaf, against ``lion8bit_update_reference``: update
    signs and scales equal, codes at most one apart, counted. Each case
    first drives the entry, its path, for three updates (new codes and
    scales fed back) with the launch counts zeroed just before and read
    just after; then compares one update with the plain version and times
    the kernel alone (``ms``, in place on copies) and the whole functional
    entry (``entry_ms``, with its copies of the codes and scales)."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.utils import roofline

    n = max(sd15_lion_leaves()["unet"]["single_sizes"])
    cases = [  # (layout, bs, grad dtype)
        ("narrow", 16, torch.bfloat16), ("narrow", 128, torch.bfloat16), ("narrow", 16, torch.float32),
        ("wide", 16, torch.bfloat16), ("wide", 4, torch.bfloat16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(77)
    rows = []
    for layout, bs, dtype in cases:
        name_dt = str(dtype).replace("torch.", "")
        grad = (torch.randn(n, generator=gen, device="cuda") * 1e-3).to(dtype)
        codes, scales = lk.block_quantize(torch.randn(n, generator=gen, device="cuda") * 1e-4, bs)
        scales = scales[:, None]
        nb = n // bs
        lk.reset_launch_counts()
        c, s = codes, scales
        for _ in range(3):
            _, c, s = lk.fused_lion8bit_update(grad, c, s, layout=layout)
        torch.cuda.synchronize()
        launches = lk.fused_lion8bit_update.launches_by_shape.get((layout, nb, bs, name_dt), 0)
        upd, new_codes, new_scales = lk.fused_lion8bit_update(grad, codes, scales, layout=layout)
        torch.cuda.synchronize()
        e_upd, e_codes, e_scales = lk.lion8bit_update_reference(grad, codes, scales[:, 0])
        d = (new_codes.int() - e_codes.int()).abs()
        updates_equal = bool(torch.equal(upd, e_upd))
        scales_equal = bool(torch.equal(new_scales[:, 0], e_scales))
        max_code_diff, codes_off = int(d.max()), int((d > 0).sum())
        del d, e_upd, e_codes, e_scales, upd, new_codes, new_scales
        work_codes, work_scales = codes.clone(), scales[:, 0].clone()
        kernel_ms = cuda_ms(lambda: lk._launch_single(grad, work_codes, work_scales, 0.9, 0.99, False), 20)
        entry_ms = cuda_ms(lambda: lk.fused_lion8bit_update(grad, codes, scales, layout=layout), 20)
        plain_ms = cuda_ms(lambda: lk.lion8bit_update_reference(grad, codes, scales[:, 0]), 2, warmup=1)
        nbytes = roofline.lion_bytes(n, nb, grad.element_size())
        row = dict(
            case=f"largest_unet_leaf_{layout}_bs{bs}_{name_dt}", layout=layout, bs=bs, dtype=name_dt,
            elements=n, blocks=nb, cooperative=bs > 64, path_launches=launches,
            updates_equal=updates_equal, scales_equal=scales_equal, max_code_diff=max_code_diff,
            codes_off_by_one=codes_off,
            ok=updates_equal and scales_equal and max_code_diff <= 1 and launches == 3,
            kernel_ms=kernel_ms, entry_ms=entry_ms, plain_ms=plain_ms,
            bound_ms=nbytes / roofline.PEAK_BYTES * 1e3, bound_by="bytes", gbytes_per_s=nbytes / kernel_ms / 1e6,
        )
        rows.append(row)
        emit("kernels_lion_fused", **row)
        del grad, codes, scales, c, s, work_codes, work_scales
        torch.cuda.empty_cache()
    return rows


def quantized_leaves(model):
    """[(name, torch shape, permutation to the JAX layout)] of the leaves of
    ``model`` that the example config quantizes, in the optimizer's order."""
    from stable_diffusion_training_tpu_torch.models import hf_io
    from stable_diffusion_training_tpu_torch.optim import create_mask

    mask = create_mask(model, EXAMPLE_EXCLUDED_FROM_QUANTIZATION)
    paths = hf_io.jax_param_paths(model)
    return [(n, tuple(p.shape), paths[n][1]) for n, p in model.named_parameters() if mask[n]]


def sd15_quantized_leaves():
    """{model: quantized leaves} of SD1.5's UNet and text encoder."""
    from stable_diffusion_training_tpu_torch.models import CLIPTextModel, UNet2DConditionModel, configs

    return {
        "unet": quantized_leaves(UNet2DConditionModel(**configs.SD15_UNET, device="meta")),
        "text_encoder": quantized_leaves(CLIPTextModel(**configs.CLIP_VIT_L, device="meta")),
    }


def sdxl_quantized_leaves():
    """The SDXL UNet's quantized leaves (its text towers are frozen)."""
    from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel, configs

    return quantized_leaves(UNet2DConditionModel(**configs.SDXL_UNET, device="meta"))


def sd21_quantized_leaves():
    """{model: quantized leaves} of SD2.1's UNet and text encoder (OpenCLIP
    ViT-H), both trained in ``sd21_trainer``."""
    from stable_diffusion_training_tpu_torch.models import CLIPTextModel, UNet2DConditionModel, configs

    return {
        "sd21_unet": quantized_leaves(UNet2DConditionModel(**configs.SD21_UNET, device="meta")),
        "sd21_text_encoder": quantized_leaves(CLIPTextModel(**configs.OPEN_CLIP_VIT_H, device="meta")),
    }


def lion_table_launches(leaves, dtype_name):
    """``{(leaves, elements, bs, dtype): 1}`` of one leaf-table update over
    ``leaves``: one launch per ``MAX_LEAVES_PER_LAUNCH`` leaves, as
    ``LeafTable`` splits them."""
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk

    step = lk.MAX_LEAVES_PER_LAUNCH
    return {
        (len(part), sum(math.prod(shape) for _, shape, _ in part), LION_BS, dtype_name): 1
        for part in (leaves[i:i + step] for i in range(0, len(leaves), step))
    }


def lion_model_inputs(leaves, dtype, bs, seed):
    """Torch-layout grads ~N(0, 1e-3) in ``dtype`` and momentum (codes and
    scales in JAX order, from ~N(0, 1e-4)) for each of ``leaves``."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads, codes, scales = [], [], []
    for _, shape, _ in leaves:
        grads.append((torch.randn(shape, generator=gen, device="cuda") * 1e-3).to(dtype))
        c, s = lk.block_quantize(torch.randn(shape, generator=gen, device="cuda").reshape(-1) * 1e-4, bs)
        codes.append(c)
        scales.append(s)
    return grads, codes, scales


def old_lion_route(leaves, grads, codes, scales, compander, copies=None):
    """The train step's Lion route before the leaf table: each grad permuted
    into JAX order (a copy), then the single-leaf entry for every leaf above
    the bucket limit and the multi-leaf entry over the rest. ``copies``, if
    given, replaces the permuted grads (the kernels alone)."""
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk

    jax_grads = copies if copies is not None else permute_grads(leaves, grads)
    bucket = [i for i, c in enumerate(codes) if c.shape[0] <= BUCKET_MAX_NB]
    for i, c in enumerate(codes):
        if c.shape[0] > BUCKET_MAX_NB:
            lk.lion8bit_update_(jax_grads[i], c, scales[i], compander=compander)
    lk.lion8bit_update_multi_([jax_grads[i] for i in bucket], [codes[i] for i in bucket],
                              [scales[i] for i in bucket], compander=compander)


def permute_grads(leaves, grads):
    return [g.permute(*perm).contiguous() if perm else g for (_, _, perm), g in zip(leaves, grads)]


# the models whose Lion case also runs the route before the leaf table (the
# permute copies and the per-leaf entries) on the same inputs; the ranks'
# tables and SD2.1's hold the leaf table against its plain version only
OLD_ROUTE_MODELS = ("unet", "text_encoder", "sdxl_unet")


def lion_model_cases():
    """The whole 8-bit Lion update of each SD1.5 model (bf16 and f32 grads,
    both companders) and of the SDXL UNet (bf16, exact: SDXL training's;
    773 leaves, more than 2^31 elements) at its real leaf
    shapes and permutations, bs 16: the new route (``lion8bit_update_leaves_``,
    one launch, grads in torch layout) against its plain version
    (``lion8bit_update_leaves_reference``) and against the old route (permute
    copies, the single-leaf entry per leaf over the bucket limit, the
    multi-leaf entry over the rest) on the same inputs, for the whole
    models of ``OLD_ROUTE_MODELS``: update signs and scales bitwise equal to
    the plain version, codes at most one apart (counted), codes bitwise
    equal to the old route's (both are powf's).
    Times: each route's device ms and host ms a call, the old route's copies
    and kernels apart, the bound (bytes of the fused update) and GB/s."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.utils import roofline

    rows = []
    variants = ((torch.bfloat16, "exact"), (torch.bfloat16, "fast"), (torch.float32, "exact"))
    models = [(name, leaves, variants) for name, leaves in sd15_quantized_leaves().items()]
    models.append(("sdxl_unet", sdxl_quantized_leaves(), variants[:1]))
    # one rank's table under FSDP on two ranks: its local leaves (the
    # co-sharding rule's; both ranks' tables are alike), fsdp_trainer's SDXL
    # UNet in bf16 and fsdp_parity's SD1.5 models in f32
    models.append(("sdxl_unet_fsdp_half", fsdp_rule(sdxl_quantized_leaves(), FSDP_WORLD, 0)[0], variants[:1]))
    models += [(f"{name}_fsdp_half", fsdp_rule(leaves, FSDP_WORLD, 0)[0], variants[2:])
               for name, leaves in sd15_quantized_leaves().items()]
    models += [(name, leaves, variants[:1]) for name, leaves in sd21_quantized_leaves().items()]
    # one rank's table under TP on two ranks: the split leaves' halves and
    # the whole rest (both ranks' tables are alike), tp_trainer's bf16 and
    # tp_parity's f32
    models += [(f"{name}_tp_half", local, variants[::2]) for name, (local, _, _) in sd15_tp_rules().items()]
    # one rank's table under TP with FSDP on [1, 2, 2]: its fsdp rows of its
    # TP slices and of the whole leaves (the four ranks' tables are alike),
    # tp_fsdp_trainer's bf16 and tp_fsdp_parity's f32
    models += [(f"{name}_tp_fsdp_quarter", local, variants[::2])
               for name, (local, _, _) in sd15_tp_fsdp_rules().items()]
    for model_name, leaves, model_variants in models:
        for dtype, compander in model_variants:
            name_dt = str(dtype).replace("torch.", "")
            grads, codes, scales = lion_model_inputs(leaves, dtype, LION_BS, seed=5)
            perms = [perm for _, _, perm in leaves]
            shapes = [shape for _, shape, _ in leaves]
            e_upd, e_codes, e_scales = lk.lion8bit_update_leaves_reference(grads, codes, scales, perms,
                                                                          compander=compander)
            new_c, new_s = [c.clone() for c in codes], [s.clone() for s in scales]
            old_c, old_s = [c.clone() for c in codes], [s.clone() for s in scales]
            table = lk.LeafTable(new_c, new_s, shapes, perms)
            lk.reset_launch_counts()
            upds = lk.lion8bit_update_leaves_(grads, table, compander=compander)
            torch.cuda.synchronize()
            launches = dict(lk.lion8bit_update_leaves_.launches_by_shape)
            old = model_name in OLD_ROUTE_MODELS
            old_route = lambda: old_lion_route(leaves, grads, old_c, old_s, compander)
            if old:
                old_route()
                torch.cuda.synchronize()
            updates_equal = all(bool(torch.equal(u, e)) for u, e in zip(upds, e_upd))
            contiguous = all(u.is_contiguous() and u.shape == g.shape for u, g in zip(upds, grads))
            scales_equal = all(bool(torch.equal(s, e)) for s, e in zip(new_s, e_scales))
            max_code_diff = max(int((c.int() - e.int()).abs().max()) for c, e in zip(new_c, e_codes))
            codes_off = sum(int((c != e).sum()) for c, e in zip(new_c, e_codes))
            codes_differ_from_old = sum(int((c != o).sum()) for c, o in zip(new_c, old_c)) if old else None
            scales_differ_from_old = sum(int((s != o).sum()) for s, o in zip(new_s, old_s)) if old else None
            del e_upd, e_codes, e_scales, upds
            n = sum(g.numel() for g in grads)
            nb = n // LION_BS
            host_new, host_old = [], [None]
            new_ms = cuda_ms(lambda: lk.lion8bit_update_leaves_(grads, table, compander=compander), 10, host=host_new)
            old_ms = copies_ms = old_kernels_ms = None
            if old:
                host_old = []
                old_ms = cuda_ms(old_route, 5, host=host_old)
                copies_ms = cuda_ms(lambda: permute_grads(leaves, grads), 5)
                jax_grads = permute_grads(leaves, grads)
                old_kernels_ms = cuda_ms(lambda: old_lion_route(leaves, grads, old_c, old_s, compander, jax_grads), 5)
                del jax_grads
            # no warm-up call: the expected values above came from it
            plain_ms = cuda_ms(lambda: lk.lion8bit_update_leaves_reference(grads, codes, scales, perms,
                                                                           compander=compander), 1, warmup=0)
            nbytes = roofline.lion_bytes(n, nb, grads[0].element_size())
            bound_ms = nbytes / roofline.PEAK_BYTES * 1e3
            launch_shapes = lion_table_launches(leaves, name_dt)
            ok = (updates_equal and contiguous and scales_equal and max_code_diff <= 1 and launches == launch_shapes
                  and (not old or (codes_differ_from_old == 0 and scales_differ_from_old == 0)))
            row = dict(
                case=f"{model_name}_{name_dt}_{compander}", model=model_name, dtype=name_dt, compander=compander,
                bs=LION_BS, leaves=len(leaves), transposed_leaves=sum(perm is not None for perm in perms),
                elements=n, launches_per_call=sum(launches.values()), table_tiles=table.n_tiles,
                updates_equal=updates_equal, updates_contiguous_torch_layout=contiguous, scales_equal=scales_equal,
                max_code_diff=max_code_diff, codes_off_by_one=codes_off,
                codes_differ_from_old_route=codes_differ_from_old,
                scales_differ_from_old_route=scales_differ_from_old, ok=ok,
                kernel_ms=new_ms, host_ms_per_call=host_new[0], plain_ms=plain_ms,
                old_route_ms=old_ms, old_route_host_ms_per_call=host_old[0], old_permute_copies_ms=copies_ms,
                old_kernels_ms=old_kernels_ms, bound_ms=bound_ms, bound_by="bytes",
                share_of_bound=bound_ms / new_ms, gbytes_per_s=nbytes / new_ms / 1e6,
                launch_shapes=[list(k) for k in launch_shapes],
            )
            rows.append(row)
            emit("kernels_lion_model", **row)
            del grads, codes, scales, new_c, new_s, old_c, old_s, table
            torch.cuda.empty_cache()
    both = {}
    for r in rows:
        if r["model"] not in ("unet", "text_encoder"):  # the sum is SD1.5's (whole models)
            continue
        key = (r["dtype"], r["compander"])
        acc = both.setdefault(key, dict(kernel_ms=0.0, bound_ms=0.0, old_route_ms=0.0, old_permute_copies_ms=0.0,
                                        host_ms=[]))
        for k in ("kernel_ms", "bound_ms", "old_route_ms", "old_permute_copies_ms"):
            acc[k] += r[k]
        acc["host_ms"].append(r["host_ms_per_call"])
    for (dt, compander), acc in both.items():
        summary = dict(case=f"both_models_{dt}_{compander}", dtype=dt, compander=compander, **acc,
                       share_of_bound=acc["bound_ms"] / acc["kernel_ms"])
        if (dt, compander) == ("bfloat16", "exact"):  # the aims of the redesign
            summary["aim_device_within_2x_bound"] = acc["kernel_ms"] <= 2 * acc["bound_ms"]
            summary["aim_host_ms_per_model_call_le_0_5"] = max(acc["host_ms"]) <= 0.5
        emit("kernels_lion_model_both", **summary)
    return rows


def phase_parity(state):
    import torch

    from stable_diffusion_training_tpu_torch.models import (
        UNet2DConditionModel, configs, random_init_,
    )
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    unet = UNet2DConditionModel(**configs.SD15_UNET, attention_backend="auto", device="cuda")
    random_init_(unet, gen)
    plain = UNet2DConditionModel(**configs.SD15_UNET, attention_backend="xla", device="cuda")
    plain.load_state_dict(unet.state_dict(), strict=True)
    sample = torch.randn(2, 4, 64, 64, generator=gen, device="cuda")
    t = torch.tensor([421, 421], device="cuda")
    ctx = torch.randn(2, 77, 768, generator=gen, device="cuda")
    with torch.no_grad():
        fa.reset_launch_counts()
        out_k = unet(sample, t, ctx)
        launches = fa.flash_attention_fwd.launches
        by_route = dict(fa.flash_attention_fwd.launches_by_route)
        state["parity_by_shape"] = dict(fa.flash_attention_fwd.launches_by_shape)
        out_p = plain(sample, t, ctx)
        plain_launches = fa.flash_attention_fwd.launches - launches
    diff = (out_k - out_p).abs().max().item()
    ref_max = out_p.abs().max().item()
    rel = diff / ref_max
    ok = bool(torch.isfinite(out_k).all()) and rel <= PARITY_REL_TOL
    emit(
        "parity", shape=list(out_k.shape), max_abs_diff=diff, max_abs_ref=ref_max,
        max_rel_diff=rel, rel_tol=PARITY_REL_TOL, kernel_launches=launches,
        kernel_launches_by_route=by_route, plain_launches=plain_launches, ok=ok,
    )
    del unet, plain
    torch.cuda.empty_cache()
    if not ok or launches != 5 or by_route != {"f32": 5} or plain_launches != 0:
        raise AssertionError("full-width UNet: kernel and plain attention disagree")


def serving_scheduler():
    """SD1.5's and SDXL's own DDIM settings (epsilon, steps_offset 1)."""
    from stable_diffusion_training_tpu_torch.diffusion import DDIMScheduler

    return DDIMScheduler(
        beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
        set_alpha_to_one=False, steps_offset=1, prediction_type="epsilon",
        device="cuda",
    )


def seeded_models(seed, dtype, **models):
    """``{name: (class, config)}`` built on the card in ``dtype`` with
    weights from one generator seeded with ``seed``, in the given order."""
    import torch

    from stable_diffusion_training_tpu_torch.models import random_init_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {name: random_init_(cls(**cfg, device="cuda", dtype=dtype), gen) for name, (cls, cfg) in models.items()}


def prompt_ids(seed, vocab, n=2):
    """``n`` seeded (1, 77) token id rows: the prompt, its negative, ..."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(0, vocab, (1, 77), generator=gen, device="cuda") for _ in range(n)]


def time_serving(phase, call, stages, want_by_route, want_by_shape, size, repeats, **fields):
    """The serving phases' run and checks. A warm-up ``call()``, then one
    with the launch counts zeroed just before and read just after: its
    images must be ``(1, size, size, 3)``, finite, in ``[0, 1]``, and K1's
    launches by route (and by shape, where ``want_by_shape`` is given)
    exactly as expected. Then ``repeats`` rounds on the host clock of the
    whole call and of each of ``stages`` (``(field, fn, divisor)``, each
    ``fn`` fed the one before's result). Emits the phase line (medians and
    every run); returns the stages' last results and the launches by
    shape."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    with torch.no_grad():
        call()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        images = call()
        torch.cuda.synchronize()
        launches = fa.flash_attention_fwd.launches
        by_route = dict(fa.flash_attention_fwd.launches_by_route)
        by_shape = dict(fa.flash_attention_fwd.launches_by_shape)
        peak = torch.cuda.max_memory_allocated()
        # host clock, repeated: the loop is eager and its host time varies
        runs = {"total": [], **{field: [] for field, _, _ in stages}}
        results = {}
        for _ in range(repeats):
            runs["total"].append(host_ms(call)[0])
            out = None
            for field, fn, divisor in stages:
                ms, out = host_ms(lambda: fn(out))
                runs[field].append(ms / divisor)
                results[field] = out
    median = {name: statistics.median(v) for name, v in runs.items()}
    shape_ok = tuple(images.shape) == (1, size, size, 3)
    finite = bool(torch.isfinite(images).all())
    in_range = finite and float(images.min()) >= 0.0 and float(images.max()) <= 1.0
    emit(
        phase, image_shape=list(images.shape), finite=finite, in_range=in_range,
        image_mean=float(images.float().mean()), image_std=float(images.float().std()),
        flash_launches=launches, expected_launches=sum(want_by_route.values()),
        flash_launches_by_route=by_route,
        launches_by_shape={"x".join(map(str, k)): n for k, n in by_shape.items()},
        total_ms=median["total"], images_per_s=1e3 / median["total"],
        **{field: median[field] for field, _, _ in stages}, runs_ms=runs,
        max_memory_allocated=peak, **fields,
    )
    shapes_ok = want_by_shape is None or by_shape == want_by_shape
    if not (shape_ok and in_range and by_route == want_by_route and shapes_ok):
        raise AssertionError(f"{phase}: image or K1 launches failed their checks")
    return images, results, by_shape


def phase_slice(state, steps=4, seed=0, repeats=5):
    import torch

    from stable_diffusion_training_tpu_torch.models import (
        AutoencoderKL, CLIPTextModel, UNet2DConditionModel, configs,
    )
    from stable_diffusion_training_tpu_torch.pipeline import StableDiffusionPipeline

    set_tf32(False)
    models = seeded_models(
        seed, torch.bfloat16, unet=(UNet2DConditionModel, configs.SD15_UNET),
        vae=(AutoencoderKL, configs.SD_VAE), text_encoder=(CLIPTextModel, configs.CLIP_VIT_L),
    )
    pipe = StableDiffusionPipeline(models["text_encoder"], models["vae"], models["unet"], serving_scheduler())
    ids, neg_ids = prompt_ids(seed + 1, configs.CLIP_VIT_L["vocab_size"])
    kw = dict(num_inference_steps=steps, height=512, width=512, guidance_scale=7.5, neg_prompt_ids=neg_ids)
    noise = torch.randn(1, 4, 64, 64, generator=torch.Generator("cuda").manual_seed(seed + 2), device="cuda")
    stages = [
        ("encode_ms", lambda _: pipe.encode_prompt(ids, neg_ids), 1),
        ("denoise_ms_per_step", lambda context: (pipe.denoise(noise, context, steps, 7.5), context), steps),
        ("decode_ms", lambda out: pipe.decode_latents(out[0]), 1),
    ]
    # the UNet's self-attention on the narrow tensor-core kernel, the VAE
    # decode's mid-block on the wide one
    _, results, by_shape = time_serving(
        "slice",
        lambda: pipe(ids, generator=torch.Generator("cuda").manual_seed(seed), **kw)["images"],
        stages, {"tma_narrow": 5 * steps, "tma_wide": 1}, None, 512, repeats, steps=steps,
    )
    state["slice_by_shape"] = by_shape
    latents, context = results["denoise_ms_per_step"]
    with torch.no_grad():
        profile_step(
            lambda: pipe.denoise(latents, context, 1, 7.5),
            "one CFG denoise step (UNet batch 2 + DDIM step)", top=15,
        )


# SDXL at 1024x1024, CFG batch 2, bf16: K1's shapes (bh, sq, sk, d, dtype,
# route) and launches. The base UNet's 64x64 level (640 channels, 10 heads of
# 64, 2 transformer layers: 4 down, 6 up) and the refiner's (768 channels, 12
# heads, 4 layers: 8 down, 12 up); the VAE mid-block at 128x128 latents, once
# per decode and once per encode.
SDXL_RES = 1024
SDXL_UNET_KEY = (20, 4096, 4096, 64, "bfloat16", "tma_narrow")
SDXL_REFINER_KEY = (24, 4096, 4096, 64, "bfloat16", "tma_narrow")
SDXL_VAE_KEY = (1, 16384, 16384, 512, "bfloat16", "tma_wide")


def phase_sdxl_parity(state):
    """The full-width SDXL base UNet in f32 (TF32 off) on 128x128 latents at
    batch 2 with ``text_embeds`` and ``time_ids``: "auto" (K1 on route f32,
    D = 64) against "xla" (plain), within ``PARITY_REL_TOL``; K1 exactly 10
    times at (20, 4096, 64)."""
    import torch

    from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel, configs
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    set_tf32(False)
    unet = seeded_models(0, torch.float32, unet=(UNet2DConditionModel, configs.SDXL_UNET))["unet"]
    # the plain-attention model holds the same tensors (no second 10 GB copy)
    plain = UNet2DConditionModel(**configs.SDXL_UNET, attention_backend="xla", device="meta")
    plain.load_state_dict(unet.state_dict(), strict=True, assign=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sample = torch.randn(2, 4, 128, 128, generator=gen, device="cuda")
    ctx = torch.randn(2, 77, 2048, generator=gen, device="cuda")
    added = {"text_embeds": torch.randn(2, 1280, generator=gen, device="cuda"),
             "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device="cuda")}
    t = torch.tensor([421, 421], device="cuda")
    with torch.no_grad():
        fa.reset_launch_counts()
        out_k = unet(sample, t, ctx, added)
        torch.cuda.synchronize()
        by_route = dict(fa.flash_attention_fwd.launches_by_route)
        by_shape = dict(fa.flash_attention_fwd.launches_by_shape)
        state["sdxl_parity_by_shape"] = by_shape
        out_p = plain(sample, t, ctx, added)
        plain_launches = fa.flash_attention_fwd.launches - sum(by_route.values())
    diff = (out_k - out_p).abs().max().item()
    ref_max = out_p.abs().max().item()
    rel = diff / ref_max
    want = {SDXL_UNET_KEY[:4] + ("float32", "f32"): 10}
    ok = bool(torch.isfinite(out_k).all()) and rel <= PARITY_REL_TOL
    emit(
        "sdxl_parity", shape=list(out_k.shape), max_abs_diff=diff, max_abs_ref=ref_max,
        max_rel_diff=rel, rel_tol=PARITY_REL_TOL, kernel_launches_by_route=by_route,
        launches_by_shape={"x".join(map(str, k)): n for k, n in by_shape.items()},
        plain_launches=plain_launches, ok=ok,
    )
    del unet, plain, out_k, out_p
    torch.cuda.empty_cache()
    if not ok or by_route != {"f32": 10} or by_shape != want or plain_launches != 0:
        raise AssertionError("full-width SDXL UNet: kernel and plain attention disagree")


def phase_sdxl(state, steps=4, seed=0, repeats=5):
    """SDXL text-to-image at full width in bf16: both towers, the base
    UNet, the VAE; 1024x1024, one prompt (CFG batch 2), ``steps`` DDIM
    steps. K1 10 times a step at (20, 4096, 64) and once in the decode at
    (1, 16384, 512)."""
    import torch

    from stable_diffusion_training_tpu_torch.models import (
        AutoencoderKL, CLIPTextModel, CLIPTextModelWithProjection, UNet2DConditionModel, configs,
    )
    from stable_diffusion_training_tpu_torch.pipeline import StableDiffusionXLPipeline

    set_tf32(False)
    models = seeded_models(
        seed, torch.bfloat16, unet=(UNet2DConditionModel, configs.SDXL_UNET),
        vae=(AutoencoderKL, configs.SDXL_VAE), text_encoder=(CLIPTextModel, configs.CLIP_VIT_L),
        # SDXL's text_encoder_2 config pools at the argmax of the ids
        text_encoder_2=(CLIPTextModelWithProjection, dict(configs.OPEN_CLIP_VIT_BIGG, eos_token_id=2)),
    )
    pipe = StableDiffusionXLPipeline(
        models["text_encoder"], models["text_encoder_2"], models["vae"], models["unet"], serving_scheduler()
    )
    ids, neg_ids = prompt_ids(seed + 1, configs.CLIP_VIT_L["vocab_size"])
    kw = dict(num_inference_steps=steps, height=SDXL_RES, width=SDXL_RES, guidance_scale=5.0, neg_prompt_ids=neg_ids)
    latent = SDXL_RES // 8
    noise = torch.randn(1, 4, latent, latent, generator=torch.Generator("cuda").manual_seed(seed + 2), device="cuda")

    def encode(_):
        context, pooled = pipe.encode_prompt(ids, neg_ids)
        return context, {"text_embeds": pooled, "time_ids": pipe._time_ids(1, SDXL_RES, SDXL_RES)}

    stages = [
        ("encode_ms", encode, 1),
        ("denoise_ms_per_step", lambda cond: (pipe.denoise(noise, cond[0], steps, 5.0, cond[1]), cond), steps),
        ("decode_ms", lambda out: pipe.decode_latents(out[0]), 1),
    ]
    images, results, by_shape = time_serving(
        "sdxl",
        lambda: pipe(ids, generator=torch.Generator("cuda").manual_seed(seed), **kw)["images"],
        stages, {"tma_narrow": 10 * steps, "tma_wide": 1}, {SDXL_UNET_KEY: 10 * steps, SDXL_VAE_KEY: 1},
        SDXL_RES, repeats, steps=steps,
    )
    state["sdxl_by_shape"] = by_shape
    state["sdxl_image"] = images
    latents, (context, added) = results["denoise_ms_per_step"]
    with torch.no_grad():
        profile_step(
            lambda: pipe.denoise(latents, context, 1, 5.0, added),
            "one SDXL CFG denoise step (UNet batch 2 at 128x128 latents + DDIM step)", top=15,
        )
    del pipe, models, results
    torch.cuda.empty_cache()


def phase_sdxl_refiner(state, steps=10, strength=0.3, seed=3, repeats=5):
    """The SDXL refiner (img2img) at full width in bf16 on the ``sdxl``
    phase's image (a seeded one if that phase did not run): tower 2 alone,
    the refiner UNet (5 time ids), the VAE; strength 0.3 of 10 DDIM steps
    (3 run). K1 20 times a step at (24, 4096, 64) and twice at
    (1, 16384, 512): the image's encode and the decode."""
    import torch

    from stable_diffusion_training_tpu_torch.models import (
        AutoencoderKL, CLIPTextModelWithProjection, UNet2DConditionModel, configs,
    )
    from stable_diffusion_training_tpu_torch.pipeline import StableDiffusionXLImg2ImgPipeline
    from stable_diffusion_training_tpu_torch.pipeline.sdxl_refiner import start_step_for

    set_tf32(False)
    models = seeded_models(
        seed, torch.bfloat16, unet=(UNet2DConditionModel, configs.SDXL_REFINER_UNET),
        vae=(AutoencoderKL, configs.SDXL_VAE),
        text_encoder_2=(CLIPTextModelWithProjection, dict(configs.OPEN_CLIP_VIT_BIGG, eos_token_id=2)),
    )
    pipe = StableDiffusionXLImg2ImgPipeline(
        None, models["text_encoder_2"], models["vae"], models["unet"], serving_scheduler(),
    )
    image = state.get("sdxl_image")
    if image is None:
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        image = torch.rand(1, SDXL_RES, SDXL_RES, 3, generator=gen, device="cuda")
    image = image.permute(0, 3, 1, 2) * 2 - 1  # NHWC [0, 1] -> NCHW [-1, 1], as prepare_image
    ids, neg_ids = prompt_ids(seed + 1, configs.OPEN_CLIP_VIT_BIGG["vocab_size"])
    start = start_step_for(strength, steps)
    run = steps - start
    kw = dict(strength=strength, num_inference_steps=steps, guidance_scale=5.0, neg_prompt_ids=neg_ids)

    def encode(_):
        context, pooled = pipe.encode_prompt(ids, neg_ids)
        return context, {"text_embeds": pooled, "time_ids": pipe._time_ids(1, SDXL_RES, SDXL_RES)}

    def image_encode(cond):
        gen = torch.Generator("cuda").manual_seed(seed)
        return pipe.prepare_image_latents(image, start, steps, gen), cond

    def denoise(out):
        latents, (context, added) = out
        return pipe.denoise(latents, context, steps, 5.0, added, start), (context, added)

    stages = [
        ("encode_ms", encode, 1), ("image_encode_ms", image_encode, 1),
        ("denoise_ms_per_step", denoise, run), ("decode_ms", lambda out: pipe.decode_latents(out[0]), 1),
    ]
    _, results, by_shape = time_serving(
        "sdxl_refiner",
        lambda: pipe(ids, image, generator=torch.Generator("cuda").manual_seed(seed), **kw)["images"],
        stages, {"tma_narrow": 20 * run, "tma_wide": 2}, {SDXL_REFINER_KEY: 20 * run, SDXL_VAE_KEY: 2},
        SDXL_RES, repeats, steps=steps, strength=strength, denoise_steps=run,
        input_image="sdxl phase" if "sdxl_image" in state else "seeded",
    )
    state["sdxl_refiner_by_shape"] = by_shape
    latents, (context, added) = results["denoise_ms_per_step"]
    with torch.no_grad():
        profile_step(
            lambda: pipe.denoise(latents, context, 1, 5.0, added),
            "one SDXL refiner CFG denoise step (UNet batch 2 at 128x128 latents + DDIM step)", top=15,
        )
    del pipe, models, results
    state.pop("sdxl_image", None)
    torch.cuda.empty_cache()


def profile_step(fn, what, top):
    """Where one step's device time goes: the kernel table of one call of
    ``fn``, read from torch.profiler's Chrome trace with
    ``utils.kernel_trace`` (``trace_audit`` holds that reader against
    ``key_averages()``, whose tabulation took seconds a profile), the
    device's busy share of its wall time (one stream, so the kernels' sum
    is the busy time), and the device ms and launches of each category
    (``kernel_trace.categorize``; ``flash_ms`` and ``lion_ms`` those of the
    port's kernels). Only the device is
    traced: recording every host op as well slowed the step's host side
    (and so raised its idle share) and took tens of seconds to tabulate."""
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_training_tpu_torch.utils import kernel_trace

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = host_ms(fn)
    path = os.path.join(REPO, "chiprun_out", f"profile_step_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        durations = kernel_trace.op_durations(path)
    finally:
        os.remove(path)
    kernels = sorted(((us / 1e3, n, name) for name, (us, n) in durations.items()), reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    by_category = {}
    for ms, n, name in kernels:
        cat = by_category.setdefault(kernel_trace.categorize(name), dict(ms=0.0, launches=0))
        cat["ms"] += ms
        cat["launches"] += n
    row = dict(
        what=what, wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms,
        flash_ms=by_category.get("flash kernel", {}).get("ms", 0.0),
        lion_ms=by_category.get("lion kernel", {}).get("ms", 0.0),
        by_category=dict(sorted(by_category.items(), key=lambda kv: -kv[1]["ms"])),
        h2d_copies=sum(n for _, n, name in kernels if "Memcpy HtoD" in name),
        n_kernel_names=len(kernels), n_launches=sum(n for _, n, _ in kernels),
        top=[dict(ms=ms, count=n, name=name[:120]) for ms, n, name in kernels[:top]],
    )
    emit("profile", **row)
    return row


def phase_train_parity(state):
    """Full-width SD1.5 UNet forward and backward, kernels against the plain
    attention: f32 (loss, every grad, launch counts), then bf16 (each
    route's grads against the f32 plain grads, launch counts)."""
    import torch

    from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel, configs, random_init_
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(5)
    weights = UNet2DConditionModel(**configs.SD15_UNET, device="cuda")
    random_init_(weights, gen)
    names = [name for name, _ in weights.named_parameters()]
    weights = weights.state_dict()
    sample = torch.randn(1, 4, 64, 64, generator=gen, device="cuda")
    ctx = torch.randn(1, 227, 768, generator=gen, device="cuda")
    target = torch.randn(1, 4, 64, 64, generator=gen, device="cuda")
    t = torch.tensor([421], device="cuda")

    def loss_and_grads(backend, dtype, checkpointing=False):
        model = UNet2DConditionModel(**configs.SD15_UNET, attention_backend=backend, device="cuda", dtype=dtype)
        model.load_state_dict(weights, strict=True)
        model.set_gradient_checkpointing(checkpointing)
        fa.reset_launch_counts()
        out = model(sample.to(dtype), t, ctx.to(dtype))
        loss = ((out.float() - target) ** 2).mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        launches = dict(fwd=fa.flash_attention_fwd.launches, fwd_routes=dict(fa.flash_attention_fwd.launches_by_route),
                        **bwd_launches(fa))
        if dtype == torch.float32 and backend == "auto" and not checkpointing:
            state["train_parity_f32_by_shape"] = dict(fa.flash_attention_bwd_f32_fused.launches_by_shape)
        return loss.item(), [g.float() for g in grads], launches

    # f32 takes the fused f32 backward kernel, bf16 the fused tensor-core one
    kernel_launches = dict(fwd=5, fwd_routes={"f32": 5}, bwd_fused=0, bwd_fused_wide=0, bwd_f32=5, bwd_dq=0,
                           bwd_dkv=0)
    bf16_launches = dict(fwd=5, fwd_routes={"tma_narrow": 5}, bwd_fused=5, bwd_fused_wide=0, bwd_f32=0, bwd_dq=0,
                         bwd_dkv=0)
    plain_launches = dict(fwd=0, fwd_routes={}, bwd_fused=0, bwd_fused_wide=0, bwd_f32=0, bwd_dq=0, bwd_dkv=0)
    loss_k, grads_k, launches_k = loss_and_grads("auto", torch.float32)
    loss_p, grads_p, launches_p = loss_and_grads("xla", torch.float32)

    def worst_rel(grads, reference):  # worst max |diff| over the tensor's max |grad|
        worst, worst_name = 0.0, None
        for name, g, ref in zip(names, grads, reference):
            rel = (g - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        return worst, worst_name

    worst, worst_name = worst_rel(grads_k, grads_p)
    # the same step with every down, mid and up block recomputed in the
    # backward: K1 runs once more in each recompute
    loss_gc, grads_gc, launches_gc = loss_and_grads("auto", torch.float32, checkpointing=True)
    worst_gc, worst_gc_name = worst_rel(grads_gc, grads_k)
    del grads_k, grads_gc
    loss_gc_rel = abs(loss_gc - loss_k) / abs(loss_k)
    ok_gc = (
        loss_gc_rel <= TRAIN_LOSS_REL_TOL and worst_gc <= TRAIN_GRAD_REL_TOL
        and launches_gc == dict(kernel_launches, fwd=10, fwd_routes={"f32": 10})
    )
    emit(
        "train_parity", dtype="float32", case="gradient_checkpointing", loss=loss_gc,
        loss_without=loss_k, loss_rel_diff=loss_gc_rel, loss_rel_tol=TRAIN_LOSS_REL_TOL,
        worst_grad_rel_diff=worst_gc, worst_grad=worst_gc_name, grad_rel_tol=TRAIN_GRAD_REL_TOL,
        kernel_launches=launches_gc, kernel_launches_without=launches_k, ok=ok_gc,
    )
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = (
        loss_rel <= TRAIN_LOSS_REL_TOL and worst <= TRAIN_GRAD_REL_TOL
        and launches_k == kernel_launches and launches_p == plain_launches
    )
    emit(
        "train_parity", dtype="float32", loss_kernel=loss_k, loss_plain=loss_p,
        loss_rel_diff=loss_rel, loss_rel_tol=TRAIN_LOSS_REL_TOL, worst_grad_rel_diff=worst,
        worst_grad=worst_name, grad_rel_tol=TRAIN_GRAD_REL_TOL, n_grads=len(grads_p),
        kernel_launches=launches_k, plain_launches=launches_p, ok=ok,
    )

    def errors(grads):  # relative Frobenius error of each grad against the f32 plain grad
        return [((g - gp).norm() / gp.norm().clamp_min(1e-30)).item() for g, gp in zip(grads, grads_p)]

    loss_kb, grads_kb, launches_kb = loss_and_grads("auto", torch.bfloat16)
    err_k = errors(grads_kb)
    del grads_kb
    loss_pb, grads_pb, launches_pb = loss_and_grads("xla", torch.bfloat16)
    err_p = errors(grads_pb)
    del grads_pb
    ratios = [ek / max(ep, BF16_GRAD_ERR_FLOOR) for ek, ep in zip(err_k, err_p)]
    i = max(range(len(ratios)), key=ratios.__getitem__)
    attn = [j for j, n in enumerate(names) if ".attn1.to_" in n]
    ok_bf16 = (
        ratios[i] <= BF16_GRAD_ERR_RATIO
        and launches_kb == bf16_launches and launches_pb == plain_launches
    )
    emit(
        "train_parity", dtype="bfloat16", loss_kernel=loss_kb, loss_plain=loss_pb,
        loss_f32_plain=loss_p, worst_ratio=ratios[i], worst_grad=names[i],
        worst_grad_err_kernel=err_k[i], worst_grad_err_plain=err_p[i],
        ratio_tol=BF16_GRAD_ERR_RATIO, err_floor=BF16_GRAD_ERR_FLOOR,
        median_grad_err_kernel=statistics.median(err_k), median_grad_err_plain=statistics.median(err_p),
        self_attention_max_err_kernel=max(err_k[j] for j in attn),
        self_attention_max_err_plain=max(err_p[j] for j in attn),
        kernel_launches=launches_kb, plain_launches=launches_pb, ok=ok_bf16,
    )
    del grads_p
    torch.cuda.empty_cache()
    if not (ok and ok_bf16 and ok_gc):
        raise AssertionError("full-width UNet training: kernel and plain attention disagree")


def train_config(**overrides):
    from stable_diffusion_training_tpu_torch.train import TrainingConfig

    base = dict(  # model_properties_example.json's training settings
        model_path="sd15", batch_size=TRAIN_BATCH, learning_rate=1e-06, unet_learning_rate=1e-06,
        text_encoder_learning_rate=2.5e-07, lr_scheduler="constant", adam_to_lion_scale_factor=7.0,
        compilation_cache_path="", keep_compiled_fn_in_cache=False,
        text_encoder_context_window=77, context_window_concatenation_count=TRAIN_CONCAT,
        aot_compile=False, strip_bos_eos_token=True, offset_noise_magnitude=0.0,
        min_snr_gamma_magnitude=0.0, perturbation_noise_magnitude=0.0,
        image_area_root=[TRAIN_RES], minimum_axis_length=[TRAIN_RES],
        beta_scheduler="zero_snr_scaled_linear", prediction_type="v_prediction",
        excluded_layer_pattern_from_weight_decay=["bias", "scale", "embedding"],
        excluded_layer_from_quantization=EXAMPLE_EXCLUDED_FROM_QUANTIZATION,
        quant_block_size=LION_BS, quantize_unet_state=True, quantize_text_encoder_state=True,
        accumulate_unet_ema=True, accumulate_text_encoder_ema=True, ema_rate=0.99998,
        model_family="sd15", mixed_precision="bfloat16", attention_backend="auto",
        lion_bucket_max_nb=BUCKET_MAX_NB, lion_compander="exact", seed_init=0,
    )
    base.update(overrides)
    return TrainingConfig(**base)


def phase_train(state, warmup=2, steps=5, seed=0, dtype="bfloat16"):
    """The SD1.5 train step at full width, batch 8, 512x512: bf16 (the
    ``train`` phase) or f32 (``train_f32``, the fidelity configuration)."""
    import gc

    import torch

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.optim import QuantizedMomentum
    from stable_diffusion_training_tpu_torch.optim.lion8bit import GRAD_COPIES
    from stable_diffusion_training_tpu_torch.train import on_device_model_training_state, train_step

    phase = "train" if dtype == "bfloat16" else "train_f32"
    gc.collect()
    torch.cuda.empty_cache()
    set_tf32(False)
    cfg = train_config(mixed_precision=dtype)
    t0 = time.perf_counter()
    states = on_device_model_training_state(cfg)
    setup_s = time.perf_counter() - t0
    unet_state, te_state, unet_ema, te_ema, frozen_vae, frozen_sched, _ = states
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {
        "pixel_values": torch.rand(TRAIN_BATCH, 3, TRAIN_RES, TRAIN_RES, generator=gen, device="cuda") * 2 - 1,
        "input_ids": torch.randint(0, 49408, (TRAIN_BATCH * TRAIN_CONCAT, 77), generator=gen, device="cuda"),
    }
    train_rng = torch.Generator(device="cuda").manual_seed(seed + 1)

    def lion_states():
        return [s.opt_state[1][0] for s in (unet_state, te_state)]

    def step(batch=batch):
        out = train_step(
            unet_state, te_state, unet_ema, te_ema, batch, train_rng, frozen_vae, frozen_sched,
            strip_bos_eos_token=True, ema_rate=cfg.ema_rate,
            text_context_window=cfg.text_encoder_context_window,
        )
        return out[4]["loss"]

    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    ms, loss = host_ms(step)  # step 1: momentum leaves its zero state
    losses.append(loss.item())
    step_ms.append(ms)
    moms = [m for ls in lion_states() for m in ls.mu_quant.values() if isinstance(m, QuantizedMomentum)]
    codes_changed = sum(int((m.codes != 3).sum()) for m in moms)
    codes_total = sum(m.codes.numel() for m in moms)
    for _ in range(warmup - 1):
        ms, loss = host_ms(step)
        losses.append(loss.item())
        step_ms.append(ms)
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    GRAD_COPIES["count"] = 0
    timed = []
    for _ in range(steps):
        ms, loss = host_ms(step)
        losses.append(loss.item())
        timed.append(ms)
    launches = train_launches(fa, lk)
    fwd_routes = dict(fa.flash_attention_fwd.launches_by_route)
    by_shape = dict(
        flash_fwd=dict(fa.flash_attention_fwd.launches_by_shape),
        flash_bwd_fused=dict(fa.flash_attention_bwd_fused.launches_by_shape),
        flash_bwd_f32=dict(fa.flash_attention_bwd_f32_fused.launches_by_shape),
        flash_bwd_dq=dict(fa.flash_attention_bwd_dq.launches_by_shape),
        flash_bwd_dkv=dict(fa.flash_attention_bwd_dkv.launches_by_shape),
        lion_leaves=dict(lk.lion8bit_update_leaves_.launches_by_shape),
        lion_single=dict(lk.lion8bit_update_.launches_by_shape),
        lion_multi=dict(lk.lion8bit_update_multi_.launches_by_shape),
    )
    grad_copies = GRAD_COPIES["count"]
    peak = torch.cuda.max_memory_allocated()
    # K1 5 + 1 (the VAE encode's mid-block) a step; the backward on its
    # dtype's fused kernel, the CUDA-core pair never; Lion one launch per
    # model over its leaf table, the earlier entries never
    bwd = "flash_bwd_fused" if dtype == "bfloat16" else "flash_bwd_f32"
    expected = dict(
        flash_fwd=6 * steps, flash_bwd_fused=0, flash_bwd_fused_wide=0, flash_bwd_f32=0, flash_bwd_dq=0,
        flash_bwd_dkv=0, lion_leaves=2 * steps, lion_single=0, lion_multi=0,
    )
    expected[bwd] = 5 * steps
    # K1's routes: the UNet's 5 and the VAE encode's 1 a step, never the
    # older CUDA-core kernel
    expected_routes = (
        {"tma_narrow": 5 * steps, "tma_wide": steps} if dtype == "bfloat16" else {"f32": 6 * steps}
    )
    # the optimizer's share: both models' chains on stand-in grads, timed apart
    opt_ms = []
    for _ in range(3):
        grads = [{n: torch.randn_like(p) * 1e-3 for n, p in s.params.items()} for s in (unet_state, te_state)]
        ms, _ = host_ms(lambda: [s.apply_gradients(g) for s, g in zip((unet_state, te_state), grads)])
        opt_ms.append(ms)
        del grads
    p50 = statistics.median(timed)
    finite = all(torch.isfinite(torch.tensor(losses)).tolist())
    row = dict(
        batch=TRAIN_BATCH, resolution=TRAIN_RES, dtype=dtype, setup_s=setup_s,
        warmup_ms=step_ms, step_ms=timed, p50_ms=p50, images_per_s=TRAIN_BATCH / p50 * 1e3,
        losses=losses, finite=finite, max_memory_allocated=peak,
        momentum_codes_changed_after_step_1=codes_changed, momentum_codes=codes_total,
        launches=launches, expected_launches=expected, grad_copies_before_lion=grad_copies,
        flash_fwd_launches_by_route=fwd_routes, expected_flash_fwd_routes=expected_routes,
        launches_per_step={k: v / steps for k, v in launches.items()},
        launches_by_shape={
            kernel: {"x".join(map(str, k)): n for k, n in shapes.items()} for kernel, shapes in by_shape.items()
        },
        optimizer_ms_median=statistics.median(opt_ms), optimizer_ms=opt_ms,
        optimizer_share=statistics.median(opt_ms) / p50,
    )
    emit(phase, **row)
    state[phase] = row
    state[f"{phase}_by_shape"] = by_shape
    if not (finite and codes_changed > 0 and launches == expected and fwd_routes == expected_routes
            and grad_copies == 0):
        raise AssertionError(f"{phase} step failed its checks")
    profile = profile_step(step, f"one SD1.5 train step ({dtype}, batch 8, 512x512)", top=20)
    if phase == "train":
        buckets = {}
        for res in TRAIN_BUCKETS:
            by_shape = train_bucket(res, step, unet_state.model, seed + 2 + res)
            add_launches(buckets, by_shape)
        state["train_buckets_by_shape"] = buckets
    if phase == "train" and "trace_audit" in state["phases"]:
        state["train_step"], state["train_profile"] = step, profile  # trace_audit's, which frees the step


# the example config's buckets (model_properties_example.json's
# image_area_root and minimum_axis_length) that train steps at beside
# 512x512: their 640-channel level (8 heads of 80; 52x52 and 68x68 latents,
# 2,704 and 4,624 keys) goes to the flash kernels and its backward to the
# wide-head fused kernel
TRAIN_BUCKETS = (832, 1088)
TRAIN_BUCKET_WARMUP, TRAIN_BUCKET_STEPS = 2, 3


def train_bucket(res, step, unet, seed):
    """The SD1.5 bf16 train step (``phase_train``'s ``step``, its state) at
    the ``res`` x ``res`` bucket, batch 8, without gradient checkpointing
    as the example config trains (1088x1088 peaks at ~44 GB): 2 warm-ups
    and 3 timed steps, the launch counts zeroed just before those and read
    just after. Per step K1 5 times on the narrow kernel at level 0 (320
    channels, heads of 40), 5 on the wide one at level 1 (640 channels,
    heads of 80) and once in the VAE encode; the fused backward 5 at level
    0 and the wide-head one 5 at level 1; the CUDA-core pair and the f32
    backward never; Lion's leaf table twice. Returns the timed steps'
    launches by shape."""
    import gc

    import torch

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {
        "pixel_values": torch.rand(TRAIN_BATCH, 3, res, res, generator=gen, device="cuda") * 2 - 1,
        "input_ids": torch.randint(0, 49408, (TRAIN_BATCH * TRAIN_CONCAT, 77), generator=gen, device="cuda"),
    }
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    warm = [host_ms(lambda: step(batch)) for _ in range(TRAIN_BUCKET_WARMUP)]
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    timed = [host_ms(lambda: step(batch)) for _ in range(TRAIN_BUCKET_STEPS)]
    launches = train_launches(fa, lk)
    by_shape = launch_snapshot(fa, lk)
    fwd_routes = dict(fa.flash_attention_fwd.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    n = TRAIN_BUCKET_STEPS
    l0, l1 = (res // 8) ** 2, (res // 16) ** 2
    want_shapes = dict(
        flash_fwd={(64, l0, l0, 40, "bfloat16", "tma_narrow"): 5 * n, (64, l1, l1, 80, "bfloat16", "tma_wide"): 5 * n,
                   (TRAIN_BATCH, l0, l0, 512, "bfloat16", "tma_wide"): n},
        flash_bwd_fused={(64, l0, l0, 40, "bfloat16"): 5 * n},
        flash_bwd_fused_wide={(64, l1, l1, 80, "bfloat16"): 5 * n},
    )
    want = dict(flash_fwd=11 * n, flash_bwd_fused=5 * n, flash_bwd_fused_wide=5 * n, flash_bwd_f32=0,
                flash_bwd_dq=0, flash_bwd_dkv=0, lion_leaves=2 * n, lion_single=0, lion_multi=0)
    losses = [loss.item() for _, loss in warm + timed]
    ms = [t for t, _ in timed]
    p50 = statistics.median(ms)
    finite = all(map(math.isfinite, losses))
    ok = finite and launches == want and all(by_shape[k] == v for k, v in want_shapes.items())
    emit(
        "train_bucket", resolution=[res, res], batch=TRAIN_BATCH, dtype="bfloat16",
        gradient_checkpointing=unet.gradient_checkpointing, level1_keys=l1, warmup_ms=[t for t, _ in warm],
        step_ms=ms, p50_ms=p50, images_per_s=TRAIN_BATCH / p50 * 1e3, losses=losses, finite=finite,
        max_memory_allocated=peak, launches=launches, expected_launches=want, flash_fwd_launches_by_route=fwd_routes,
        launches_by_shape={kernel: {"x".join(map(str, k)): v for k, v in shapes.items()}
                           for kernel, shapes in by_shape.items() if shapes},
        ok=ok,
    )
    if not ok:
        raise AssertionError(f"train at {res}x{res} failed its checks")
    return {k: v for k, v in by_shape.items() if v}


def train_launches(fa, lk):
    """The launch counts of the train step's kernels, by wrapper."""
    return {kernel: wrapper.launches for kernel, wrapper in launch_wrappers(fa, lk).items()}


AUDIT_TOP = 12
PORT_CATEGORIES = ("flash kernel", "lion kernel")


def expected_bounds(moved, state, fa, lk):
    """The flash and Lion bounds of a run's launches (``launch_diff``):
    each shape's launches times the ``kernels`` phase's bound at that shape
    (the wrapper's own ``launch_work`` where that phase did not run it), by
    category; and the shapes whose bound came from the ``kernels`` phase."""
    rows = {}
    for r in state.get("kernel_cases", []):
        rows[("flash_fwd", *r["shape_q"], r["shape_k"][1], r["dtype"])] = r["bound_ms"]
    for r in state.get("bwd_cases", []):
        wrapper = {"fused": "flash_bwd_fused", "fused_wide": "flash_bwd_fused_wide",
                   "f32_fused": "flash_bwd_f32"}.get(r["route"])
        if wrapper:
            rows[(wrapper, *r["shape_q"], r["shape_k"][1], r["dtype"])] = r["bound_ms"]
    for r in state.get("lion_model_cases", []):
        rows[("lion_leaves", r["elements"], r["dtype"])] = r["bound_ms"]
    wrappers = launch_wrappers(fa, lk)
    total = dict.fromkeys(PORT_CATEGORIES, 0.0)
    from_kernels_phase = []
    for kernel, shapes in moved.items():
        wrapper = wrappers[kernel]
        flash = wrapper.__module__ == fa.__name__
        for key, n in shapes.items():
            if flash:  # bh, sq, sk, d, dtype[, route]
                row_key = (kernel, key[0], key[1], key[3], key[2], key[4])
            else:  # the leaf table's: leaves, elements, bs, dtype
                row_key = (kernel, key[1], key[3]) if kernel == "lion_leaves" else None
            if row_key in rows:
                bound = rows[row_key]
                from_kernels_phase.append(list(map(str, row_key)))
            else:
                bound = (fa if flash else lk).launch_work(wrapper.__name__, key).bound()[0]
            total["flash kernel" if flash else "lion kernel"] += n * bound
    return total, from_kernels_phase


def reader_against_key_averages():
    """Check (b) on a small profile recorded as the audited step's is (host
    ops and shapes; ``key_averages()`` over the step's ~180k events took
    ~17 s): a matmul inside an annotation, a convolution, a memset, copies
    both ways, a reduction and a cast. Returns the reader's device ms by
    name, ``device_kernels``' of the same profile, and the names whose ms
    differ by more than 1%."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_training_tpu_torch.utils import kernel_trace

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(2048, 2048, device=dev, dtype=torch.bfloat16, generator=gen)
    x = torch.randn(8, 320, 64, 64, device=dev, dtype=torch.bfloat16, generator=gen)
    w = torch.randn(320, 320, 3, 3, device=dev, dtype=torch.bfloat16, generator=gen)
    host = torch.randn(1 << 22)

    def run():
        with torch.profiler.record_function("reader_check"):
            b = a @ a
        y = F.conv2d(x, w, padding=1)
        z = torch.zeros(1 << 22, device=dev)
        z.copy_(host)
        return (y.float().sum() + b.float().sum() + z.sum()).cpu()

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    path = os.path.join(REPO, "chiprun_out", f"reader_check_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        trace = kernel_trace.load_trace(path)
    finally:
        os.remove(path)
    reader = {n: us / 1e3 for n, (us, _) in kernel_trace.op_durations(trace).items()}
    annotations = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    averages = {}
    for ms, _, name in device_kernels(prof):
        if name not in annotations:
            averages[name] = averages.get(name, 0.0) + ms
    off = {n: (reader.get(n, 0.0), averages.get(n, 0.0)) for n in set(reader) | set(averages)
           if abs(reader.get(n, 0.0) - averages.get(n, 0.0)) > 0.01 * max(reader.get(n, 0.0), averages.get(n, 0.0))}
    return reader, averages, off


def audit_trace(trace, moved, state, wall_ms, fa, lk):
    """Read one profiled step's Chrome trace with the package and check it:
    ``moved``, the wrappers' launches in the step (``launch_diff``). Prints
    the category report and the top ops; returns the table, the top ops,
    the checks (a), (c) and (d), and what they read."""
    from stable_diffusion_training_tpu_torch.utils import kernel_trace, roofline

    linked = kernel_trace.kernel_ops(trace)
    index = roofline.parse_ops(trace, linked)
    table = dict(kernel_trace.category_table(trace, steps=1), roofline=kernel_trace.category_roofline(index, 1))
    print(kernel_trace.category_report(trace, steps=1, wall_ms=wall_ms, index=index), flush=True)
    # the ops with the most device time, those of one name and shapes together
    groups = {}
    for op_id in index.kernels:
        op = index.ops[op_id]
        dims = op.get("args", {}).get("Input Dims")
        launch = roofline.parse_launch(op["name"])  # a launch shows its label, not its work
        g = groups.setdefault((op["name"], json.dumps(dims)), dict(
            op=(launch[0] if launch else op["name"])[:100], input_dims=dims, calls=0, kernels=0, device_ms=0.0,
            bound_ms=None, bound_by=index.bound_by(op_id)))
        g["calls"] += 1
        g["kernels"] += len(index.kernels[op_id])
        g["device_ms"] += index.device_ms(op_id)
        if index.bound_ms(op_id) is not None:
            g["bound_ms"] = (g["bound_ms"] or 0.0) + index.bound_ms(op_id)
    top = sorted(groups.values(), key=lambda g: -g["device_ms"])[:AUDIT_TOP]
    for g in top:
        g["share"] = g["bound_ms"] / g["device_ms"] if g["bound_ms"] is not None and g["device_ms"] > 0 else None
    print(f"top {AUDIT_TOP} ops by device time, calls of one op and shapes together (roofline share = bound / "
          f"device ms; {state['smi']}):")
    for g in top:
        share = "  n/a" if g["share"] is None else f"{g['share']:.3f}"
        print(f"  {g['device_ms']:8.3f} ms  share {share}  x{g['calls']:<4d} {g['op']}  {g['input_dims']}")
    # (a) the launches in the trace (each a named launch around the flash or
    # Lion kernels it started) against the wrappers' counts
    launch_ops, families, stray = {}, {}, 0
    for e, op in linked:
        cat = kernel_trace.categorize(e["name"])
        if cat not in PORT_CATEGORIES:
            continue
        fam = kernel_trace.family_of(e["name"])
        families[fam] = families.get(fam, 0) + 1
        parsed = op and roofline.parse_launch(op["name"])
        if parsed:
            launch_ops[op.get("args", {}).get("External id", id(op))] = (parsed[0], cat)
        else:
            stray += 1
    traced = {}
    for label, _ in launch_ops.values():
        traced[label] = traced.get(label, 0) + 1
    wrappers = launch_wrappers(fa, lk)
    counted = {roofline.launch_label(wrappers[kernel].__name__, key): n
               for kernel, shapes in moved.items() for key, n in shapes.items()}
    # (c) roofline shares: above 1 is a miscount
    op_shares = [s for s in map(index.share, index.work) if s is not None]
    over = [dict(op=index.ops[i]["name"][:100], share=index.share(i), device_ms=index.device_ms(i),
                 bytes=index.kernel_bytes(i), input_dims=index.ops[i].get("args", {}).get("Input Dims"))
            for i in index.work if (index.share(i) or 0) > 1.0]
    cat_over = {c: r["share"] for c, r in table["roofline"].items() if (r["share"] or 0) > 1.0}
    # (d) the step's flash and Lion bounds, from the trace's named launches
    # and from the wrappers' counts
    traced_bounds = dict.fromkeys(PORT_CATEGORIES, 0.0)
    for op_id, (_, cat) in launch_ops.items():
        traced_bounds[cat] += index.bound_ms(op_id)
    want_bounds, from_kernels_phase = expected_bounds(moved, state, fa, lk)
    checks = dict(
        launches=traced == counted and stray == 0 and bool(counted),
        roofline_shares_at_most_1=not over and not cat_over and bool(op_shares),
        bounds=all(math.isclose(traced_bounds[c], want_bounds[c], rel_tol=1e-9) and want_bounds[c] > 0
                   for c in want_bounds),
    )
    return table, top, checks, dict(
        launches=counted, traced_launches=traced, traced_families=families, kernels_outside_launches=stray,
        ops_with_work=len(index.work), max_op_share=max(op_shares) if op_shares else None,
        ops_share_over_0_9=sum(x > 0.9 for x in op_shares), shares_over_1=over[:10],
        categories_over_1=cat_over, bounds_from_trace=traced_bounds, bounds_from_launches=want_bounds,
        bound_shapes_from_kernels_phase=from_kernels_phase,
    )


def phase_trace_audit(state):
    """The ``train`` phase's bf16 step under torch.profiler with the host's
    ops and shapes recorded, read with ``utils.kernel_trace`` and
    ``utils.roofline``: the category report and top ops printed, then the
    four checks (launches, the reader's device ms against ``key_averages``
    on a small profile recorded the same way, no roofline share above 1,
    the flash and Lion bounds); the idle share beside that of ``train``'s
    device-only ``profile_step`` of the same step."""
    import gc
    import gzip

    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.utils import kernel_trace

    step = state.pop("train_step", None)
    if step is None:
        raise AssertionError("trace_audit profiles the train phase's bf16 step: run train before it")
    device_only = state.pop("train_profile")  # profile_step of the same step, the device alone traced
    out_dir = os.path.join(REPO, "chiprun_out")
    started = time.perf_counter()
    before = launch_snapshot(fa, lk)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        wall_ms, _ = host_ms(step)
    moved = launch_diff(launch_snapshot(fa, lk), before)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    marks = dict(profiled_s=time.perf_counter() - started)
    path = os.path.join(out_dir, "trace_audit.json")
    prof.export_chrome_trace(path)
    del prof
    marks["exported_s"] = time.perf_counter() - started
    trace = kernel_trace.load_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb", compresslevel=1) as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    marks["loaded_s"] = time.perf_counter() - started
    table, top, checks, read = audit_trace(trace, moved, state, wall_ms, fa, lk)
    marks["audited_s"] = time.perf_counter() - started
    reader, averages, off = reader_against_key_averages()
    checks["device_ms_match_key_averages"] = not off and bool(reader)
    busy_ms = table["busy_ms"]
    row = dict(
        what="one SD1.5 train step (bfloat16, batch 8, 512x512)", nvidia_smi=state["smi"],
        wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=table["idle_share"],
        idle_share_of_wall=1 - busy_ms / wall_ms, device_only={
            k: device_only[k] for k in ("wall_ms", "device_busy_ms", "idle_share")},
        serialized=table["serialized"], collective_streams=table["collective_streams"],
        roofline=table["roofline"], top_ops=top, **read, reader_check_ms=reader,
        device_ms_off_key_averages=off, trace_events=len(trace["traceEvents"]),
        trace_file=os.path.relpath(path + ".gz", REPO), trace_gz_bytes=os.path.getsize(path + ".gz"),
        **marks, seconds=time.perf_counter() - started, checks=checks, ok=all(checks.values()),
    )
    emit("trace_audit", **row)
    if not row["ok"]:
        raise AssertionError(f"trace_audit failed its checks: {checks}")


TRAINER_STEPS = 3  # steps per chunk (the example config's chunks run to the loader's end)
# kernels the bf16 step never launches: the f32 and CUDA-core backwards, and
# Lion's earlier entries (the leaf table takes every SD1.5 leaf)
OFF_BF16_STEP = ("flash_bwd_fused_wide", "flash_bwd_f32", "flash_bwd_dq", "flash_bwd_dkv", "lion_single",
                 "lion_multi")


def _tree_bytes(path):
    total = 0
    for root, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:  # deleted between the walk and the stat (rotation)
                pass
    return total


def trainer_run(name, training_config, seed, **fields):
    """A fresh run directory ``.cache/<name>`` holding the trainer's JSON
    config: ``training_config``'s fields and one chunk's run settings, a
    checkpoint base ``ckpt/run@0``. Returns (run directory, checkpoint base,
    config dict, config path, free disk bytes)."""
    import shutil

    run_dir = os.path.join(REPO, ".cache", name)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    base = os.path.join(run_dir, "ckpt", "run")
    cfg = dict(
        training_config.__dict__,
        model_path=f"{base}@0", test_save_path=os.path.join(run_dir, "probe"),
        loss_csv=os.path.join(run_dir, "loss.csv"), master_seed=seed, chunk_number=0,
        chunk_limit=1, chunk_steps=0, keep_trained_model_buffer=1, loss_logging_interval=1,
        DEBUG=False, numb_of_prefetched_batch=1, **fields,
    )
    config_path = os.path.join(run_dir, "model_properties.json")
    with open(config_path, "w") as f:
        json.dump(cfg, f)
    return run_dir, base, cfg, config_path, shutil.disk_usage(run_dir).free


class SaveWatch:
    """Instrumentation of one trainer run, from construction to ``stop()``:
    the seconds and bytes of each ``save_model`` and ``save_train_state``
    (the trainer's own calls, wrapped), and the run directory's peak size
    (sampled every 0.2 s)."""

    def __init__(self, trainer, run_dir):
        import threading

        self.trainer, self.run_dir = trainer, run_dir
        self.saved = (trainer.save_model, trainer.save_train_state)
        self.timings = {"save_model": [], "save_train_state": []}
        trainer.save_model = self._timed("save_model", trainer.save_model)
        trainer.save_train_state = self._timed("save_train_state", trainer.save_train_state)
        self.peak = 0
        self._stop = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._watcher.start()

    def _timed(self, name, fn):
        def wrapper(*args, **kwargs):
            import torch

            out_dir = kwargs.get("output_dir") or args[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.timings[name].append(dict(s=time.perf_counter() - t0, bytes=_tree_bytes(out_dir)))
            return out
        return wrapper

    def _watch(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, _tree_bytes(self.run_dir))
            self._stop.wait(0.2)

    def stop(self):
        self._stop.set()
        self._watcher.join(timeout=10)
        self.trainer.save_model, self.trainer.save_train_state = self.saved

    def row(self):
        return dict(
            save_model_s=[t["s"] for t in self.timings["save_model"]],
            save_train_state_s=[t["s"] for t in self.timings["save_train_state"]],
            save_model_bytes=[t["bytes"] for t in self.timings["save_model"]],
            save_train_state_bytes=[t["bytes"] for t in self.timings["save_train_state"]],
            bytes_written=sum(t["bytes"] for ts in self.timings.values() for t in ts),
            peak_disk_bytes=self.peak,
        )


def phase_trainer(state, seed=0):
    """The port's trainer at full width through ``trainer.main``: one chunk,
    then a resume from its ``train_state/``, with the artifacts checked."""
    import gc
    import shutil

    import numpy as np
    import torch

    from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader
    from stable_diffusion_training_tpu_torch.models import configs, hf_io
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.train import trainer
    from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file

    gc.collect()
    torch.cuda.empty_cache()
    set_tf32(False)
    run_dir, base, cfg, config_path, free_before = trainer_run(
        "chip_smoke_trainer", train_config(), seed, device_prefetch_depth=2,
    )
    restored_ok = []  # the restored momentum held against the files it came from

    def checked_restore(directory, template):
        restored = restore(directory, template)
        for part in ("unet_state", "text_encoder_state"):
            saved = hf_io.load_safetensors(os.path.join(directory, f"{part}.safetensors"))
            for name, m in restored[part].opt_state[1][0].mu_quant.items():
                if hasattr(m, "codes"):
                    key = f"{part}/opt_state/1/0/mu_quant/{name}"
                    restored_ok.append(
                        torch.equal(m.codes.cpu(), saved[f"{key}/codes"])
                        and torch.equal(m.scales.cpu(), saved[f"{key}/scales"])
                    )
            del saved
        return restored

    restore = trainer.restore_train_state
    trainer.restore_train_state = checked_restore
    watch = SaveWatch(trainer, run_dir)
    vocab = configs.MODEL_FAMILIES[cfg["model_family"]]["text_encoder"]["vocab_size"]
    try:
        fa.reset_launch_counts()
        lk.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(2):  # one chunk, then the resume on the mutated JSON
            loader = InMemoryDataLoader.synthetic(
                TRAINER_STEPS, TRAIN_BATCH, [(TRAIN_RES, TRAIN_RES)], concat_count=TRAIN_CONCAT,
                vocab_size=vocab, seed=seed,
            )
            trainer.main(config_path, dataloader=loader, tokenizer=None)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = train_launches(fa, lk)
    finally:
        watch.stop()
        trainer.restore_train_state = restore

    final = read_json_file(config_path)
    backup = read_json_file(os.path.join(run_dir, "backup_model_properties.json"))
    with open(cfg["loss_csv"]) as f:
        lines = f.read().splitlines()
    rows = [line.split(",") for line in lines[1:] if line]
    losses = [float(r[2]) for r in rows]
    # interval 1: each row's time is one step's, host clock; the first row
    # of each invocation also holds that invocation's first-step set-up
    step_s = [float(r[3]) for i, r in enumerate(rows) if i % TRAINER_STEPS]
    state_dir = os.path.join(f"{base}@1", trainer.TRAIN_STATE_SUBDIR)
    reload_equal = True
    for name, loader_fn in (("unet", hf_io.load_unet), ("text_encoder", hf_io.load_text_encoder)):
        model = loader_fn(os.path.join(f"{base}@1", name), device="cpu")
        saved = hf_io.load_safetensors(os.path.join(state_dir, f"{name}_state.safetensors"))
        for k, p in model.named_parameters():
            reload_equal = reload_equal and torch.equal(p, saved[f"{name}_state/params/{k}"].float())
        del model, saved
    checks = dict(
        json=(final["chunk_number"], final["chunk_steps"], final["master_seed"], final["model_path"])
        == (1, 2, seed + 2, f"{base}@1"),
        backup=backup["chunk_steps"] == 1 and backup["model_path"] == f"{base}@0",
        loss_csv=lines[0] == "steps, step_size, loss, time, chunk, seed"
        and len(rows) == 2 * TRAINER_STEPS and bool(np.all(np.isfinite(losses))),
        probe_deleted=not os.path.exists(cfg["test_save_path"])
        and not os.path.exists(cfg["test_save_path"] + "-EMA"),
        rotation=os.path.isdir(f"{base}@1") and not os.path.exists(f"{base}@0"),
        ema=os.path.isdir(f"{base}-EMA@1") and not os.path.exists(f"{base}-EMA@0"),
        reload_equal=reload_equal,
        restored_momentum_equal=bool(restored_ok) and all(restored_ok),
        # the bf16 step's kernels, and neither the f32 nor the CUDA-core backward
        kernels_launched=all(n for k, n in launches.items() if k not in OFF_BF16_STEP)
        and not any(launches[k] for k in OFF_BF16_STEP),
    )
    p50_ms = statistics.median(step_s) * 1e3
    train_p50 = state.get("train", {}).get("p50_ms")
    row = dict(
        steps=2 * TRAINER_STEPS, chunks=2, batch=TRAIN_BATCH, resolution=TRAIN_RES, dtype="bfloat16",
        wall_s=wall_s, losses=losses, step_ms=[x * 1e3 for x in step_s], p50_ms=p50_ms,
        train_phase_p50_ms=train_p50, ratio_to_train_phase=p50_ms / train_p50 if train_p50 else None,
        **watch.row(), disk_free_before=free_before, launches=launches,
        restored_momentum_leaves=len(restored_ok), checks=checks, ok=all(checks.values()),
    )
    emit("trainer", **row)
    shutil.rmtree(run_dir, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"trainer failed its checks: {checks}")


# SDXL training (BASELINE config 5): batch 4 from the offline latent cache,
# at 1024x1024 and the 1152x896 bucket. K1's and the fused backward's keys
# (bh, sq, sk, d, dtype): the 64x64 level (10 heads of 64, 2 layers: 4 down,
# 6 up) at batch 4, and the bucket's 72x56 level; the cache pass's
# per-sample VAE encode (its mid-block) at 128x128 and 144x112 latents; the
# f32 parity step's batch 1.
SDXL_TRAIN_BATCH, SDXL_BUCKET = 4, (1152, 896)
SDXL_TRAIN_KEYS = {"1024": (40, 4096, 4096, 64, "bfloat16"), "bucket": (40, 4032, 4032, 64, "bfloat16")}
SDXL_ENCODE_KEYS = {"1024": SDXL_VAE_KEY, "bucket": (1, 16128, 16128, 512, "bfloat16", "tma_wide")}
SDXL_PARITY_KEY = (10, 4096, 4096, 64, "float32")
SDXL_CACHE_DIR = os.path.join(REPO, ".cache", "chip_smoke_sdxl_cache")
# the cache's shards: (resolution, seed offset); the trainer phase's chunk
# is these three steps
SDXL_SHARDS = (((SDXL_RES, SDXL_RES), 0), (SDXL_BUCKET, 1), ((SDXL_RES, SDXL_RES), 2))


def sdxl_train_config(**overrides):
    """``train_config``'s example settings for SDXL training: the seeded
    ``sdxl`` family at batch 4, the 1024 tier (min side 512, so 1152x896 is
    a bucket), the latent cache with the frozen towers' context, pooled
    embeds and 6 time ids, gradient checkpointing; the frozen tower 1 keeps
    no EMA."""
    return train_config(**{
        **dict(model_path="sdxl", model_family="sdxl", batch_size=SDXL_TRAIN_BATCH,
               image_area_root=[SDXL_RES], minimum_axis_length=[512], use_latent_cache=True,
               cached_text_context=True, sdxl_micro_conditioning=True, train_text_encoder=False,
               gradient_checkpointing=True, accumulate_text_encoder_ema=False),
        **overrides,
    })


def sdxl_context_widths():
    """The SDXL UNet's context width (2048: both towers) and pooled width
    (1280: tower 2's projection)."""
    from stable_diffusion_training_tpu_torch.models import configs

    unet = configs.SDXL_UNET
    pooled = unet["projection_class_embeddings_input_dim"] - 6 * unet["addition_time_embed_dim"]
    return unet["cross_attention_dim"], pooled


def phase_sdxl_train_parity(state, seed=7):
    """One SDXL train step's loss and grads at full width in f32 (TF32 off):
    batch 1, 128x128 cached moments, a 227-token 2048-wide context, pooled
    1280 and 6 time ids, the draws injected, through the step's own loss
    (``train_step._loss``) and grads. "auto" (K1 on route f32 and the fused
    f32 backward, each 10 times at (10, 4096, 64)) against "xla" (plain
    attention, a model holding the same tensors): the loss within
    ``TRAIN_LOSS_REL_TOL``, each grad within ``TRAIN_GRAD_REL_TOL`` of its
    tensor's max |grad|, the add-embedding's grads non-zero."""
    import gc
    from types import SimpleNamespace

    import torch

    from stable_diffusion_training_tpu_torch.diffusion import DDPMScheduler
    from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel, configs
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.train.states import FrozenModel
    from stable_diffusion_training_tpu_torch.train.train_step import _grads, _loss, make_draws

    gc.collect()
    torch.cuda.empty_cache()
    set_tf32(False)
    unet = seeded_models(seed, torch.float32, unet=(UNet2DConditionModel, configs.SDXL_UNET))["unet"]
    plain = UNet2DConditionModel(**configs.SDXL_UNET, attention_backend="xla", device="meta")
    plain.load_state_dict(unet.state_dict(), strict=True, assign=True)
    sched = DDPMScheduler(beta_start=0.00085, beta_end=0.012, beta_schedule="zero_snr_scaled_linear",
                          num_train_timesteps=1000, prediction_type="v_prediction", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    latent = SDXL_RES // 8
    mean = torch.randn(1, 4, latent, latent, generator=gen, device="cuda")
    logvar = torch.randn(1, 4, latent, latent, generator=gen, device="cuda") * 0.1 - 6.0
    context, pooled = sdxl_context_widths()
    batch = {
        "latent_moments": torch.cat([mean, logvar], dim=1),
        "encoder_hidden_states": torch.randn(1, 227, context, generator=gen, device="cuda"),
        "pooled_text_embeds": torch.randn(1, pooled, generator=gen, device="cuda"),
        "time_ids": torch.tensor([[SDXL_RES, SDXL_RES, 0, 0, SDXL_RES, SDXL_RES]], device="cuda").float(),
    }
    draws = make_draws(gen, mean.shape, torch.float32, 1000, "cuda")
    kw = dict(strip_bos_eos_token=True, offset_noise_magnitude=0.0, min_snr_gamma_magnitude=0.0,
              perturbation_noise_magnitude=0.0, text_context_window=77, train_text_encoder=False,
              vae_encode_chunk=0)
    frozen = (FrozenModel(call=None, params=None), FrozenModel(call=sched, params=sched.create_state()))
    names = [n for n, _ in unet.named_parameters()]

    def loss_and_grads(model):
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        loss = _loss(SimpleNamespace(model=model), None, *frozen, batch, None, draws, **kw)
        grads = _grads(loss, dict(model.named_parameters()))
        torch.cuda.synchronize()
        launches = dict(fwd=fa.flash_attention_fwd.launches, fwd_routes=dict(fa.flash_attention_fwd.launches_by_route),
                        **bwd_launches(fa))
        by_shape = dict(flash_fwd=dict(fa.flash_attention_fwd.launches_by_shape),
                        flash_bwd_f32=dict(fa.flash_attention_bwd_f32_fused.launches_by_shape))
        return loss.item(), grads, launches, by_shape, torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    loss_k, grads_k, launches_k, by_shape, peak_k = loss_and_grads(unet)
    kernel_s = time.perf_counter() - t0
    state["sdxl_train_parity_by_shape"] = by_shape
    grads_k = [g.cpu() for g in grads_k]  # room on the card for the plain run's
    t0 = time.perf_counter()
    loss_p, grads_p, launches_p, _, peak_p = loss_and_grads(plain)
    plain_s = time.perf_counter() - t0
    worst, worst_name, add_embedding_max = 0.0, None, {}
    for name, gk, gp in zip(names, grads_k, grads_p):
        gk = gk.cuda()
        ref = gp.abs().max().item()
        rel = (gk - gp).abs().max().item() / max(ref, 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
        if name.startswith("add_embedding."):
            add_embedding_max[name] = min(gk.abs().max().item(), ref)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    kernel_launches = dict(fwd=10, fwd_routes={"f32": 10}, bwd_fused=0, bwd_fused_wide=0, bwd_f32=10, bwd_dq=0,
                           bwd_dkv=0)
    plain_launches = dict(fwd=0, fwd_routes={}, bwd_fused=0, bwd_fused_wide=0, bwd_f32=0, bwd_dq=0, bwd_dkv=0)
    want_shapes = dict(flash_fwd={SDXL_PARITY_KEY + ("f32",): 10}, flash_bwd_f32={SDXL_PARITY_KEY: 10})
    ok = (
        math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL_TOL and worst <= TRAIN_GRAD_REL_TOL
        and launches_k == kernel_launches and launches_p == plain_launches and by_shape == want_shapes
        and len(add_embedding_max) == 4 and all(v > 0 for v in add_embedding_max.values())
    )
    emit(
        "sdxl_train_parity", dtype="float32", batch=1, resolution=SDXL_RES, loss_kernel=loss_k, loss_plain=loss_p,
        loss_rel_diff=loss_rel, loss_rel_tol=TRAIN_LOSS_REL_TOL, worst_grad_rel_diff=worst, worst_grad=worst_name,
        grad_rel_tol=TRAIN_GRAD_REL_TOL, n_grads=len(names), add_embedding_grad_max=add_embedding_max,
        kernel_launches=launches_k, plain_launches=launches_p,
        launches_by_shape={k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in by_shape.items()},
        max_memory_allocated_kernel=peak_k, max_memory_allocated_plain=peak_p, kernel_s=kernel_s, plain_s=plain_s,
        ok=ok,
    )
    del unet, plain, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("full-width SDXL training step: kernel and plain attention disagree")


def sdxl_latent_cache(seed=0):
    """SDXL training's offline pass: ``precompute_latent_cache`` over
    ``SDXL_SHARDS`` (4 synthetic images each) with seeded bf16 towers 1 and
    2 and the SDXL VAE, into ``SDXL_CACHE_DIR``: the moments (per-sample
    encodes at >= 768 px), tower 2's pooled embeds, 6 time ids and both
    towers' penultimate context over 3 windows. Returns the loader and the
    ``sdxl_cache`` line; K1 must run once per image, at its resolution's
    mid-block shape."""
    import shutil

    import torch

    from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader, precompute_latent_cache, synthetic_batch
    from stable_diffusion_training_tpu_torch.models import (
        AutoencoderKL, CLIPTextModel, CLIPTextModelWithProjection, configs,
    )
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    shutil.rmtree(SDXL_CACHE_DIR, ignore_errors=True)
    models = seeded_models(
        seed, torch.bfloat16, vae=(AutoencoderKL, configs.SDXL_VAE), text_encoder=(CLIPTextModel, configs.CLIP_VIT_L),
        text_encoder_2=(CLIPTextModelWithProjection, dict(configs.OPEN_CLIP_VIT_BIGG, eos_token_id=2)),
    )
    pixels = InMemoryDataLoader([
        synthetic_batch(SDXL_TRAIN_BATCH, res, concat_count=TRAIN_CONCAT, seed=seed + i) for res, i in SDXL_SHARDS
    ])
    images = SDXL_TRAIN_BATCH * len(SDXL_SHARDS)
    fa.reset_launch_counts()
    ms, loader = host_ms(lambda: precompute_latent_cache(
        pixels, models["vae"], SDXL_CACHE_DIR, text_encoder_2=models["text_encoder_2"],
        text_encoder=models["text_encoder"], concat_count=TRAIN_CONCAT, penultimate=True,
    ))
    by_shape = dict(fa.flash_attention_fwd.launches_by_shape)
    want = {SDXL_ENCODE_KEYS["1024"]: 2 * SDXL_TRAIN_BATCH, SDXL_ENCODE_KEYS["bucket"]: SDXL_TRAIN_BATCH}
    loader.dispatch_worker()
    shard = loader.grab_next_batch()
    shapes = {k: list(v.shape) for k, v in shard.items()}
    dtypes = {k: str(v.dtype) for k, v in shard.items()}
    row = dict(
        images=images, shards=loader._bulk_batch_count, ms_per_image=ms / images, total_ms=ms,
        launches_by_shape={"x".join(map(str, k)): n for k, n in by_shape.items()},
        expected_launches_by_shape={"x".join(map(str, k)): n for k, n in want.items()},
        shard_shapes=shapes, shard_dtypes=dtypes,
        cache_bytes=_tree_bytes(SDXL_CACHE_DIR),
    )
    context, pooled = sdxl_context_widths()
    ok = (by_shape == want and loader._bulk_batch_count == len(SDXL_SHARDS)
          and shapes["latent_moments"] == [SDXL_TRAIN_BATCH, 8, SDXL_RES // 8, SDXL_RES // 8]
          and shapes["encoder_hidden_states"] == [SDXL_TRAIN_BATCH, 227, context]
          and shapes["pooled_text_embeds"] == [SDXL_TRAIN_BATCH, pooled] and shapes["time_ids"] == [SDXL_TRAIN_BATCH, 6])
    del models
    torch.cuda.empty_cache()
    return loader, dict(row, ok=ok), by_shape


def phase_sdxl_train(state, warmup=2, steps=5, bucket_steps=2, seed=0):
    """SDXL training at full width: the offline cache pass, then the bf16
    step through ``on_device_model_training_state`` and the bucketed step of
    ``train.aot`` (example settings, batch 4, gradient checkpointing, the
    frozen towers' context from the cache): 2 warm-up and 5 timed steps at
    1024x1024, 2 at 1152x896, each window's launches counted; the Lion
    update of one step's grads held to its plain version; the optimizer
    chain's host time; one step profiled."""
    import gc

    import torch

    from stable_diffusion_training_tpu_torch.models import hf_io
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.optim import QuantizedMomentum
    from stable_diffusion_training_tpu_torch.optim.lion8bit import GRAD_COPIES
    from stable_diffusion_training_tpu_torch.train import (
        batch_dispatch_key, bucket_train_steps, on_device_model_training_state,
    )
    from stable_diffusion_training_tpu_torch.train.train_step import _grads, _loss

    gc.collect()
    torch.cuda.empty_cache()
    set_tf32(False)
    loader, cache_row, cache_by_shape = sdxl_latent_cache(seed)
    emit("sdxl_cache", **cache_row)
    state["sdxl_cache_by_shape"] = cache_by_shape
    if not cache_row["ok"]:
        raise AssertionError("SDXL latent cache pass failed its checks")

    cfg = sdxl_train_config()
    t0 = time.perf_counter()
    states = on_device_model_training_state(cfg)
    setup_s = time.perf_counter() - t0
    unet_state, te_state, unet_ema, te_ema, frozen_vae, frozen_sched, _ = states
    table = bucket_train_steps(cfg, frozen_vae)
    batches = []
    loader.dispatch_worker()
    while not isinstance(b := loader.grab_next_batch(), str):
        batches.append({k: torch.from_numpy(v).cuda() for k, v in b.items()})
    square = [b for b in batches if b["latent_moments"].shape[-1] == SDXL_RES // 8]
    bucket = [b for b in batches if b["latent_moments"].shape[-1] != SDXL_RES // 8]
    train_rng = torch.Generator(device="cuda").manual_seed(seed + 1)

    def step(batch):
        out = table[batch_dispatch_key(batch)](
            unet_state, te_state, unet_ema, te_ema, batch, train_rng, frozen_vae, frozen_sched,
        )
        return out[4]["loss"]

    def window(batches, n):
        """``n`` steps over ``batches`` with the counts zeroed just before and
        read just after: (ms, losses, launches, by_shape, routes, copies)."""
        fa.reset_launch_counts()
        lk.reset_launch_counts()
        GRAD_COPIES["count"] = 0
        ms, losses = [], []
        for i in range(n):
            t, loss = host_ms(lambda: step(batches[i % len(batches)]))
            ms.append(t)
            losses.append(loss.item())
        by_shape = dict(
            flash_fwd=dict(fa.flash_attention_fwd.launches_by_shape),
            flash_bwd_fused=dict(fa.flash_attention_bwd_fused.launches_by_shape),
            lion_leaves=dict(lk.lion8bit_update_leaves_.launches_by_shape),
        )
        return (ms, losses, train_launches(fa, lk), by_shape, dict(fa.flash_attention_fwd.launches_by_route),
                GRAD_COPIES["count"])

    unet = unet_state.model
    add_before = {n: p.detach().clone() for n, p in unet.named_parameters() if n.startswith("add_embedding.")}
    torch.cuda.reset_peak_memory_stats()
    ms, loss = host_ms(lambda: step(square[0]))  # step 1: momentum leaves its zero state
    warmup_ms, losses = [ms], [loss.item()]
    moms = [m for m in unet_state.opt_state[1][0].mu_quant.values() if isinstance(m, QuantizedMomentum)]
    codes_changed = sum(int((m.codes != 3).sum()) for m in moms)
    codes_total = sum(m.codes.numel() for m in moms)
    for _ in range(warmup - 1):
        ms, loss = host_ms(lambda: step(square[0]))
        warmup_ms.append(ms)
        losses.append(loss.item())
    timed, timed_losses, launches, by_shape, routes, copies = window(square, steps)
    peak = torch.cuda.max_memory_allocated()
    b_ms, b_losses, b_launches, b_by_shape, b_routes, b_copies = window(bucket, bucket_steps)
    add_moved = {n: (p.detach() != add_before[n]).any().item() for n, p in unet.named_parameters() if n in add_before}
    del add_before

    leaves = sdxl_quantized_leaves()
    lion = lion_table_launches(leaves, "bfloat16")
    per_step = sum(lion.values())
    ok_launches = {}
    for name, n, lc, shapes, rts, cp, key in (
        ("1024", steps, launches, by_shape, routes, copies, SDXL_TRAIN_KEYS["1024"]),
        ("bucket", bucket_steps, b_launches, b_by_shape, b_routes, b_copies, SDXL_TRAIN_KEYS["bucket"]),
    ):
        # K1 20 a step (each of the 10 again in the blocks' recompute), the
        # fused bf16 backward 10, Lion's leaf table once per
        # MAX_LEAVES_PER_LAUNCH leaves; nothing else
        want = dict(flash_fwd=20 * n, flash_bwd_fused=10 * n, flash_bwd_fused_wide=0, flash_bwd_f32=0,
                    flash_bwd_dq=0, flash_bwd_dkv=0, lion_leaves=per_step * n, lion_single=0, lion_multi=0)
        want_shapes = dict(flash_fwd={key + ("tma_narrow",): 20 * n}, flash_bwd_fused={key: 10 * n},
                           lion_leaves={k: v * n for k, v in lion.items()})
        ok_launches[name] = lc == want and shapes == want_shapes and rts == {"tma_narrow": 20 * n}
    state["sdxl_train_by_shape"] = {  # both windows' launches
        kernel: {k: by_shape[kernel].get(k, 0) + b_by_shape[kernel].get(k, 0)
                 for k in {**by_shape[kernel], **b_by_shape[kernel]}}
        for kernel in by_shape
    }

    # one step's Lion update against its plain version: this step's grads
    # (the step's own loss) and the live momentum
    names = [n for n, _, _ in leaves]
    params = unet_state.params
    loss = _loss(unet_state, te_state, frozen_vae, frozen_sched, square[0], train_rng, None,
                 strip_bos_eos_token=True, offset_noise_magnitude=0.0, min_snr_gamma_magnitude=0.0,
                 perturbation_noise_magnitude=0.0, text_context_window=77, train_text_encoder=False,
                 vae_encode_chunk=0)
    grads = dict(zip(params, _grads(loss, params)))
    del loss
    # quantized leaves whose grad autograd hands over strided: Lion copies
    # each (GRAD_COPIES) before the leaf table reads it in torch layout
    strided = sorted(n for n in names if not grads[n].is_contiguous())
    mu = unet_state.opt_state[1][0].mu_quant
    paths = hf_io.jax_param_paths(unet)
    perms = [paths[n][1] for n in names]
    shapes = [tuple(params[n].shape) for n in names]
    codes = [mu[n].codes for n in names]
    scales = [mu[n].scales for n in names]
    leaf_grads = [grads[n].contiguous() for n in names]  # as the optimizer hands them over
    e_upd, e_codes, e_scales = lk.lion8bit_update_leaves_reference(leaf_grads, codes, scales, perms)
    lion_table = lk.LeafTable([c.clone() for c in codes], [s.clone() for s in scales], shapes, perms)
    upds = lk.lion8bit_update_leaves_(leaf_grads, lion_table)
    torch.cuda.synchronize()
    lion_hold = dict(
        leaves=len(names), elements=sum(math.prod(s) for s in shapes),
        updates_equal=all(bool(torch.equal(u, e)) for u, e in zip(upds, e_upd)),
        scales_equal=all(bool(torch.equal(s, e)) for s, e in zip(lion_table.scales, e_scales)),
        max_code_diff=max(int((c.int() - e.int()).abs().max()) for c, e in zip(lion_table.codes, e_codes)),
    )
    lion_hold["ok"] = lion_hold["updates_equal"] and lion_hold["scales_equal"] and lion_hold["max_code_diff"] <= 1
    del e_upd, e_codes, e_scales, lion_table, upds, leaf_grads
    torch.cuda.empty_cache()

    # the optimizer chain's host time (clip, Lion, lr, the update) on these grads
    opt_ms = []
    for _ in range(3):
        opt_ms.append(host_ms(lambda: unet_state.apply_gradients(grads))[0])
    del grads
    torch.cuda.empty_cache()

    p50 = statistics.median(timed)
    finite = all(math.isfinite(x) for x in losses + timed_losses + b_losses)
    row = dict(
        batch=SDXL_TRAIN_BATCH, resolution=SDXL_RES, bucket=list(SDXL_BUCKET), dtype="bfloat16",
        gradient_checkpointing=True, setup_s=setup_s, warmup_ms=warmup_ms, step_ms=timed, p50_ms=p50,
        images_per_s=SDXL_TRAIN_BATCH / p50 * 1e3, bucket_step_ms=b_ms,
        bucket_p50_ms=statistics.median(b_ms), losses=losses + timed_losses, bucket_losses=b_losses, finite=finite,
        max_memory_allocated=peak, momentum_codes_changed_after_step_1=codes_changed, momentum_codes=codes_total,
        add_embedding_moved=add_moved, launches=launches, bucket_launches=b_launches,
        launches_by_shape={k: {"x".join(map(str, s)): c for s, c in v.items()} for k, v in by_shape.items()},
        bucket_launches_by_shape={k: {"x".join(map(str, s)): c for s, c in v.items()} for k, v in b_by_shape.items()},
        grad_copies_before_lion=copies + b_copies, strided_quantized_grads=strided, lion_leaves_per_step=per_step,
        lion_hold=lion_hold,
        launches_ok=ok_launches, optimizer_ms=opt_ms, optimizer_ms_median=statistics.median(opt_ms),
        optimizer_share=statistics.median(opt_ms) / p50,
    )
    emit("sdxl_train", **row)
    if not (finite and codes_changed > 0 and len(add_moved) == 4 and all(add_moved.values())
            and all(ok_launches.values()) and lion_hold["ok"]
            and copies + b_copies == len(strided) * (steps + bucket_steps)):
        raise AssertionError("sdxl_train step failed its checks")
    profile_step(
        lambda: step(square[0]), "one SDXL train step (bf16, batch 4, 1024x1024, gradient checkpointing)", top=20
    )


def phase_sdxl_trainer(state, seed=0):
    """SDXL training through ``trainer.main`` over the ``CachedLatentLoader``
    of the ``sdxl_train`` phase (made here if that phase did not run): one
    chunk of its 3 shards (1024x1024, 1152x896, 1024x1024) with the
    checkpoint at its end. Checks: finite ``loss.csv`` rows, the JSON fields,
    the probe deleted, the chunk's ``unet/`` (with its ``add_embedding``) and
    its EMA variant reloaded through ``hf_io`` equal to the params and EMA
    saved in its ``train_state/``, that state restored into a fresh one, and
    the step's kernels launched (the f32 and CUDA-core backwards and Lion's
    earlier entries not)."""
    import gc
    import shutil

    import torch

    from stable_diffusion_training_tpu_torch.data import CachedLatentLoader
    from stable_diffusion_training_tpu_torch.models import hf_io
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.train import on_device_model_training_state, trainer
    from stable_diffusion_training_tpu_torch.train.checkpoint import restore_train_state
    from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file

    gc.collect()
    torch.cuda.empty_cache()
    set_tf32(False)
    if not os.path.isdir(SDXL_CACHE_DIR):
        sdxl_latent_cache(seed)
    training_config = sdxl_train_config()
    run_dir, base, cfg, config_path, free_before = trainer_run(
        "chip_smoke_sdxl_trainer", training_config, seed, device_prefetch_depth=2,
    )
    watch = SaveWatch(trainer, run_dir)
    try:
        fa.reset_launch_counts()
        lk.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.main(config_path, dataloader=CachedLatentLoader(SDXL_CACHE_DIR), tokenizer=None)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = train_launches(fa, lk)
    finally:
        watch.stop()
    gc.collect()
    torch.cuda.empty_cache()

    final = read_json_file(config_path)
    with open(cfg["loss_csv"]) as f:
        lines = f.read().splitlines()
    rows = [line.split(",") for line in lines[1:] if line]
    losses = [float(r[2]) for r in rows]
    ckpt = f"{base}@0"
    state_dir = os.path.join(ckpt, trainer.TRAIN_STATE_SUBDIR)
    t0 = time.perf_counter()
    saved = hf_io.load_safetensors(os.path.join(state_dir, "unet_state.safetensors"))
    saved_ema = hf_io.load_safetensors(os.path.join(state_dir, "unet_ema_params.safetensors"))
    reload_equal = {}
    for name, directory, tensors, prefix in (("unet", ckpt, saved, "unet_state/params"),
                                              ("unet_ema", f"{base}-EMA@0", saved_ema, "unet_ema_params")):
        model = hf_io.load_unet(os.path.join(directory, "unet"), device="cuda")
        reload_equal[name] = model.addition_embed_type == "text_time" and all(
            torch.equal(p, tensors[f"{prefix}/{k}"].cuda().float()) for k, p in model.named_parameters()
        ) and any(k.startswith("add_embedding.") for k, _ in model.named_parameters())
        del model
    reload_s = time.perf_counter() - t0
    # the saved full state into a fresh one, as a resume does
    t0 = time.perf_counter()
    template = on_device_model_training_state(training_config)
    restored = restore_train_state(state_dir, {
        "unet_state": template[0], "text_encoder_state": template[1], "unet_ema_params": template[2],
        "text_encoder_ema_params": {}, "train_rng": torch.Generator(device="cuda"),
    })
    restore_s = time.perf_counter() - t0
    restored_equal = all(
        torch.equal(p.cpu(), saved[f"unet_state/params/{k}"]) for k, p in restored["unet_state"].params.items()
    ) and all(
        torch.equal(m.codes.cpu(), saved[f"unet_state/opt_state/1/0/mu_quant/{k}/codes"])
        for k, m in restored["unet_state"].opt_state[1][0].mu_quant.items() if hasattr(m, "codes")
    )
    del saved, saved_ema, template, restored
    gc.collect()
    torch.cuda.empty_cache()
    off = ("flash_bwd_fused_wide", "flash_bwd_f32", "flash_bwd_dq", "flash_bwd_dkv", "lion_single", "lion_multi")
    checks = dict(
        json=(final["chunk_number"], final["chunk_steps"], final["master_seed"], final["model_path"])
        == (1, 1, seed + 1, ckpt),
        loss_csv=lines[0] == "steps, step_size, loss, time, chunk, seed" and len(rows) == len(SDXL_SHARDS)
        and all(math.isfinite(x) for x in losses),
        probe_deleted=not os.path.exists(cfg["test_save_path"]) and not os.path.exists(cfg["test_save_path"] + "-EMA"),
        unet_reload_equal=reload_equal["unet"], ema_reload_equal=reload_equal["unet_ema"],
        train_state_restores=restored_equal,
        kernels_launched=all(launches[k] for k in ("flash_fwd", "flash_bwd_fused", "lion_leaves"))
        and not any(launches[k] for k in off),
    )
    row = dict(
        steps=len(rows), chunks=1, batch=SDXL_TRAIN_BATCH, dtype="bfloat16", wall_s=wall_s, losses=losses,
        step_ms=[float(r[3]) * 1e3 for r in rows], **watch.row(), disk_free_before=free_before,
        reload_s=reload_s, restore_s=restore_s, launches=launches, checks=checks, ok=all(checks.values()),
    )
    emit("sdxl_trainer", **row)
    shutil.rmtree(run_dir, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"sdxl_trainer failed its checks: {checks}")


# SD2.1 at 768x768 (BASELINE config 3's model and resolution; config 2's
# in-loop DDIM eval): K1's and the fused backward's keys (bh, sq, sk, d,
# dtype). The 96x96 level has 5 heads of 64 (2 layers down, 3 up), the 48x48
# level 10 heads (2 down, 3 up; 2,304 keys, over FLASH_MIN_KEY); the 24x24
# level (576 keys) and the cross-attention stay on the plain path, as in the
# JAX package. The VAE mid-block runs one head of 512 at 96x96.
SD21_RES, SD21_MIN_AXIS, SD21_BATCH = 768, 512, 8
SD21_BUCKET = (896, 640)  # (w, h): 112x80 latents, 8,960 and 2,240 keys, both off the 128-row tiles
SD21_BATCHES_PER_BUCKET = 4
SD21_STEPS = 4  # DDIM steps of serving and of the in-loop eval


def sd21_keys(batch, w, h, dtype="bfloat16"):
    """K1's and the backward's keys at one batch and image size: the two
    flash levels of the UNet (the self-attentions of a CFG or train batch)
    and the VAE mid-block (one image's or the batch's encode)."""
    l1, l2 = (w // 8) * (h // 8), (w // 16) * (h // 16)
    return (5 * batch, l1, l1, 64, dtype), (10 * batch, l2, l2, 64, dtype), (batch, l1, l1, 512, dtype)


def phase_sd21_parity(state, seed=11):
    """SD2.1's UNet at full width in f32 (TF32 off), batch 1, 96x96
    latents: the forward with "auto" (K1 on route f32 at both flash levels)
    against "xla" (a model holding the same tensors) within
    ``PARITY_REL_TOL``; then one train step's loss and grads through the
    step's own loss (``train_step._loss``: cached moments, a 227-token
    1024-wide context, v-prediction on the zero-SNR schedule, the draws
    injected) within ``TRAIN_LOSS_REL_TOL`` and ``TRAIN_GRAD_REL_TOL``. K1 5
    times at (5, 9216, 64) and 5 at (10, 2304, 64) a forward, the fused f32
    backward the same."""
    import gc
    from types import SimpleNamespace

    import torch

    from stable_diffusion_training_tpu_torch.diffusion import DDPMScheduler
    from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel, configs
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.train.states import FrozenModel
    from stable_diffusion_training_tpu_torch.train.train_step import _grads, _loss, make_draws

    gc.collect()
    torch.cuda.empty_cache()
    set_tf32(False)
    unet = seeded_models(seed, torch.float32, unet=(UNet2DConditionModel, configs.SD21_UNET))["unet"]
    plain = UNet2DConditionModel(**configs.SD21_UNET, attention_backend="xla", device="meta")
    plain.load_state_dict(unet.state_dict(), strict=True, assign=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    latent = SD21_RES // 8
    ctx_dim = configs.SD21_UNET["cross_attention_dim"]
    l1, l2, _ = sd21_keys(1, SD21_RES, SD21_RES, "float32")
    want_fwd = {l1 + ("f32",): 5, l2 + ("f32",): 5}

    sample = torch.randn(1, 4, latent, latent, generator=gen, device="cuda")
    t = torch.tensor([421], device="cuda")
    ctx = torch.randn(1, 77, ctx_dim, generator=gen, device="cuda")
    with torch.no_grad():
        fa.reset_launch_counts()
        out_k = unet(sample, t, ctx)
        torch.cuda.synchronize()
        fwd_by_shape = dict(fa.flash_attention_fwd.launches_by_shape)
        out_p = plain(sample, t, ctx)
        plain_launches = fa.flash_attention_fwd.launches - sum(fwd_by_shape.values())
    rel = (out_k - out_p).abs().max().item() / out_p.abs().max().item()
    ok_fwd = bool(torch.isfinite(out_k).all()) and rel <= PARITY_REL_TOL and fwd_by_shape == want_fwd
    ok_fwd = ok_fwd and plain_launches == 0
    del out_k, out_p

    sched = DDPMScheduler(beta_start=0.00085, beta_end=0.012, beta_schedule="zero_snr_scaled_linear",
                          num_train_timesteps=1000, prediction_type="v_prediction", device="cuda")
    mean = torch.randn(1, 4, latent, latent, generator=gen, device="cuda")
    logvar = torch.randn(1, 4, latent, latent, generator=gen, device="cuda") * 0.1 - 6.0
    batch = {"latent_moments": torch.cat([mean, logvar], dim=1),
             "encoder_hidden_states": torch.randn(1, 227, ctx_dim, generator=gen, device="cuda")}
    draws = make_draws(gen, mean.shape, torch.float32, 1000, "cuda")
    kw = dict(strip_bos_eos_token=True, offset_noise_magnitude=0.0, min_snr_gamma_magnitude=0.0,
              perturbation_noise_magnitude=0.0, text_context_window=77, train_text_encoder=False,
              vae_encode_chunk=0)
    frozen = (FrozenModel(call=None, params=None), FrozenModel(call=sched, params=sched.create_state()))
    names = [n for n, _ in unet.named_parameters()]

    def loss_and_grads(model):
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        loss = _loss(SimpleNamespace(model=model), None, *frozen, batch, None, draws, **kw)
        grads = _grads(loss, dict(model.named_parameters()))
        torch.cuda.synchronize()
        by_shape = dict(flash_fwd=dict(fa.flash_attention_fwd.launches_by_shape),
                        flash_bwd_f32=dict(fa.flash_attention_bwd_f32_fused.launches_by_shape))
        launches = dict(fwd=fa.flash_attention_fwd.launches, **bwd_launches(fa))
        return loss.item(), grads, launches, by_shape, torch.cuda.max_memory_allocated()

    loss_k, grads_k, launches_k, by_shape, peak_k = loss_and_grads(unet)
    state["sd21_parity_by_shape"] = {"flash_fwd": {**fwd_by_shape}, "flash_bwd_f32": by_shape["flash_bwd_f32"]}
    for key, n in by_shape["flash_fwd"].items():  # the forward call's and the step's forward launches
        state["sd21_parity_by_shape"]["flash_fwd"][key] = state["sd21_parity_by_shape"]["flash_fwd"].get(key, 0) + n
    grads_k = [g.cpu() for g in grads_k]  # room on the card for the plain run's
    loss_p, grads_p, launches_p, _, peak_p = loss_and_grads(plain)
    worst, worst_name = 0.0, None
    for name, gk, gp in zip(names, grads_k, grads_p):
        r = (gk.cuda() - gp).abs().max().item() / max(gp.abs().max().item(), 1e-30)
        if r > worst:
            worst, worst_name = r, name
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    want_bwd = {l1: 5, l2: 5}
    ok_step = (
        math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL_TOL and worst <= TRAIN_GRAD_REL_TOL
        and launches_k == dict(fwd=10, bwd_fused=0, bwd_fused_wide=0, bwd_f32=10, bwd_dq=0, bwd_dkv=0)
        and by_shape == dict(flash_fwd=want_fwd, flash_bwd_f32=want_bwd)
        and launches_p == dict(fwd=0, bwd_fused=0, bwd_fused_wide=0, bwd_f32=0, bwd_dq=0, bwd_dkv=0)
    )
    emit(
        "sd21_parity", dtype="float32", batch=1, resolution=SD21_RES, max_rel_diff=rel, rel_tol=PARITY_REL_TOL,
        forward_launches_by_shape={"x".join(map(str, k)): n for k, n in fwd_by_shape.items()},
        loss_kernel=loss_k, loss_plain=loss_p, loss_rel_diff=loss_rel, loss_rel_tol=TRAIN_LOSS_REL_TOL,
        worst_grad_rel_diff=worst, worst_grad=worst_name, grad_rel_tol=TRAIN_GRAD_REL_TOL, n_grads=len(names),
        step_launches=launches_k, plain_launches=launches_p,
        step_launches_by_shape={k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in by_shape.items()},
        max_memory_allocated_kernel=peak_k, max_memory_allocated_plain=peak_p, ok=ok_fwd and ok_step,
    )
    del unet, plain, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    if not (ok_fwd and ok_step):
        raise AssertionError("full-width SD2.1 UNet: kernel and plain attention disagree")


def sd21_scheduler():
    """SD2.1's own DDIM settings: v-prediction, scaled_linear, steps_offset 1."""
    from stable_diffusion_training_tpu_torch.diffusion import DDIMScheduler

    return DDIMScheduler(
        beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
        set_alpha_to_one=False, steps_offset=1, prediction_type="v_prediction", device="cuda",
    )


def phase_sd21(state, steps=SD21_STEPS, seed=0, repeats=5):
    """SD2.1 text-to-image at full width in bf16 (OpenCLIP ViT-H, the
    SD2.1 UNet, the VAE), seeded weights, 768x768, CFG batch 2, ``steps``
    v-prediction DDIM steps: K1 5 times a step at (10, 9216, 64) and 5 at
    (20, 2304, 64), once in the decode at (1, 9216, 512)."""
    import torch

    from stable_diffusion_training_tpu_torch.models import (
        AutoencoderKL, CLIPTextModel, UNet2DConditionModel, configs,
    )
    from stable_diffusion_training_tpu_torch.pipeline import StableDiffusionPipeline

    set_tf32(False)
    models = seeded_models(
        seed, torch.bfloat16, unet=(UNet2DConditionModel, configs.SD21_UNET),
        vae=(AutoencoderKL, configs.SD_VAE), text_encoder=(CLIPTextModel, configs.OPEN_CLIP_VIT_H),
    )
    pipe = StableDiffusionPipeline(models["text_encoder"], models["vae"], models["unet"], sd21_scheduler())
    ids, neg_ids = prompt_ids(seed + 1, configs.OPEN_CLIP_VIT_H["vocab_size"])
    kw = dict(num_inference_steps=steps, height=SD21_RES, width=SD21_RES, guidance_scale=7.5, neg_prompt_ids=neg_ids)
    latent = SD21_RES // 8
    noise = torch.randn(1, 4, latent, latent, generator=torch.Generator("cuda").manual_seed(seed + 2), device="cuda")
    stages = [
        ("encode_ms", lambda _: pipe.encode_prompt(ids, neg_ids), 1),
        ("denoise_ms_per_step", lambda context: (pipe.denoise(noise, context, steps, 7.5), context), steps),
        ("decode_ms", lambda out: pipe.decode_latents(out[0]), 1),
    ]
    l1, l2, vae = sd21_keys(2, SD21_RES, SD21_RES)
    want = {l1 + ("tma_narrow",): 5 * steps, l2 + ("tma_narrow",): 5 * steps, (1,) + vae[1:] + ("tma_wide",): 1}
    _, results, by_shape = time_serving(
        "sd21",
        lambda: pipe(ids, generator=torch.Generator("cuda").manual_seed(seed), **kw)["images"],
        stages, {"tma_narrow": 10 * steps, "tma_wide": 1}, want, SD21_RES, repeats, steps=steps,
        prediction_type="v_prediction",
    )
    state["sd21_by_shape"] = by_shape
    latents, context = results["denoise_ms_per_step"]
    with torch.no_grad():
        profile_step(
            lambda: pipe.denoise(latents, context, 1, 7.5),
            "one SD2.1 CFG denoise step (UNet batch 2 at 96x96 latents + DDIM step)", top=15,
        )
    del pipe, models, results
    torch.cuda.empty_cache()


class StubTokenizer:
    """A tokenizer for runs without a vocabulary file: CLIP's BOS (49406),
    EOS and pad (49407) ids, each whitespace word hashed (crc32) into the
    49,406 ids below them. The calls the loader and the pipelines make:
    ``tok(texts, add_special_tokens=False)["input_ids"]`` and ``tok(texts,
    padding="max_length", max_length=77, return_tensors="pt").input_ids``."""

    bos_token_id, eos_token_id, pad_token_id = 49406, 49407, 49407
    model_max_length = 77

    def _words(self, text):
        import zlib

        return [zlib.crc32(w.encode()) % 49406 for w in text.split()]

    def __call__(self, texts, add_special_tokens=True, padding=None, max_length=None, truncation=False,
                 return_tensors=None):
        from types import SimpleNamespace

        ids = [self._words(t) for t in texts]
        if padding != "max_length":
            return {"input_ids": ids}
        n = max_length or self.model_max_length
        rows = [([self.bos_token_id] + w[: n - 2] + [self.eos_token_id] + [self.pad_token_id] * n)[:n] for w in ids]
        if return_tensors == "pt":
            import torch

            return SimpleNamespace(input_ids=torch.tensor(rows))
        import numpy as np

        return SimpleNamespace(input_ids=np.asarray(rows))

    def save_pretrained(self, directory):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "stub_tokenizer.json"), "w") as f:
            json.dump({"bos": self.bos_token_id, "eos": self.eos_token_id, "pad": self.pad_token_id,
                       "hash": "crc32 % 49406"}, f)


def png_chunk(ramdisk, sizes, seed=0):
    """A trainer's chunk 0 under ``ramdisk/chunk_0/repo_0`` (a repo entry
    without ``name``): a seeded PNG of each ``(w, h)`` of ``sizes``, each a
    smooth image (a seeded 24x20 one, bicubically enlarged), and their CSV
    with comma-separated tag captions. Returns (images, seconds)."""
    import numpy as np
    from PIL import Image

    t0 = time.perf_counter()
    repo_dir = os.path.join(ramdisk, "chunk_0", "repo_0")
    os.makedirs(repo_dir)
    rng = np.random.default_rng(seed)
    rows = ["filename,caption,image_width,image_height"]
    for i, (w, h) in enumerate(sizes):
        small = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
        Image.fromarray(small).resize((w, h), Image.BICUBIC).save(os.path.join(repo_dir, f"{i:03d}.png"),
                                                                   compress_level=1)
        tags = ", ".join(f"tag{int(t)}" for t in rng.integers(0, 500, 6))
        rows.append(f'{i:03d}.png,"a photo of thing {i}, {tags}",{w},{h}')
    with open(os.path.join(repo_dir, "meta.csv"), "w") as f:
        f.write("\n".join(rows))
    return len(sizes), time.perf_counter() - t0


def sd21_chunk(ramdisk, seed=0):
    """``sd21_trainer``'s chunk: ``SD21_BATCHES_PER_BUCKET`` batches of
    seeded PNGs at 768x768 and at 896x640. Returns (images, seconds)."""
    n = SD21_BATCH * SD21_BATCHES_PER_BUCKET
    return png_chunk(ramdisk, [(SD21_RES, SD21_RES)] * n + [SD21_BUCKET] * n, seed)


def launch_wrappers(fa, lk):
    """Every kernel wrapper on the port's paths, by the name the launch
    records give it."""
    return dict(
        flash_fwd=fa.flash_attention_fwd, flash_bwd_fused=fa.flash_attention_bwd_fused,
        flash_bwd_fused_wide=fa.flash_attention_bwd_fused_wide,
        flash_bwd_f32=fa.flash_attention_bwd_f32_fused, flash_bwd_dq=fa.flash_attention_bwd_dq,
        flash_bwd_dkv=fa.flash_attention_bwd_dkv, lion_leaves=lk.lion8bit_update_leaves_,
        lion_single=lk.lion8bit_update_, lion_multi=lk.lion8bit_update_multi_,
    )


def launch_snapshot(fa, lk):
    """Every kernel wrapper's launches by shape, as it stands."""
    return {kernel: dict(wrapper.launches_by_shape) for kernel, wrapper in launch_wrappers(fa, lk).items()}


def launch_diff(after, before):
    """The launches between two snapshots, by kernel and shape (zeros left out)."""
    out = {}
    for kernel, shapes in after.items():
        moved = {k: n - before[kernel].get(k, 0) for k, n in shapes.items() if n != before[kernel].get(k, 0)}
        if moved:
            out[kernel] = moved
    return out


def add_launches(total, part):
    for kernel, shapes in part.items():
        for k, n in shapes.items():
            total.setdefault(kernel, {})[k] = total.setdefault(kernel, {}).get(k, 0) + n


def trace_summary(trace_dir, steps, top=12):
    """The profiler trace the trainer wrote, read with
    ``utils.kernel_trace``: its file, size, kernels and their device ms,
    the device ops with the most time, device ms and launches a step by
    category over its ``steps`` steps, and the idle share; the trace is
    then gzipped in place."""
    import gzip

    from stable_diffusion_training_tpu_torch.utils import kernel_trace

    files = sorted(f for f in os.listdir(trace_dir) if f.endswith(".json"))
    if len(files) != 1:
        return dict(trace_files=files)
    path = os.path.join(trace_dir, files[0])
    size = os.path.getsize(path)
    trace = kernel_trace.load_trace(path)
    kernels = [e for e in kernel_trace.device_events(trace) if e["cat"] == "kernel"]
    table = kernel_trace.category_table(trace, steps)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb", compresslevel=1) as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    return dict(
        trace_file=os.path.relpath(path + ".gz", REPO), trace_bytes=size, trace_events=len(trace["traceEvents"]),
        device_kernels=len(kernels), device_ms=sum(e["dur"] for e in kernels) / 1e3,
        top_device_ops=[dict(ms=ms, name=name[:120]) for name, ms, _ in kernel_trace.top_ops(trace, top)],
        by_category={c: dict(ms=r["ms"], launches=r["launches"])
                     for c, r in table["serialized"]["categories"].items()},
        idle_share=table["idle_share"],
    )


def phase_sd21_trainer(state, seed=0):
    """SD2.1 training (BASELINE config 3's model at 768x768) through
    ``trainer.main(path, dataloader=None, tokenizer=StubTokenizer())``: the
    trainer builds the streaming ``DataLoader`` from the config and reads a
    chunk of seeded PNGs (768x768 and the 896x640 bucket) from the
    ramdisk; the example recipe (v-prediction, zero-SNR, 3-window concat,
    8-bit Lion at bs 16, EMA), seeded ``sd21`` weights, bf16, batch 8, no
    gradient checkpointing; DDIM eval sampling every 2 steps at 768x768 (4
    steps, one prompt) and the profiler trace of the first steps into
    ``chiprun_out/sd21_trace/``. Each train step and each eval call is
    wrapped to time it and read its launches; the loader's
    ``grab_next_batch`` is timed. Checks: finite losses and ``loss.csv``'s
    rows, the eval PNGs (finite images in ``[0, 1]`` before rounding), the
    trace, the checkpoint and the JSON; per step K1 5 + 5 at the bucket's
    two flash levels and once at its VAE encode, the fused bf16 backward 5
    + 5, Lion's leaf table once per model (per 1,024 leaves), nothing else;
    per eval K1 5 + 5 a step and the decode's one; and nothing launched
    outside the steps and the evals (the loader's threads launch nothing)."""
    import gc

    import numpy as np
    import torch
    from PIL import Image

    from stable_diffusion_training_tpu_torch.data import dataloader as dl
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.train import eval_sampler, trainer
    from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file
    from stable_diffusion_training_tpu_torch.utils.profiling import StepTimer

    gc.collect()
    torch.cuda.empty_cache()
    set_tf32(False)
    trace_dir = os.path.join(REPO, "chiprun_out", "sd21_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    run_dir = os.path.join(REPO, ".cache", "chip_smoke_sd21_trainer")
    eval_dir = os.path.join(run_dir, "eval")
    prompt = StubTokenizer()(["a photo of an astronaut riding a horse"], padding="max_length").input_ids
    run_dir, base, cfg, config_path, free_before = trainer_run(
        "chip_smoke_sd21_trainer",
        train_config(model_path="sd21", model_family="sd21", batch_size=SD21_BATCH, image_area_root=[SD21_RES],
                     minimum_axis_length=[SD21_MIN_AXIS]),
        seed, device_prefetch_depth=2, ramdisk_path=os.path.join(run_dir, "ramdisk"),
        repo={"repo_0": {"coma_separated_shuffle": True, "max_tag_count": 20, "drop_caption_ratio": 0.9}},
        repeat_batch=2, numb_of_dataloader_worker_thread=4, queue_get_timeout=60, token=None,
        eval_sample_interval=2, eval_sample_prompt_ids=prompt.tolist(), eval_num_inference_steps=SD21_STEPS,
        eval_sample_resolution=SD21_RES, eval_sample_dir=eval_dir, profile_trace_dir=trace_dir,
    )
    images, chunk_s = sd21_chunk(cfg["ramdisk_path"], seed)

    steps, evals, grabs, eval_images = [], [], [], []
    timer = StepTimer(skip_first=0)
    bucket_steps, maybe_sample, grab = trainer.bucket_train_steps, eval_sampler.EvalSampler.maybe_sample, \
        dl.DataLoader.grab_next_batch
    save_png_images = eval_sampler.save_png_images

    def timed_steps(training_config, frozen_vae, mesh=None):
        def wrap(key, step):
            def run(*args):
                before = launch_snapshot(fa, lk)
                torch.cuda.synchronize()
                with timer.step():
                    out = step(*args)
                    loss = out[4]["loss"].item()
                steps.append(dict(key=key, ms=timer.times[-1] * 1e3, loss=loss,
                                  launches=launch_diff(launch_snapshot(fa, lk), before)))
                return out
            return run
        return {key: wrap(key, step) for key, step in bucket_steps(training_config, frozen_vae, mesh=mesh).items()}

    def timed_sample(self, step, *args, **kwargs):
        before = launch_snapshot(fa, lk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = maybe_sample(self, step, *args, **kwargs)
        torch.cuda.synchronize()
        if out is not None:
            evals.append(dict(step=step, ms=(time.perf_counter() - t0) * 1e3, dir=out,
                              launches=launch_diff(launch_snapshot(fa, lk), before)))
        return out

    def timed_grab(self):
        t0 = time.perf_counter()
        out = grab(self)
        grabs.append((time.perf_counter() - t0) * 1e3)
        return out

    def kept_images(images, directory):
        eval_images.append(np.asarray(images))
        return save_png_images(images, directory)

    trainer.bucket_train_steps = timed_steps
    eval_sampler.EvalSampler.maybe_sample = timed_sample
    dl.DataLoader.grab_next_batch = timed_grab
    eval_sampler.save_png_images = kept_images
    watch = SaveWatch(trainer, run_dir)
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        lk.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.main(config_path, dataloader=None, tokenizer=StubTokenizer())
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        total = launch_snapshot(fa, lk)
        peak = torch.cuda.max_memory_allocated()
    finally:
        watch.stop()
        trainer.bucket_train_steps = bucket_steps
        eval_sampler.EvalSampler.maybe_sample = maybe_sample
        dl.DataLoader.grab_next_batch = grab
        eval_sampler.save_png_images = save_png_images
    gc.collect()
    torch.cuda.empty_cache()
    state["sd21_trainer_by_shape"] = total

    # what each step and each eval must launch
    leaves = sd21_quantized_leaves()
    lion = {}
    for model_leaves in leaves.values():
        add_launches(lion, {"lion_leaves": lion_table_launches(model_leaves, "bfloat16")})
    want_step, bucket_of = {}, {}
    for w, h in ((SD21_RES, SD21_RES), SD21_BUCKET):
        key = (SD21_BATCH, 3, h, w)  # the step table's key: the batch's NCHW shape
        l1, l2, vae = sd21_keys(SD21_BATCH, w, h)
        want_step[key] = dict(
            flash_fwd={l1 + ("tma_narrow",): 5, l2 + ("tma_narrow",): 5, vae + ("tma_wide",): 1},
            flash_bwd_fused={l1: 5, l2: 5}, **lion,
        )
        bucket_of[key] = f"{w}x{h}"
    e1, e2, evae = sd21_keys(2, SD21_RES, SD21_RES)
    want_eval = dict(flash_fwd={e1 + ("tma_narrow",): 5 * SD21_STEPS, e2 + ("tma_narrow",): 5 * SD21_STEPS,
                                (1,) + evae[1:] + ("tma_wide",): 1})
    accounted = {}
    for part in [s["launches"] for s in steps] + [e["launches"] for e in evals]:
        add_launches(accounted, part)
    total_moved = {k: v for k, v in launch_diff(total, {k: {} for k in total}).items()}

    final = read_json_file(config_path)
    with open(cfg["loss_csv"]) as f:
        lines = f.read().splitlines()
    rows = [line.split(",") for line in lines[1:] if line]
    pngs = sorted(os.path.join(e["dir"], n) for e in evals for n in os.listdir(e["dir"]))
    png_arrays = [np.asarray(Image.open(p)) for p in pngs]
    n_steps = 2 * SD21_BATCHES_PER_BUCKET
    traced = min(4, cfg["loss_logging_interval"]) + 1  # the trainer's profiler window: its steps run slower
    per_bucket = {}
    for s in steps[traced:]:
        per_bucket.setdefault(bucket_of.get(s["key"], str(s["key"])), []).append(s["ms"])
    trace = trace_summary(trace_dir, traced) if os.path.isdir(trace_dir) else {}
    checks = dict(
        steps=len(steps) == n_steps and {s["key"] for s in steps} == set(want_step),
        losses_finite=all(math.isfinite(s["loss"]) for s in steps),
        loss_csv=lines[0] == "steps, step_size, loss, time, chunk, seed" and len(rows) == n_steps
        and all(math.isfinite(float(r[2])) for r in rows),
        step_launches=all(s["launches"] == want_step.get(s["key"]) for s in steps),
        evals=[e["step"] for e in evals] == list(range(2, n_steps + 1, 2)),
        eval_launches=all(e["launches"] == want_eval for e in evals),
        eval_images=len(eval_images) == len(evals) and all(
            a.shape == (1, SD21_RES, SD21_RES, 3) and np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1
            for a in eval_images),
        pngs=len(pngs) == len(evals) and all(a.shape == (SD21_RES, SD21_RES, 3) and a.dtype == np.uint8
                                              for a in png_arrays),
        nothing_outside_steps_and_evals=accounted == total_moved,
        trace=trace.get("trace_bytes", 0) > 0 and trace.get("device_kernels", 0) > 0,
        checkpoint=os.path.isdir(f"{base}@0/unet") and os.path.isdir(f"{base}-EMA@0/unet")
        and os.path.isdir(os.path.join(f"{base}@0", trainer.TRAIN_STATE_SUBDIR)),
        json=(final["chunk_number"], final["chunk_steps"], final["master_seed"]) == (1, 1, seed + 1),
        chunk_flushed=not os.path.exists(os.path.join(cfg["ramdisk_path"], "chunk_0")),
    )
    row = dict(
        batch=SD21_BATCH, resolution=SD21_RES, bucket=list(SD21_BUCKET), dtype="bfloat16",
        gradient_checkpointing=False, images=images, chunk_write_s=chunk_s, wall_s=wall_s, steps=len(steps),
        step_ms=[s["ms"] for s in steps], step_buckets=[bucket_of.get(s["key"]) for s in steps],
        traced_steps=traced, step_p50_ms_by_bucket={b: statistics.median(v) for b, v in per_bucket.items()},
        steps_by_bucket={b: len(v) for b, v in per_bucket.items()},
        images_per_s_by_bucket={b: SD21_BATCH / statistics.median(v) * 1e3 for b, v in per_bucket.items()},
        step_summary=timer.summary(), losses=[s["loss"] for s in steps],
        loader_wait_ms=grabs, loader_wait_ms_per_step=sum(grabs) / max(len(steps), 1),
        eval_ms=[e["ms"] for e in evals], eval_steps=[e["step"] for e in evals],
        eval_image_mean=[float(a.mean()) for a in eval_images], **trace, **watch.row(),
        disk_free_before=free_before, max_memory_allocated=peak,
        launches_by_shape={k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in total_moved.items()},
        checks=checks, ok=all(checks.values()),
    )
    emit("sd21_trainer", **row)
    shutil.rmtree(run_dir, ignore_errors=True)
    if not row["ok"]:
        bad = {s["key"]: s["launches"] for s in steps if s["launches"] != want_step.get(s["key"])}
        raise AssertionError(f"sd21_trainer failed its checks: {checks}; steps off their launches: {bad}")


# Data parallelism (BASELINE config 2's layout, on one card): two ranks on
# cuda:0, each a process of its own (spawn), over gloo (NCCL takes one rank
# per card; the grads' all-reduce is copies between buffers the ranks map,
# parallel.sharding._CardExchange), and a one-rank NCCL world started from
# torchrun's variables. Their times describe this check, not data-parallel
# scaling: the ranks share one card.
DDP_WORLD = 2
DDP_PARITY_BATCH = 2  # global: one row a rank
# a chunk at the global batch TRAIN_BATCH, 4 rows a rank: 2 steps, which keep
# the script inside its time beside FSDP's phases
DDP_TRAINER_STEPS = 2
DDP_NCCL_STEPS = 2
DDP_EVAL_STEPS = 2  # DDIM steps of each eval
DDP_TIMEOUT_S = 900
# tests/test_torch_port_train_step.py's bounds: lr is the reference's
# hard-coded 1e-6 / 7; one flipped update sign moves a param by 2 * lr; at
# most 1e-3 of the signs flipped and 1e-4 of the codes more than one apart.
# That module lets codes be more than one apart only at |code| <= 10, its
# tiny models' rounding noise; at full width the one-process step breaks
# that against itself (two runs on one card: cuDNN's f32 weight grads do
# not repeat bitwise), so the noise level here is that module's own
# agreement for cancelling grad sums, 1e-3 of a block's absmax:
# |code| <= 127 * (1e-3) ** (1 / 5) = 31.9
DDP_LR = 1e-6 / 7
DDP_PARAM_ATOL = 2 * DDP_LR + 1e-6
DDP_SIGNS_FLIPPED, DDP_CODES_FAR, DDP_CODE_NOISE = 1e-3, 1e-4, 31


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# what every rank and leg imports before its work: a fork server imports it
# once, and each rank forks from it
RANK_PRELOAD = ("__main__", "torch", "torch.distributed", "torch.distributed.fsdp", "torch.distributed.tensor",
                f"{PACKAGE}.core", f"{PACKAGE}.ops", f"{PACKAGE}.parallel", f"{PACKAGE}.train",
                f"{PACKAGE}.train.trainer")


def rank_context():
    """The ranks' and legs' start method: the fork server, started once
    with ``RANK_PRELOAD`` imported and CUDA never started in it (a process
    forked after CUDA started cannot use it), so a rank starts in well under
    a second where a spawned one imports torch, FSDP2, DTensor and the
    package anew (4-6 s for four ranks started at once with the CPU build
    of torch)."""
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(list(RANK_PRELOAD))
    return ctx


def run_ranks(target, args_of_rank, world):
    """``target(*args_of_rank(r))`` in ``world`` processes (``rank_context``);
    kills the rest once one fails or ``DDP_TIMEOUT_S`` passes; raises unless
    every rank exits with 0."""
    import torch

    torch.cuda.empty_cache()  # the card's memory, for the ranks
    ctx = rank_context()
    procs = [ctx.Process(target=target, args=args_of_rank(r)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DDP_TIMEOUT_S
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{target.__name__}: the ranks exited with {codes}")


def start_rank(target, args):
    """``target(*args)`` in a process of its own (``rank_context``), started
    now: a one-rank leg that starts up beside a phase's gloo ranks. Returns
    the handle ``finish_rank`` and ``stop_rank`` take."""
    proc = rank_context().Process(target=target, args=args)
    proc.start()
    return proc, time.perf_counter()


def finish_rank(leg):
    """Waits for a ``start_rank`` leg (``DDP_TIMEOUT_S`` at most, then kills
    it); raises unless it exits with 0. Returns its seconds from its start."""
    proc, t0 = leg
    proc.join(DDP_TIMEOUT_S)
    stop_rank(leg)
    if proc.exitcode != 0:
        raise AssertionError(f"{proc.name}: the leg exited with {proc.exitcode}")
    return time.perf_counter() - t0


def stop_rank(leg):
    """Kills a ``start_rank`` leg that still runs (its phase failed first)."""
    proc, _ = leg
    if proc.is_alive():
        proc.kill()
        proc.join(30)


def wait_for(path):
    """Blocks until ``path`` exists: a leg's phase writes it once the gloo
    ranks have written the checkpoint that the leg reads back."""
    deadline = time.monotonic() + DDP_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {DDP_TIMEOUT_S} s")
        time.sleep(0.2)


def launches_json(snapshot):
    return {kernel: [[list(k), n] for k, n in shapes.items()] for kernel, shapes in snapshot.items() if shapes}


def launches_from_json(obj):
    return {kernel: {tuple(k): n for k, n in pairs} for kernel, pairs in obj.items()}


def nonzero(launches):
    return {kernel: shapes for kernel, shapes in launches.items() if shapes}


def timed_all_reduce(sink):
    """Wraps the train step's grad all-reduce: host ms around it, the card
    synchronized before and after, into ``sink`` (with the bytes summed)."""
    import importlib

    import torch

    module = importlib.import_module("stable_diffusion_training_tpu_torch.train.train_step")
    inner = module.all_reduce_grads_

    def wrapper(grads, mesh, *args, **kwargs):
        nbytes = sum(g.numel() * g.element_size() for g in grads.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(grads, mesh, *args, **kwargs)
        torch.cuda.synchronize()
        sink.append(dict(ms=(time.perf_counter() - t0) * 1e3, bytes=nbytes))
        return out

    module.all_reduce_grads_ = wrapper


def timed_step_table(steps):
    """Wraps the trainer's step table: each step's host ms (synchronized),
    loss and launches by shape, into ``steps``."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.train import trainer

    table = trainer.bucket_train_steps

    def timed(training_config, frozen_vae, mesh=None):
        def wrap(step):
            def run(*args):
                before = launch_snapshot(fa, lk)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*args)
                loss = out[4]["loss"].item()
                steps.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                                  launches=launch_diff(launch_snapshot(fa, lk), before)))
                return out
            return run
        return {key: wrap(step) for key, step in table(training_config, frozen_vae, mesh=mesh).items()}

    trainer.bucket_train_steps = timed


def ddp_rank(part, rank, world, port, workdir):
    """One rank of a data-parallel, FSDP or TP phase, in a process of its own: joins the
    gloo group on cuda:0 through ``core.initialize_distributed``, runs
    ``part`` and writes its numbers to ``<part>_<rank>.json``."""
    import datetime

    import torch
    import torch.distributed as dist
    # FSDP2's and DTensor's imports are the set-up's slowest: made while the
    # ranks still start (or wait for rank 0's reference step)
    import torch.distributed.fsdp  # noqa: F401
    import torch.distributed.tensor  # noqa: F401

    from stable_diffusion_training_tpu_torch.core import initialize_distributed

    torch.cuda.set_device(0)
    initialize_distributed(
        "gloo", device="cuda:0", rank=rank, world_size=world, init_method=f"tcp://127.0.0.1:{port}",
        timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S),
    )
    try:
        result = {"ddp_parity": ddp_parity_rank, "ddp_trainer": ddp_trainer_rank, "fsdp_parity": fsdp_parity_rank,
                  "fsdp_trainer": fsdp_trainer_rank, "tp_parity": tp_parity_rank,
                  "tp_trainer": tp_trainer_rank, "tp_fsdp_parity": tp_fsdp_parity_rank,
                  "tp_fsdp_trainer": tp_fsdp_trainer_rank}[part](rank, workdir)
        result.update(rank=rank, max_memory_allocated=torch.cuda.max_memory_allocated())
        with open(os.path.join(workdir, f"{part}_{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def compare_steps(got, want, before):
    """Trained params and momentum (``got``: {model: (params, momentum)})
    against the one-process step's (``want``, on the card or in host
    memory), to the bounds above; ``before``: the params before the step.
    Also gives the largest |code|
    of the codes more than one apart, and the leaves of those above the
    noise level."""
    import torch

    from stable_diffusion_training_tpu_torch.optim import QuantizedMomentum

    out = {}
    for key, (params, momentum) in got.items():
        ref_params, ref_momentum = want[key]
        max_diff, flipped, total = 0.0, 0, 0
        for name, p in params.items():
            q, b = ref_params[name].to(p.device), before[key][name].to(p.device)
            max_diff = max(max_diff, (p - q).abs().max().item())
            flipped += int((((p - b) - (q - b)).abs() > DDP_LR).sum())
            total += p.numel()
        codes = far = far_above_noise = scales_off = dense_off = max_far_code = 0
        worst = []  # the leaves with codes far apart above the noise level
        for name, m in momentum.items():
            r = ref_momentum[name]
            r = (QuantizedMomentum(r.codes.to(m.codes.device), r.scales.to(m.codes.device))
                 if isinstance(r, QuantizedMomentum) else r.to(m.device))
            if isinstance(m, QuantizedMomentum):
                c, rc = m.codes.int(), r.codes.int()
                apart = (c - rc).abs() > 1
                far += int(apart.sum())
                if apart.any():
                    max_far_code = max(max_far_code, int(torch.maximum(c.abs(), rc.abs())[apart].max()))
                above = apart & (torch.maximum(c.abs(), rc.abs()) > DDP_CODE_NOISE)
                if above.any():
                    worst.append(dict(leaf=name, codes=int(above.sum()), of=c.numel(),
                                      max_code=int(torch.maximum(c.abs(), rc.abs())[above].max()),
                                      max_apart=int((c - rc).abs()[above].max())))
                far_above_noise += int(above.sum())
                codes += c.numel()
                scales_off += int(((m.scales - r.scales).abs() > 1e-2 * r.scales.abs()).sum())
            else:
                dense_off += int(((m - r).abs() > 1e-6 + 1e-4 * r.abs()).sum())
        ok = (max_diff <= DDP_PARAM_ATOL and flipped <= DDP_SIGNS_FLIPPED * total and far_above_noise == 0
              and far <= DDP_CODES_FAR * codes and scales_off == 0 and dense_off == 0 and codes > 0)
        out[key] = dict(max_param_diff=max_diff, param_atol=DDP_PARAM_ATOL, signs_flipped=flipped, params=total,
                        codes_far=far, max_far_code=max_far_code, noise_code=DDP_CODE_NOISE,
                        codes_far_above_noise=far_above_noise, codes=codes, scales_off=scales_off,
                        dense_momentum_off=dense_off, ok=ok,
                        worst_leaves=sorted(worst, key=lambda w: -w["codes"])[:8])
    return out


def ddp_parity_rank(rank, workdir):
    """Rank 0 first takes the step as one process over the whole global
    batch (the reference); then both ranks take it on their row, and rank 0
    holds its result against the reference."""
    import torch

    from stable_diffusion_training_tpu_torch.core import create_mesh, slice_batch_for_process
    from stable_diffusion_training_tpu_torch.core.distributed import barrier
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.parallel import state_digest
    from stable_diffusion_training_tpu_torch.train import on_device_model_training_state, train_step
    from stable_diffusion_training_tpu_torch.train.states import state_tensors

    set_tf32(False)
    device = torch.device("cuda", 0)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"))
    batch = {k: v.to(device) for k, v in inputs["batch"].items()}
    draws = {k: v.to(device) for k, v in inputs["draws"].items()}
    cfg = train_config(mixed_precision="float32", batch_size=DDP_PARITY_BATCH)

    def step(states, rows, mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*states[:4], rows, None, states[4], states[5], draws=draws, mesh=mesh,
                         strip_bos_eos_token=True, ema_rate=cfg.ema_rate,
                         text_context_window=cfg.text_encoder_context_window)
        return out[4]["loss"].item(), (time.perf_counter() - t0) * 1e3

    def trained(states):
        return {key: (s.params, s.opt_state[1][0].mu_quant)
                for key, s in (("unet", states[0]), ("text_encoder", states[1]))}

    result, reference = {}, None
    if rank == 0:
        ref_states = on_device_model_training_state(cfg, device=device)
        before = {key: {n: p.detach().clone() for n, p in params.items()}
                  for key, (params, _) in trained(ref_states).items()}
        result["reference_loss"], result["reference_step_ms"] = step(ref_states, batch, None)
        reference = trained(ref_states)
        del ref_states  # the EMA and the frozen models go; the trained params and momentum stay
        torch.cuda.empty_cache()
    barrier()
    mesh = create_mesh(device_type="cuda")
    states = on_device_model_training_state(cfg, device=device, mesh=mesh)
    allreduce = []
    timed_all_reduce(allreduce)
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    result["loss"], result["step_ms"] = step(states, slice_batch_for_process(batch), mesh)
    result["launches"] = launches_json(launch_snapshot(fa, lk))
    result["allreduce"] = allreduce
    result["digest"] = state_digest(state_tensors(*states[:4]))
    if reference is not None:
        result["vs_one_process"] = compare_steps(trained(states), reference, before)
    return result


def phase_ddp_parity(state, seed=3):
    """The SD1.5 train step at full width in f32 (TF32 off) over a global
    batch of 2 at 512x512 with fixed global draws: as one process (rank 0
    first), then on two ranks of one row each (gloo, cuda:0). The ranks' params, EMA, codes and scales
    bitwise equal; the two-rank step against the one-process step within
    tests/test_torch_port_train_step.py's bounds (loss 1e-5 relative,
    params 2 lr + 1e-6, 1e-3 of the update signs, 1e-4 of the codes more
    than one apart, scales 1e-2) with the full-width noise level of the
    codes (``DDP_CODE_NOISE``); each rank launches K1 5 + 1 (f32 route),
    the fused f32 backward 5 and Lion's leaf table once per model, at its
    shapes."""
    import torch

    from stable_diffusion_training_tpu_torch.train.train_step import make_draws

    workdir = os.path.join(REPO, ".cache", "chip_smoke_ddp_parity")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    gen = torch.Generator().manual_seed(seed)
    batch = {
        "pixel_values": torch.rand(DDP_PARITY_BATCH, 3, TRAIN_RES, TRAIN_RES, generator=gen) * 2 - 1,
        "input_ids": torch.randint(0, 49408, (DDP_PARITY_BATCH * TRAIN_CONCAT, 77), generator=gen),
    }
    latent = (DDP_PARITY_BATCH, 4, TRAIN_RES // 8, TRAIN_RES // 8)
    torch.save({"batch": batch, "draws": make_draws(gen, latent, torch.float32, 1000, "cpu")},
               os.path.join(workdir, "inputs.pt"))
    port = free_port()
    t0 = time.perf_counter()
    run_ranks(ddp_rank, lambda r: ("ddp_parity", r, DDP_WORLD, port, workdir), DDP_WORLD)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(DDP_WORLD):
        with open(os.path.join(workdir, f"ddp_parity_{r}.json")) as f:
            ranks.append(json.load(f))
    lion = {}
    for leaves in sd15_quantized_leaves().values():
        add_launches(lion, {"lion_leaves": lion_table_launches(leaves, "float32")})
    want = dict(
        flash_fwd={(8, 4096, 4096, 40, "float32", "f32"): 5, (1, 4096, 4096, 512, "float32", "f32"): 1},
        flash_bwd_f32={(8, 4096, 4096, 40, "float32"): 5}, **lion,
    )
    launches = [nonzero(launches_from_json(r["launches"])) for r in ranks]
    ref_loss = ranks[0]["reference_loss"]
    checks = dict(
        ranks_bitwise_equal=len({r["digest"] for r in ranks}) == 1 and len({r["loss"] for r in ranks}) == 1,
        loss=abs(ranks[0]["loss"] - ref_loss) <= TRAIN_LOSS_REL_TOL * abs(ref_loss),
        vs_one_process=all(v["ok"] for v in ranks[0]["vs_one_process"].values()),
        launches=all(got == want for got in launches),
    )
    total = {}
    for got in launches:
        add_launches(total, got)
    state["ddp_parity_by_shape"] = total
    row = dict(
        world=DDP_WORLD, backend="gloo", batch=DDP_PARITY_BATCH, rows_per_rank=DDP_PARITY_BATCH // DDP_WORLD,
        resolution=TRAIN_RES, dtype="float32", wall_s=wall_s, loss=ranks[0]["loss"], reference_loss=ref_loss,
        loss_rel_diff=abs(ranks[0]["loss"] - ref_loss) / abs(ref_loss), vs_one_process=ranks[0]["vs_one_process"],
        step_ms=[r["step_ms"] for r in ranks], reference_step_ms=ranks[0]["reference_step_ms"],
        allreduce=[r["allreduce"] for r in ranks], digests=[r["digest"] for r in ranks],
        max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
        launches_by_shape=[{k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in got.items()}
                           for got in launches],
        checks=checks, ok=all(checks.values()),
    )
    emit("ddp_parity", **row)
    shutil.rmtree(workdir, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"ddp_parity failed its checks: {checks}")


def ddp_trainer_rank(rank, workdir):
    """``trainer.main(dataloader=None)`` on this rank (one chunk), with the
    step table, the all-reduce, the writers, the loader's batches and the
    chunk checkpoint wrapped."""
    import hashlib

    import numpy as np
    import torch

    from stable_diffusion_training_tpu_torch.data import dataloader as dl
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.parallel import state_digest
    from stable_diffusion_training_tpu_torch.train import checkpoint, eval_sampler, trainer
    from stable_diffusion_training_tpu_torch.train.states import state_tensors

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    set_tf32(False)
    steps, allreduce, digests, pixels = [], [], [], []
    calls = dict(write_model=0, write_train_state=0, json=0, png=0)
    timed_step_table(steps)
    timed_all_reduce(allreduce)

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    checkpoint._write_model = counted("write_model", checkpoint._write_model)
    checkpoint._write_train_state = counted("write_train_state", checkpoint._write_train_state)
    trainer.save_dict_to_json = counted("json", trainer.save_dict_to_json)
    eval_sampler.save_png_images = counted("png", eval_sampler.save_png_images)
    grab, save_chunk = dl.DataLoader.grab_next_batch, trainer._save_chunk_checkpoints

    def recorded_grab(self):
        b = grab(self)
        if isinstance(b, dict):
            pixels[-1].append(hashlib.sha256(np.ascontiguousarray(b["pixel_values"]).tobytes()).hexdigest())
        return b

    def digested_save(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state, unet_ema,
                      text_encoder_ema, frozen_vae, train_rng=None):
        digests.append(state_digest(state_tensors(unet_state, text_encoder_state, unet_ema, text_encoder_ema)))
        return save_chunk(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state, unet_ema,
                          text_encoder_ema, frozen_vae, train_rng=train_rng)

    dl.DataLoader.grab_next_batch = recorded_grab
    trainer._save_chunk_checkpoints = digested_save
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    pixels.append([])
    t0 = time.perf_counter()
    trainer.main(spec["config_path"], dataloader=None, tokenizer=StubTokenizer(), device=torch.device("cuda", 0))
    torch.cuda.synchronize()
    wall = [time.perf_counter() - t0]
    return dict(
        steps=[dict(s, launches=launches_json(s["launches"])) for s in steps], allreduce=allreduce,
        digests=digests, pixel_digests=pixels, calls=calls, wall_s=wall,
        launches=launches_json(launch_snapshot(fa, lk)),
    )


def ddp_nccl_rank(config_path, workdir):
    """``trainer.main`` in a one-rank NCCL world that it starts itself from
    torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), as ``torchrun --nproc_per_node=1``
    would set them; it runs beside the gloo ranks."""
    import torch
    import torch.distributed as dist

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.train import trainer

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    set_tf32(False)
    steps, allreduce = [], []
    timed_step_table(steps)
    timed_all_reduce(allreduce)
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    trainer.main(config_path, dataloader=None, tokenizer=StubTokenizer())
    torch.cuda.synchronize()
    result = dict(
        backend=dist.get_backend(), world=dist.get_world_size(), device=str(torch.cuda.current_device()),
        steps=[dict(s, launches=launches_json(s["launches"])) for s in steps], allreduce=allreduce,
        launches=launches_json(launch_snapshot(fa, lk)), max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    dist.destroy_process_group()
    with open(os.path.join(workdir, "nccl.json"), "w") as f:
        json.dump(result, f)


def step_launches(batch, lion):
    """One SD1.5 bf16 step's launches at ``batch`` rows: K1 5 at the 64x64
    level and 1 in the VAE encode, the fused backward 5, ``lion``."""
    return dict(
        flash_fwd={(8 * batch, 4096, 4096, 40, "bfloat16", "tma_narrow"): 5,
                   (batch, 4096, 4096, 512, "bfloat16", "tma_wide"): 1},
        flash_bwd_fused={(8 * batch, 4096, 4096, 40, "bfloat16"): 5}, **lion,
    )


def phase_ddp_trainer(state, seed=0):
    """``trainer.main(path, dataloader=None, tokenizer=StubTokenizer())`` on
    two ranks (gloo, cuda:0): SD1.5 at full width, bf16, 512x512, the
    example recipe, global batch 8 (4 a rank), a chunk of 16 seeded PNGs
    (2 steps), DDIM eval every 2 steps (2 steps); beside them, 2 steps of
    ``trainer.main`` in a one-rank NCCL world started from torchrun's
    variables (its own run directory; the card holds the three). (A resume from ``train_state/`` is the trainer phase's second
    invocation, and the fsdp, tp and tp_fsdp trainers' NCCL legs read their
    ranks' checkpoints back.) Checks: one ``loss.csv`` (one header, rank 0's
    rows), one checkpoint, the JSON written by rank 0 alone (its backup,
    once a chunk, once at the end), the eval PNGs written once, the ranks'
    states bitwise equal at the chunk checkpoint, each rank's pixel rows its
    half of a one-process loader's
    batch, each step's launches at the rank's shapes (rank 0's evals
    besides, nothing else), and the NCCL leg's backend and steps."""
    import hashlib

    import numpy as np

    from stable_diffusion_training_tpu_torch.data import dataloader as dl
    from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file

    prompt = StubTokenizer()(["a photo of an astronaut riding a horse"], padding="max_length").input_ids
    root = os.path.join(REPO, ".cache", "chip_smoke_ddp")
    shutil.rmtree(root, ignore_errors=True)
    workdir = os.path.join(root, "ranks")
    os.makedirs(workdir)
    run_dir, base, cfg, config_path, _ = trainer_run(
        "chip_smoke_ddp/trainer", train_config(), seed, device_prefetch_depth=2,
        ramdisk_path=os.path.join(root, "ramdisk"), repo={"repo_0": {}}, repeat_batch=2,
        numb_of_dataloader_worker_thread=4, queue_get_timeout=60, token=None, eval_sample_interval=2,
        eval_sample_prompt_ids=prompt.tolist(), eval_num_inference_steps=DDP_EVAL_STEPS,
        eval_sample_resolution=TRAIN_RES, eval_sample_dir=os.path.join(root, "eval"),
    )
    sizes = [(TRAIN_RES, TRAIN_RES)] * (TRAIN_BATCH * DDP_TRAINER_STEPS)
    png_chunk(cfg["ramdisk_path"], sizes, seed)
    # what one process's loader gives each step
    plan = []
    for master_seed in (seed,):
        shutil.copytree(cfg["ramdisk_path"], os.path.join(root, "plan"))
        loader = dl.DataLoader(StubTokenizer(), config_path, os.path.join(root, "plan"), TRAIN_BATCH, 2,
                               [TRAIN_RES**2], [TRAIN_RES], numb_of_worker_thread=1, queue_get_timeout=60,
                               chunk_number=0, seed=master_seed, context_concatenation_multiplier=TRAIN_CONCAT)
        loader._print_debug = False
        loader.prepare_training_dataframe()
        loader.create_training_dataframe()
        loader.dispatch_worker()
        batches = []
        while not isinstance(b := loader.grab_next_batch(), str):
            batches.append(b["pixel_values"])
        plan.append(batches)
        shutil.rmtree(os.path.join(root, "plan"))
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(dict(config_path=config_path, ramdisk=cfg["ramdisk_path"], sizes=sizes, seed=seed), f)
    # the one-rank NCCL world: its own run directory and a chunk of 2 steps,
    # run beside the gloo ranks (it reads nothing of theirs)
    nccl_dir, nccl_base, nccl_cfg, nccl_config, _ = trainer_run(
        "chip_smoke_ddp/nccl", train_config(), seed, device_prefetch_depth=2,
        ramdisk_path=os.path.join(root, "ramdisk_nccl"), repo={"repo_0": {}}, repeat_batch=2,
        numb_of_dataloader_worker_thread=4, queue_get_timeout=60, token=None,
    )
    png_chunk(nccl_cfg["ramdisk_path"], [(TRAIN_RES, TRAIN_RES)] * (TRAIN_BATCH * DDP_NCCL_STEPS), seed)
    port = free_port()
    leg = start_rank(ddp_nccl_rank, (nccl_config, workdir))
    try:
        t0 = time.perf_counter()
        run_ranks(ddp_rank, lambda r: ("ddp_trainer", r, DDP_WORLD, port, workdir), DDP_WORLD)
        wall_s = time.perf_counter() - t0
        nccl_wall_s = finish_rank(leg)
    finally:
        stop_rank(leg)
    ranks = []
    for r in range(DDP_WORLD):
        with open(os.path.join(workdir, f"ddp_trainer_{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(workdir, "nccl.json")) as f:
        nccl = json.load(f)

    lion = {}
    for leaves in sd15_quantized_leaves().values():
        add_launches(lion, {"lion_leaves": lion_table_launches(leaves, "bfloat16")})
    per_rank = TRAIN_BATCH // DDP_WORLD
    want_step, want_nccl_step = step_launches(per_rank, lion), step_launches(TRAIN_BATCH, lion)
    want_eval = dict(flash_fwd={(16, 4096, 4096, 40, "bfloat16", "tma_narrow"): 5 * DDP_EVAL_STEPS,
                                (1, 4096, 4096, 512, "bfloat16", "tma_wide"): 1})
    n_steps, n_evals = DDP_TRAINER_STEPS, DDP_TRAINER_STEPS // 2
    launches_ok, totals = [], {}
    for r, got in enumerate(ranks):
        steps = [launches_from_json(s["launches"]) for s in got["steps"]]
        expected_total = {}
        for _ in range(n_steps):
            add_launches(expected_total, want_step)
        for _ in range(n_evals if r == 0 else 0):
            add_launches(expected_total, want_eval)
        total = nonzero(launches_from_json(got["launches"]))
        launches_ok.append(len(steps) == n_steps and all(s == want_step for s in steps) and total == expected_total)
        add_launches(totals, total)
    state["ddp_trainer_by_shape"] = totals
    halves = [[[hashlib.sha256(np.ascontiguousarray(b[r * per_rank:(r + 1) * per_rank]).tobytes()).hexdigest()
                for b in batches] for batches in plan] for r in range(DDP_WORLD)]
    with open(cfg["loss_csv"]) as f:
        lines = f.read().splitlines()
    rows = [line.split(",") for line in lines[1:] if line]
    final = read_json_file(config_path)
    eval_dirs = sorted(os.listdir(cfg["eval_sample_dir"])) if os.path.isdir(cfg["eval_sample_dir"]) else []
    nccl_steps = [launches_from_json(s["launches"]) for s in nccl["steps"]]
    with open(nccl_cfg["loss_csv"]) as f:
        nccl_rows = [line.split(",") for line in f.read().splitlines()[1:] if line]
    writes = dict(write_model=4, write_train_state=1, json=3, png=n_evals)
    checks = dict(
        loss_csv=lines[0] == "steps, step_size, loss, time, chunk, seed" and len(rows) == n_steps
        and all(math.isfinite(float(r[2])) for r in rows),
        one_checkpoint=os.path.isdir(f"{base}@0/unet") and os.path.isdir(f"{base}-EMA@0/unet")
        and os.path.isdir(os.path.join(f"{base}@0", "train_state")),
        json=(final["chunk_number"], final["chunk_steps"], final["master_seed"]) == (1, 1, seed + 1),
        rank0_writes=ranks[0]["calls"] == writes,
        other_ranks_write_nothing=all(not any(r["calls"].values()) for r in ranks[1:]),
        eval_pngs=eval_dirs == [f"step_{s:08d}" for s in range(2, DDP_TRAINER_STEPS + 1, 2)] and all(
            os.listdir(os.path.join(cfg["eval_sample_dir"], d)) == ["sample_0.png"] for d in eval_dirs),
        ranks_bitwise_equal=len(ranks[0]["digests"]) == 1 and all(r["digests"] == ranks[0]["digests"] for r in ranks),
        rows_are_the_ranks_halves=all(r["pixel_digests"] == halves[i] for i, r in enumerate(ranks)),
        finite_losses=all(math.isfinite(s["loss"]) for r in ranks for s in r["steps"]),
        launches=all(launches_ok),
        nccl=nccl["backend"] == "nccl" and nccl["world"] == 1 and len(nccl_rows) == DDP_NCCL_STEPS
        and all(math.isfinite(float(r[2])) for r in nccl_rows) and len(nccl_steps) == DDP_NCCL_STEPS
        and all(s == want_nccl_step for s in nccl_steps) and len(nccl["allreduce"]) == DDP_NCCL_STEPS,
    )
    per_rank_rows = []
    for r in ranks:
        # the first step holds the set-up
        timed = [s["ms"] for s in r["steps"][1:]]
        p50 = statistics.median(timed)
        per_rank_rows.append(dict(
            rank=r["rank"], step_ms=[s["ms"] for s in r["steps"]], step_p50_ms=p50,
            global_images_per_s=TRAIN_BATCH / p50 * 1e3,
            allreduce_ms=[a["ms"] for a in r["allreduce"]],
            allreduce_p50_ms=statistics.median(a["ms"] for a in r["allreduce"]),
            allreduce_bytes=r["allreduce"][0]["bytes"] if r["allreduce"] else 0,
            max_memory_allocated=r["max_memory_allocated"], wall_s=r["wall_s"], calls=r["calls"],
            losses=[s["loss"] for s in r["steps"]],
        ))
    nccl_timed = [s["ms"] for s in nccl["steps"][1:]]
    row = dict(
        world=DDP_WORLD, backend="gloo", batch=TRAIN_BATCH, rows_per_rank=per_rank, resolution=TRAIN_RES,
        dtype="bfloat16", steps=n_steps, evals=n_evals, wall_s=wall_s, ranks=per_rank_rows,
        nccl=dict(world=nccl["world"], backend=nccl["backend"], wall_s=nccl_wall_s,
                  step_ms=[s["ms"] for s in nccl["steps"]],
                  step_p50_ms=statistics.median(nccl_timed) if nccl_timed else None,
                  allreduce_ms=[a["ms"] for a in nccl["allreduce"]],
                  max_memory_allocated=nccl["max_memory_allocated"]),
        launches_by_shape={k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in totals.items()},
        checks=checks, ok=all(checks.values()),
    )
    emit("ddp_trainer", **row)
    shutil.rmtree(root, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"ddp_trainer failed its checks: {checks}")


# FSDP (BASELINE config 4: ZeRO-3 sharding over the mesh's fsdp axis, on one
# card): two ranks on cuda:0 over gloo, whose FSDP2 collectives and
# checkpoint gathers are copies between buffers the ranks map from each other
# (parallel.sharding._CardExchange), and a one-rank NCCL world. Their times
# describe this check, not sharded scaling: the ranks share one card.
FSDP_WORLD = 2
FSDP_MESH = [1, FSDP_WORLD, 1]
FSDP_PARITY_BATCH = 2  # global: one row a rank
# the SDXL cache's shards each leg's chunk runs, one step each at the global
# batch SDXL_TRAIN_BATCH: 2 steps a leg (1024x1024, 1152x896)
FSDP_TRAINER_SHARDS = (0, 1)
FSDP_NCCL_SHARDS = (0, 1)
FINGERPRINT_CHUNK = 1 << 26


def fsdp_rule(leaves, world, index):
    """The co-sharding rule over ``leaves`` (``quantized_leaves``) for rank
    ``index`` of ``world``: (this rank's table leaves at their local
    shapes, the leaves kept whole)."""
    import torch

    from stable_diffusion_training_tpu_torch.parallel.sharding import RowShard, ShardPlan

    rows = {}
    for name, shape, _ in leaves:
        chunk = -(-shape[0] // world)
        rows[name] = RowShard(torch.Size(shape), tuple(min(i * chunk, shape[0]) for i in range(world + 1)), index,
                              None)
    plan = ShardPlan(rows, {name: perm for name, _, perm in leaves})
    local, whole = [], []
    for name, shape, perm in leaves:
        if plan.momentum(name, LION_BS) is None:
            whole.append((name, shape, perm))
        else:
            r = rows[name]
            local.append((name, (r.stop - r.start,) + tuple(shape[1:]), perm))
    return local, whole, plan


def fsdp_lion_launches(leaves, dtype_name, world=FSDP_WORLD, index=0):
    """One rank's Lion launches of one update under the rule: the leaf
    table over its local leaves, and the single-leaf entry once per leaf
    kept whole."""
    local, whole, _ = fsdp_rule(leaves, world, index)
    launches = {"lion_leaves": lion_table_launches(local, dtype_name)}
    if whole:
        launches["lion_single"] = {}
        for _, shape, _ in whole:
            key = (math.prod(shape) // LION_BS, LION_BS, dtype_name)
            launches["lion_single"][key] = launches["lion_single"].get(key, 0) + 1
    return launches, [name for name, _, _ in whole]


def fingerprint(t):
    """Two exact integer sums of a tensor's bits (plain and weighted by
    position mod 65521): equal tensors give equal pairs."""
    import torch

    flat = t.detach().reshape(-1)
    bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[flat.element_size()])
    total = weighted = 0
    for start in range(0, bits.numel(), FINGERPRINT_CHUNK):
        x = bits[start:start + FINGERPRINT_CHUNK].to(torch.int64)
        w = torch.arange(start, start + x.numel(), device=x.device, dtype=torch.int64) % 65521 + 1
        total += int(x.sum())
        weighted += int((x * w).sum())
    return [total, weighted]


def timed_fsdp_comms(sink):
    """Wraps FSDP2's all-gathers and reduce-scatters (the process group's
    functions it calls, and the card exchange of gloo ranks): host ms of
    each, the card synchronized before and after, into ``sink``
    ({"all_gather": [...], "reduce_scatter": [...]})."""
    import torch
    import torch.distributed as dist

    from stable_diffusion_training_tpu_torch.parallel import sharding

    def timed(kind, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if out is not None and hasattr(out, "wait"):
                out.wait()
            torch.cuda.synchronize()
            sink[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    for name, kind in (("all_gather_single", "all_gather"), ("all_gather_into_tensor", "all_gather"),
                       ("reduce_scatter_single", "reduce_scatter"), ("reduce_scatter_tensor", "reduce_scatter")):
        if hasattr(dist, name):
            setattr(dist, name, timed(kind, getattr(dist, name)))
    sharding._CardAllGather.__call__ = timed("all_gather", sharding._CardAllGather.__call__)
    sharding._CardReduceScatter.__call__ = timed("reduce_scatter", sharding._CardReduceScatter.__call__)


def fsdp_parity_rank(rank, workdir):
    """Rank 0 first takes the step as one process over the whole global
    batch (the reference); then both ranks take it on their row with the
    models sharded over the fsdp axis, and gather the trained state whole:
    rank 0 holds it against the reference, and each rank its local Lion
    codes and scales against its slices of the gathered ones."""
    import torch

    from stable_diffusion_training_tpu_torch.core import create_mesh, slice_batch_for_process
    from stable_diffusion_training_tpu_torch.core.distributed import barrier
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.optim import lion8bit
    from stable_diffusion_training_tpu_torch.train import on_device_model_training_state, train_step

    set_tf32(False)
    device = torch.device("cuda", 0)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"))
    batch = {k: v.to(device) for k, v in inputs["batch"].items()}
    draws = {k: v.to(device) for k, v in inputs["draws"].items()}

    def step(states, rows, mesh, ema_rate):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*states[:4], rows, None, states[4], states[5], draws=draws, mesh=mesh,
                         strip_bos_eos_token=True, ema_rate=ema_rate, text_context_window=77)
        return out[4]["loss"].item(), (time.perf_counter() - t0) * 1e3

    result, reference, before = {}, None, None
    cfg = train_config(mixed_precision="float32", batch_size=FSDP_PARITY_BATCH)
    if rank == 0:
        ref_states = on_device_model_training_state(cfg, device=device)
        before = {key: {n: p.detach().clone() for n, p in s.params.items()}
                  for key, s in (("unet", ref_states[0]), ("text_encoder", ref_states[1]))}
        result["reference_loss"], result["reference_step_ms"] = step(ref_states, batch, None, cfg.ema_rate)
        reference = {key: (s.params, s.opt_state[1][0].mu_quant)
                     for key, s in (("unet", ref_states[0]), ("text_encoder", ref_states[1]))}
        del ref_states
        torch.cuda.empty_cache()
    barrier()
    cfg = train_config(mixed_precision="float32", batch_size=FSDP_PARITY_BATCH, mesh_shape=FSDP_MESH,
                       fsdp_shard_params=True)
    mesh = create_mesh(tuple(FSDP_MESH), device_type="cuda")
    states = on_device_model_training_state(cfg, device=device, mesh=mesh)
    comms = {"all_gather": [], "reduce_scatter": []}
    timed_fsdp_comms(comms)
    lion8bit.GRAD_COPIES["count"] = 0
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    result["loss"], result["step_ms"] = step(states, slice_batch_for_process(batch, mesh), mesh, cfg.ema_rate)
    result["launches"] = launches_json(launch_snapshot(fa, lk))
    result["grad_copies"] = lion8bit.GRAD_COPIES["count"]
    result["comms_ms"] = {k: sum(v) for k, v in comms.items()}
    result["comms_calls"] = {k: len(v) for k, v in comms.items()}
    # the trained state, whole, on every rank (many leaves to a collective)
    trained, local_slices, whole, digest = whole_trained_state(states)
    result.update(local_slices=local_slices, whole_leaves=whole, digest=digest)
    if reference is not None:
        result["vs_one_process"] = compare_steps(trained, reference, before)
    return result


def phase_fsdp_parity(state, seed=3):
    """The SD1.5 train step at full width in f32 (TF32 off) over a global
    batch of 2 at 512x512 with fixed global draws: as one process (rank 0
    first), then on two ranks of one row each (gloo, cuda:0) with the UNet
    and the text encoder sharded over a ``[1, 2, 1]`` mesh's fsdp axis
    (``fsdp_shard_params``). Each rank gathers the trained params, EMA,
    codes and scales whole: the ranks' gathered states bitwise equal; rank
    0's against the one-process step within ``ddp_parity``'s bounds and
    code-noise rule; each rank's local codes and scales its slices of the
    gathered ones. Launches by shape and route: K1 5 + 1 (f32), the fused
    f32 backward 5, Lion's leaf table once per model over the rank's local
    leaves, the single-leaf entry once per leaf the rule keeps whole."""
    import torch

    from stable_diffusion_training_tpu_torch.train.train_step import make_draws

    workdir = os.path.join(REPO, ".cache", "chip_smoke_fsdp_parity")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    gen = torch.Generator().manual_seed(seed)
    batch = {
        "pixel_values": torch.rand(FSDP_PARITY_BATCH, 3, TRAIN_RES, TRAIN_RES, generator=gen) * 2 - 1,
        "input_ids": torch.randint(0, 49408, (FSDP_PARITY_BATCH * TRAIN_CONCAT, 77), generator=gen),
    }
    latent = (FSDP_PARITY_BATCH, 4, TRAIN_RES // 8, TRAIN_RES // 8)
    torch.save({"batch": batch, "draws": make_draws(gen, latent, torch.float32, 1000, "cpu")},
               os.path.join(workdir, "inputs.pt"))
    port = free_port()
    t0 = time.perf_counter()
    run_ranks(ddp_rank, lambda r: ("fsdp_parity", r, FSDP_WORLD, port, workdir), FSDP_WORLD)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(FSDP_WORLD):
        with open(os.path.join(workdir, f"fsdp_parity_{r}.json")) as f:
            ranks.append(json.load(f))
    launches = [nonzero(launches_from_json(r["launches"])) for r in ranks]
    launches_ok, whole_expected = [], {}
    for r, got in enumerate(launches):
        lion = {}
        for key, leaves in sd15_quantized_leaves().items():
            part, whole_expected[key] = fsdp_lion_launches(leaves, "float32", index=r)
            add_launches(lion, part)
        want = dict(
            flash_fwd={(8, 4096, 4096, 40, "float32", "f32"): 5, (1, 4096, 4096, 512, "float32", "f32"): 1},
            flash_bwd_f32={(8, 4096, 4096, 40, "float32"): 5}, **lion,
        )
        launches_ok.append(got == want)
    ref_loss = ranks[0]["reference_loss"]
    checks = dict(
        ranks_gather_the_same_state=len({r["digest"] for r in ranks}) == 1 and len({r["loss"] for r in ranks}) == 1,
        loss=abs(ranks[0]["loss"] - ref_loss) <= TRAIN_LOSS_REL_TOL * abs(ref_loss),
        vs_one_process=all(v["ok"] for v in ranks[0]["vs_one_process"].values()),
        local_momentum_is_its_slice=all(all(r["local_slices"].values()) for r in ranks),
        whole_leaves_as_the_rule=all(r["whole_leaves"] == whole_expected for r in ranks),
        no_grad_copies=all(r["grad_copies"] == 0 for r in ranks),
        launches=all(launches_ok),
    )
    total = {}
    for got in launches:
        add_launches(total, got)
    state["fsdp_parity_by_shape"] = total
    row = dict(
        world=FSDP_WORLD, backend="gloo", mesh=FSDP_MESH, batch=FSDP_PARITY_BATCH,
        rows_per_rank=FSDP_PARITY_BATCH // FSDP_WORLD, resolution=TRAIN_RES, dtype="float32", wall_s=wall_s,
        loss=ranks[0]["loss"], reference_loss=ref_loss, loss_rel_diff=abs(ranks[0]["loss"] - ref_loss) / abs(ref_loss),
        vs_one_process=ranks[0]["vs_one_process"], whole_leaves=ranks[0]["whole_leaves"],
        step_ms=[r["step_ms"] for r in ranks], reference_step_ms=ranks[0]["reference_step_ms"],
        comms_ms=[r["comms_ms"] for r in ranks], comms_calls=[r["comms_calls"] for r in ranks],
        max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
        launches_by_shape=[{k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in got.items()}
                           for got in launches],
        checks=checks, ok=all(checks.values()),
    )
    emit("fsdp_parity", **row)
    shutil.rmtree(workdir, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"fsdp_parity failed its checks: {checks}")


def fsdp_cache(root, name, shards):
    """A cache directory under ``root`` whose files are links to the SDXL
    cache's ``shards`` (by index, in order)."""
    files = sorted(f for f in os.listdir(SDXL_CACHE_DIR) if f.endswith(".npz"))
    directory = os.path.join(root, name)
    os.makedirs(directory)
    for i, shard in enumerate(shards):
        os.symlink(os.path.join(SDXL_CACHE_DIR, files[shard]), os.path.join(directory, f"shard_{i:03d}.npz"))
    return directory


def fsdp_loader(cache_dir):
    """The cache's loader, each batch cut to this rank's rows."""
    from stable_diffusion_training_tpu_torch.core import slice_batch_for_process
    from stable_diffusion_training_tpu_torch.data import CachedLatentLoader

    class RankRows(CachedLatentLoader):
        def grab_next_batch(self):
            b = super().grab_next_batch()
            return b if isinstance(b, str) else slice_batch_for_process(b)

    return RankRows(cache_dir)


def fsdp_state_fingerprints(state, ema):
    """``{leaf: fingerprint}`` of this rank's local params, EMA, Lion codes
    and scales of one model (the UNet)."""
    out = {}
    for n, t in state.params.items():
        out[f"params/{n}"] = fingerprint(t)
        out[f"ema/{n}"] = fingerprint(ema[n])
    for n, m in state.opt_state[1][0].mu_quant.items():
        if hasattr(m, "codes"):
            out[f"codes/{n}"], out[f"scales/{n}"] = fingerprint(m.codes), fingerprint(m.scales)
    return out


def tp_state_fingerprints(*models):
    """``fsdp_state_fingerprints`` of each ``(state, ema)`` in ``models``
    (the UNet's, the text encoder's), keyed ``unet/...`` and
    ``text_encoder/...``."""
    return {f"{key}/{k}": v for key, (state, ema) in zip(("unet", "text_encoder"), models)
            for k, v in fsdp_state_fingerprints(state, ema).items()}


def fsdp_trainer_rank(rank, workdir):
    """``trainer.main`` once on this rank over the leg's cache, each batch
    cut to the rank's rows, with the step table, FSDP2's comms and the
    writers wrapped and, at the chunk checkpoint, the fingerprints of the
    rank's shards of the UNet state."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.optim import lion8bit
    from stable_diffusion_training_tpu_torch.train import checkpoint, trainer

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    set_tf32(False)
    steps, comms, fingerprints = [], {"all_gather": [], "reduce_scatter": []}, []
    calls = dict(write_model=0, write_train_state=0, json=0)
    timed_step_table(steps)
    timed_fsdp_comms(comms)
    per_step = []
    step_table = trainer.bucket_train_steps

    def comm_steps(training_config, frozen_vae, mesh=None):
        def wrap(step):
            def run(*args):
                marks = {k: len(v) for k, v in comms.items()}
                out = step(*args)
                per_step.append({k: sum(v[marks[k]:]) for k, v in comms.items()})
                return out
            return run
        return {key: wrap(s) for key, s in step_table(training_config, frozen_vae, mesh=mesh).items()}

    trainer.bucket_train_steps = comm_steps

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    checkpoint._write_model = counted("write_model", checkpoint._write_model)
    checkpoint._write_train_state = counted("write_train_state", checkpoint._write_train_state)
    trainer.save_dict_to_json = counted("json", trainer.save_dict_to_json)
    save_chunk = trainer._save_chunk_checkpoints

    def fingerprinted_save(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state, unet_ema,
                           text_encoder_ema, frozen_vae, train_rng=None):
        fingerprints.append(fsdp_state_fingerprints(unet_state, unet_ema))
        return save_chunk(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state, unet_ema,
                          text_encoder_ema, frozen_vae, train_rng=train_rng)

    trainer._save_chunk_checkpoints = fingerprinted_save
    lion8bit.GRAD_COPIES["count"] = 0
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    watch = SaveWatch(trainer, spec["run_dir"])
    t0 = time.perf_counter()
    try:
        trainer.main(spec["config_path"], dataloader=fsdp_loader(spec["cache"]), tokenizer=None,
                     device=torch.device("cuda", 0))
        torch.cuda.synchronize()
    finally:
        watch.stop()
    return dict(
        steps=[dict(s, launches=launches_json(s["launches"])) for s in steps], comms_per_step=per_step,
        calls=calls, wall_s=time.perf_counter() - t0, fingerprints=fingerprints, saves=watch.row(),
        grad_copies=lion8bit.GRAD_COPIES["count"], launches=launches_json(launch_snapshot(fa, lk)),
    )


def fsdp_nccl_rank(state_dir, workdir):
    """A one-rank NCCL world from torchrun's variables with the SDXL models
    sharded over a fsdp axis of one rank, started while the gloo ranks
    train, its world joined and its state built once the phase marks their
    checkpoint written: that
    checkpoint read back whole (``restore_train_state``, one process), each gloo rank's
    slices of the restored UNet state fingerprinted for the gloo ranks' own,
    then 2 steps of ``train.aot``'s step table over the leg's cache (no
    checkpoint: with the gloo leg's still on disk, a second SDXL one would
    need another 58 GB of writes)."""
    import torch
    import torch.distributed as dist

    from stable_diffusion_training_tpu_torch.core import create_mesh, initialize_distributed
    from stable_diffusion_training_tpu_torch.data import CachedLatentLoader
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.train import bucket_train_steps, on_device_model_training_state, trainer
    from stable_diffusion_training_tpu_torch.train.aot import batch_dispatch_key
    from stable_diffusion_training_tpu_torch.train.checkpoint import restore_train_state

    with open(os.path.join(workdir, "nccl_spec.json")) as f:
        spec = json.load(f)
    # the card only once the gloo ranks are done: their two SDXL states
    # leave it too little room for this process's context and NCCL's buffers
    wait_for(os.path.join(workdir, "checkpoint_ready"))
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    set_tf32(False)
    initialize_distributed()
    device = torch.device("cuda", 0)
    mesh = create_mesh(tuple(spec["mesh"]), device_type="cuda")
    config = sdxl_train_config(mesh_shape=spec["mesh"], fsdp_shard_params=True)
    states = on_device_model_training_state(config, device=device, mesh=mesh)
    t0 = time.perf_counter()
    restored = restore_train_state(state_dir, {
        "unet_state": states[0], "text_encoder_state": states[1], "unet_ema_params": states[2],
        "text_encoder_ema_params": {}, "train_rng": torch.Generator(device=device),
    })
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    unet_state, ema = restored["unet_state"], restored["unet_ema_params"]
    leaves = [(n, tuple(p.shape), unet_state.plan.perms.get(n)) for n, p in unet_state.params.items()]
    slices = []
    for index in range(FSDP_WORLD):
        _, _, plan = fsdp_rule(leaves, FSDP_WORLD, index)
        got = {}
        for n, t in unet_state.params.items():
            got[f"params/{n}"] = fingerprint(plan.take(n, t))
            got[f"ema/{n}"] = fingerprint(plan.take(n, ema[n]))
        for n, m in unet_state.opt_state[1][0].mu_quant.items():
            if hasattr(m, "codes"):
                shard = plan.momentum(n, m.codes.shape[1])
                codes, scales = shard.take(m.codes, m.scales) if shard is not None else (m.codes, m.scales)
                got[f"codes/{n}"], got[f"scales/{n}"] = fingerprint(codes), fingerprint(scales)
        slices.append(got)
    fingerprint_s = time.perf_counter() - t0
    comms = {"all_gather": [], "reduce_scatter": []}
    timed_fsdp_comms(comms)
    table = bucket_train_steps(config, states[4], mesh=mesh)
    train_rng, steps = restored["train_rng"], []
    state = [unet_state, restored["text_encoder_state"], ema, None]
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    loader = CachedLatentLoader(spec["cache"])
    for batch in trainer._prefetch_to_device(loader, len(FSDP_NCCL_SHARDS), 77, device):
        before, marks = launch_snapshot(fa, lk), {k: len(v) for k, v in comms.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = table[batch_dispatch_key(batch)](*state, batch, train_rng, states[4], states[5])
        loss = out[4]["loss"].item()
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                          launches=launches_json(launch_diff(launch_snapshot(fa, lk), before)),
                          comms={k: sum(v[marks[k]:]) for k, v in comms.items()},
                          comms_calls={k: len(v) - marks[k] for k, v in comms.items()}))
        state, train_rng = list(out[:4]), out[5]
    result = dict(
        backend=dist.get_backend(), world=dist.get_world_size(), steps=steps, slices=slices,
        restore_s=restore_s, fingerprint_s=fingerprint_s, launches=launches_json(launch_snapshot(fa, lk)),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    dist.destroy_process_group()
    with open(os.path.join(workdir, "nccl.json"), "w") as f:
        json.dump(result, f)


def fsdp_step_launches(square, bucket, lion, rows):
    """One rank's launches over ``square`` 1024x1024 and ``bucket``
    1152x896 steps at ``rows`` rows a rank: K1 20 a step (the 10 transformer
    layers of the 64x64 level, each again in the blocks' recompute; 10 heads
    a row), the fused bf16 backward 10, ``lion`` a step."""
    out = dict(flash_fwd={}, flash_bwd_fused={})
    heads = 10 * rows
    for key, n in (((heads, 4096, 4096, 64, "bfloat16"), square), ((heads, 4032, 4032, 64, "bfloat16"), bucket)):
        if n:
            out["flash_fwd"][key + ("tma_narrow",)] = 20 * n
            out["flash_bwd_fused"][key] = 10 * n
    for kernel, shapes in lion.items():
        out[kernel] = {k: v * (square + bucket) for k, v in shapes.items()}
    return out


def phase_fsdp_trainer(state, seed=0):
    """``trainer.main`` on the SDXL UNet at full width (BASELINE config 4:
    sharded data parallelism with gradient checkpointing), config 5's recipe
    (bf16, frozen cached towers, the offline latent cache): two gloo ranks
    on cuda:0 on a ``[1, 2, 1]`` mesh with ``fsdp_shard_params``, global
    batch 4 (2 a rank), a chunk of 2 steps over the SDXL cache's shards
    (1024x1024, 1152x896) with its checkpoint; then a one-rank
    NCCL world that resumes from that checkpoint (read whole, the models
    sharded over a fsdp axis of one rank) and trains 2 steps of the step
    table (not ``trainer.main``, whose probe and chunk checkpoints,
    beside the gloo leg's, would need another 58 GB of disk writes).
    Checks: finite ``loss.csv`` rows, one writer, the JSON, the checkpoint, each
    step's launches at the rank's shapes, no grad copied before Lion, and
    the checkpoint read back in one process equal to each gloo rank's
    shards (fingerprints). Prints per rank the step p50, peak memory and the
    ms a step spent in FSDP2's all-gathers and reduce-scatters (host clock,
    the card synchronized around each)."""
    from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file

    if not os.path.isdir(SDXL_CACHE_DIR):
        sdxl_latent_cache(seed)
    root = os.path.join(REPO, ".cache", "chip_smoke_fsdp")
    shutil.rmtree(root, ignore_errors=True)
    workdir = os.path.join(root, "ranks")
    os.makedirs(workdir)
    cache = fsdp_cache(root, "cache", FSDP_TRAINER_SHARDS)
    # the mesh goes into the JSON only: this process has no group of two ranks
    run_dir, base, cfg, config_path, _ = trainer_run(
        "chip_smoke_fsdp/trainer", sdxl_train_config(), seed, mesh_shape=FSDP_MESH, fsdp_shard_params=True,
    )
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(dict(config_path=config_path, cache=cache, run_dir=run_dir), f)
    ckpt = f"{base}@0"  # the chunk's
    # the one-rank NCCL world reads the gloo leg's checkpoint back and trains
    # on; it starts beside the gloo ranks and touches the card (its NCCL
    # world, its SDXL state) once they are done: the card holds the three
    # states one after the other
    nccl_cache = fsdp_cache(root, "nccl_cache", FSDP_NCCL_SHARDS)
    with open(os.path.join(workdir, "nccl_spec.json"), "w") as f:
        json.dump(dict(cache=nccl_cache, mesh=[1, 1, 1]), f)
    port = free_port()
    leg = start_rank(fsdp_nccl_rank, (os.path.join(ckpt, "train_state"), workdir))
    try:
        t0 = time.perf_counter()
        run_ranks(ddp_rank, lambda r: ("fsdp_trainer", r, FSDP_WORLD, port, workdir), FSDP_WORLD)
        wall_s = time.perf_counter() - t0
        open(os.path.join(workdir, "checkpoint_ready"), "w").close()
        nccl_wall_s = finish_rank(leg)
    finally:
        stop_rank(leg)
    ranks = []
    for r in range(FSDP_WORLD):
        with open(os.path.join(workdir, f"fsdp_trainer_{r}.json")) as f:
            ranks.append(json.load(f))
    with open(cfg["loss_csv"]) as f:
        lines = f.read().splitlines()
    rows = [line.split(",") for line in lines[1:] if line]
    final = read_json_file(config_path)
    saved = all(os.path.isdir(os.path.join(ckpt, d)) for d in ("unet", "vae", "text_encoder", "train_state")) and (
        os.path.isdir(f"{base}-EMA@0/unet"))

    with open(os.path.join(workdir, "nccl.json")) as f:
        nccl = json.load(f)

    leaves = sdxl_quantized_leaves()
    square = sum(1 for s in FSDP_TRAINER_SHARDS if SDXL_SHARDS[s][0] == (SDXL_RES, SDXL_RES))
    launches_ok, totals, whole = [], {}, []
    for r, got in enumerate(ranks):
        lion, kept = fsdp_lion_launches(leaves, "bfloat16", index=r)
        whole.append(kept)
        want = fsdp_step_launches(square, len(FSDP_TRAINER_SHARDS) - square, lion, SDXL_TRAIN_BATCH // FSDP_WORLD)
        total = nonzero(launches_from_json(got["launches"]))
        launches_ok.append(len(got["steps"]) == len(FSDP_TRAINER_SHARDS) and total == nonzero(want))
        add_launches(totals, total)
    nccl_lion, _ = fsdp_lion_launches(leaves, "bfloat16", world=1)
    nccl_square = sum(1 for s in FSDP_NCCL_SHARDS if SDXL_SHARDS[s][0] == (SDXL_RES, SDXL_RES))
    nccl_want = fsdp_step_launches(nccl_square, len(FSDP_NCCL_SHARDS) - nccl_square, nccl_lion, SDXL_TRAIN_BATCH)
    nccl_launches = nonzero(launches_from_json(nccl["launches"]))
    add_launches(totals, nccl_launches)
    state["fsdp_trainer_by_shape"] = totals
    readback = [bool(nccl["slices"]) and nccl["slices"][r] == ranks[r]["fingerprints"][0]
                for r in range(FSDP_WORLD)] if len(nccl["slices"]) == FSDP_WORLD else [False] * FSDP_WORLD
    checks = dict(
        loss_csv=lines[0] == "steps, step_size, loss, time, chunk, seed" and len(rows) == len(FSDP_TRAINER_SHARDS)
        and all(math.isfinite(float(r[2])) for r in rows),
        json=(final["chunk_number"], final["chunk_steps"], final["master_seed"], final["model_path"])
        == (1, 1, seed + 1, ckpt),
        checkpoint=saved,
        rank0_writes=ranks[0]["calls"] == dict(write_model=4, write_train_state=1, json=3),
        other_ranks_write_nothing=all(not any(r["calls"].values()) for r in ranks[1:]),
        ranks_agree_on_losses=all([s["loss"] for s in r["steps"]] == [s["loss"] for s in ranks[0]["steps"]]
                                  for r in ranks),
        launches=all(launches_ok),
        no_grad_copies=all(r["grad_copies"] == 0 for r in ranks),
        checkpoint_read_back_equals_the_shards=all(readback),
        nccl=nccl["backend"] == "nccl" and nccl["world"] == 1 and len(nccl["steps"]) == len(FSDP_NCCL_SHARDS)
        and all(math.isfinite(s["loss"]) for s in nccl["steps"]) and nccl_launches == nonzero(nccl_want),
    )
    per_rank = []
    for r in ranks:
        timed = [s["ms"] for s in r["steps"][1:]]  # the first step holds the set-up
        per_rank.append(dict(
            rank=r["rank"], step_ms=[s["ms"] for s in r["steps"]], step_p50_ms=statistics.median(timed),
            all_gather_ms_per_step=[c["all_gather"] for c in r["comms_per_step"]],
            reduce_scatter_ms_per_step=[c["reduce_scatter"] for c in r["comms_per_step"]],
            max_memory_allocated=r["max_memory_allocated"], wall_s=r["wall_s"],
            losses=[s["loss"] for s in r["steps"]], **r["saves"],
        ))
    row = dict(
        world=FSDP_WORLD, backend="gloo", mesh=FSDP_MESH, model="sdxl", batch=SDXL_TRAIN_BATCH,
        rows_per_rank=SDXL_TRAIN_BATCH // FSDP_WORLD, dtype="bfloat16", gradient_checkpointing=True,
        steps=len(rows), wall_s=wall_s, ranks=per_rank, whole_leaves=whole[0],
        nccl=dict(world=nccl["world"], backend=nccl["backend"], wall_s=nccl_wall_s,
                  step_ms=[s["ms"] for s in nccl["steps"]], comms_ms=[s["comms"] for s in nccl["steps"]],
                  comms_calls=[s["comms_calls"] for s in nccl["steps"]], restore_s=nccl["restore_s"],
                  fingerprint_s=nccl["fingerprint_s"], max_memory_allocated=nccl["max_memory_allocated"],
                  losses=[s["loss"] for s in nccl["steps"]]),
        checkpoint_read_back=readback,
        launches_by_shape={k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in totals.items()},
        checks=checks, ok=all(checks.values()),
    )
    emit("fsdp_trainer", **row)
    shutil.rmtree(root, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"fsdp_trainer failed its checks: {checks}")


# Tensor parallelism (the JAX package's tensor_parallel_shard_params, fsdp 1):
# two ranks on cuda:0 over gloo, each holding its half of every attention's
# heads (and of CLIP's MLP), their sums over the model_parallel axis copies
# between buffers the ranks map from each other (parallel.sharding's
# _CardExchange), and a one-rank NCCL world. Their times describe this
# check, not scaling: the ranks share one card.
TP_WORLD = 2
TP_MESH = [1, 1, TP_WORLD]
TP_PARITY_BATCH = 1  # global: both ranks take the row
TP_TRAINER_STEPS = 2  # one chunk: the first holds the set-up, eval after the second
TP_EVAL_STEPS = 2  # DDIM steps of the eval


class TpStandInMesh:
    """The mesh surface ``parallel.sharding.tp_plan`` reads, for the rule's
    arithmetic outside a process group: rank ``index`` of a model_parallel
    axis of ``world``."""

    mesh_dim_names = ("data_parallel", "fsdp", "model_parallel")

    def __init__(self, world, index):
        self.world, self.index = world, index

    def size(self, dim):
        return (1, 1, self.world)[dim]

    def get_local_rank(self, axis):
        return self.index if axis == "model_parallel" else 0

    def get_group(self, axis):
        return None


def sd15_tp_sums():
    """The SD1.5 step's sums over the model_parallel axis: per UNet
    transformer block (16) 2 forward (attn1's and attn2's to_out) and 3
    backward (attn1's input, attn2's hidden states and its context); per
    CLIP layer (12) 2 and 2."""
    from stable_diffusion_training_tpu_torch.models import UNet2DConditionModel, configs
    from stable_diffusion_training_tpu_torch.models.attention import BasicTransformerBlock

    unet = UNet2DConditionModel(**configs.SD15_UNET, device="meta")
    blocks = sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
    layers = configs.CLIP_VIT_L["num_hidden_layers"]
    return {"forward": 2 * blocks + 2 * layers, "backward": 3 * blocks + 2 * layers}


def sd15_heads():
    from stable_diffusion_training_tpu_torch.models import configs

    return configs.SD15_UNET["attention_head_dim"]


def tp_rule(model, world=TP_WORLD, index=0):
    """The TP rule over ``model``'s quantized leaves (``quantized_leaves``)
    for rank ``index`` of ``world``: (this rank's table leaves, each split
    one at its local shape, the rest whole; the split leaves whose momentum
    stays whole; the plan)."""
    from stable_diffusion_training_tpu_torch.parallel.sharding import tp_plan

    plan = tp_plan(model, TpStandInMesh(world, index))
    local, whole = [], []
    for name, shape, perm in quantized_leaves(model):
        rows = plan.rows.get(name)
        if rows is None:
            local.append((name, shape, perm))
        elif plan.momentum(name, LION_BS) is None:
            whole.append((name, shape, perm))
        else:
            split = list(shape)
            split[rows.dim] = rows.stop - rows.start
            local.append((name, tuple(split), perm))
    return local, whole, plan


def sd15_tp_rules(index=0):
    """{model: tp_rule} of SD1.5's UNet and text encoder."""
    from stable_diffusion_training_tpu_torch.models import CLIPTextModel, UNet2DConditionModel, configs

    return {
        "unet": tp_rule(UNet2DConditionModel(**configs.SD15_UNET, device="meta"), index=index),
        "text_encoder": tp_rule(CLIPTextModel(**configs.CLIP_VIT_L, device="meta"), index=index),
    }


def tp_lion_launches(dtype_name, index=0):
    """One rank's Lion launches of one SD1.5 update under the TP rule: the
    leaf table over its leaves, once per model, and the single-leaf entry
    once per split leaf kept whole; and those leaves' names."""
    launches, whole = {}, {}
    for key, (local, kept, _) in sd15_tp_rules(index).items():
        add_launches(launches, {"lion_leaves": lion_table_launches(local, dtype_name)})
        for _, shape, _ in kept:
            add_launches(launches, {"lion_single": {(math.prod(shape) // LION_BS, LION_BS, dtype_name): 1}})
        whole[key] = [name for name, _, _ in kept]
    return launches, whole


def timed_tp_sums(sink):
    """Wraps the TP sums (``parallel.sharding._tp_all_reduce``, which the
    split layers' autograd functions call): host ms of each, the card
    synchronized before and after, into ``sink`` by direction."""
    import torch

    from stable_diffusion_training_tpu_torch.parallel import sharding

    inner = sharding._tp_all_reduce

    def timed(t, axis, direction):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(t, axis, direction)
        torch.cuda.synchronize()
        sink[direction].append((time.perf_counter() - t0) * 1e3)
        return out

    sharding._tp_all_reduce = timed


def whole_trained_state(states):
    """Each trained model's params and Lion momentum whole on every rank
    (the split or sharded leaves gathered from every rank's, many leaves to
    a collective, in two rounds where TP and FSDP both split them; the
    others as they are), whether every rank's local codes and scales are
    its parts of the gathered ones, the split quantized leaves whose
    momentum stays whole, and a digest of the whole state with the EMA."""
    import torch

    from stable_diffusion_training_tpu_torch.optim import QuantizedMomentum
    from stable_diffusion_training_tpu_torch.parallel import state_digest
    from stable_diffusion_training_tpu_torch.parallel.sharding import gather_rows_many

    trained, local_slices, whole, gathered = {}, {}, {}, []
    for key, s in (("unet", states[0]), ("text_encoder", states[1])):
        plan, ema = s.plan, states[2] if key == "unet" else states[3]
        split = {} if plan is None else plan.rows
        mu = s.opt_state[1][0].mu_quant
        out = {"params": {}, "ema": {}, "momentum": {}}
        jobs, kept = [], []  # (kind, leaf, gathers)
        for kind, tensors in (("params", s.params), ("ema", ema)):
            for n, t in tensors.items():
                if n in split:
                    jobs.append((kind, n, split[n].gathers(t)))
                else:
                    out[kind][n] = t
        for n, m in mu.items():
            if not isinstance(m, QuantizedMomentum):
                if n in split:
                    jobs.append(("dense", n, split[n].gathers(m)))
                else:
                    out["momentum"][n] = m
            elif n not in split:
                out["momentum"][n] = m
            elif plan.momentum(n, m.codes.shape[1]) is None:
                kept.append(n)
                out["momentum"][n] = m
            else:
                jobs.append(("quantized", n, plan.momentum(n, m.codes.shape[1]).gathers(m.codes, m.scales)))
        fulls = iter(gather_rows_many([g for _, _, gs in jobs for g in gs]))
        ok = True
        for kind, n, gs in jobs:
            parts = [next(fulls) for _ in gs]
            if kind in ("params", "ema"):
                out[kind][n] = parts[0]
            elif kind == "dense":
                out["momentum"][n] = parts[0]
            else:
                mine = plan.momentum(n, mu[n].codes.shape[1]).take(*parts)
                ok = ok and torch.equal(mine[0], mu[n].codes) and torch.equal(mine[1], mu[n].scales)
                out["momentum"][n] = QuantizedMomentum(*parts)
        params = {n: out["params"][n] for n in s.params}
        momentum = {n: out["momentum"][n] for n in mu}
        trained[key] = (params, momentum)
        local_slices[key], whole[key] = ok, kept
        gathered += list(params.values()) + [out["ema"][n] for n in ema] + [
            t for m in momentum.values() for t in ((m.codes, m.scales) if isinstance(m, QuantizedMomentum) else (m,))
        ]
    return trained, local_slices, whole, state_digest(gathered)


def tp_parity_rank(rank, workdir):
    """Rank 0 first takes the step as one process (the reference); then
    both ranks take it on the same row with the UNet's and the text
    encoder's projections split over the model_parallel axis, counting and
    timing the sums over it, and gather the trained state whole: rank 0
    holds it against the reference, and each rank its local Lion codes and
    scales against its slices of the gathered ones."""
    import torch

    from stable_diffusion_training_tpu_torch.core import create_mesh, slice_batch_for_process
    from stable_diffusion_training_tpu_torch.core.distributed import barrier
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.optim import lion8bit
    from stable_diffusion_training_tpu_torch.parallel import sharding
    from stable_diffusion_training_tpu_torch.train import on_device_model_training_state, train_step

    set_tf32(False)
    device = torch.device("cuda", 0)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"))
    batch = {k: v.to(device) for k, v in inputs["batch"].items()}
    draws = {k: v.to(device) for k, v in inputs["draws"].items()}

    def step(states, rows, mesh, ema_rate):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*states[:4], rows, None, states[4], states[5], draws=draws, mesh=mesh,
                         strip_bos_eos_token=True, ema_rate=ema_rate, text_context_window=77)
        return out[4]["loss"].item(), (time.perf_counter() - t0) * 1e3

    result, reference, before = {}, None, None
    # the mesh's rows (one block: the model_parallel ranks share the row), no split, no mesh: one process
    cfg = train_config(mixed_precision="float32", batch_size=TP_PARITY_BATCH, mesh_shape=TP_MESH)
    if rank == 0:
        ref_states = on_device_model_training_state(cfg, device=device)
        before = {key: {n: p.detach().clone() for n, p in s.params.items()}
                  for key, s in (("unet", ref_states[0]), ("text_encoder", ref_states[1]))}
        result["reference_loss"], result["reference_step_ms"] = step(ref_states, batch, None, cfg.ema_rate)
        reference = {key: (s.params, s.opt_state[1][0].mu_quant)
                     for key, s in (("unet", ref_states[0]), ("text_encoder", ref_states[1]))}
        del ref_states
        torch.cuda.empty_cache()
    barrier()
    cfg = train_config(mixed_precision="float32", batch_size=TP_PARITY_BATCH, mesh_shape=TP_MESH,
                       tensor_parallel_shard_params=True)
    mesh = create_mesh(tuple(TP_MESH), device_type="cuda")
    states = on_device_model_training_state(cfg, device=device, mesh=mesh)
    sums = {"forward": [], "backward": []}
    timed_tp_sums(sums)
    lion8bit.GRAD_COPIES["count"] = 0
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    counted = dict(sharding.TP_ALL_REDUCES)
    result["loss"], result["step_ms"] = step(states, slice_batch_for_process(batch, mesh), mesh, cfg.ema_rate)
    result["launches"] = launches_json(launch_snapshot(fa, lk))
    result["tp_sums"] = {k: v - counted[k] for k, v in sharding.TP_ALL_REDUCES.items()}
    result["tp_sums_ms"] = {k: sum(v) for k, v in sums.items()}
    result["grad_copies"] = lion8bit.GRAD_COPIES["count"]
    result["heads"] = sorted({m.heads for m in states[0].model.modules() if hasattr(m, "to_q")})
    trained, local_slices, whole, digest = whole_trained_state(states)
    result.update(local_slices=local_slices, whole_leaves=whole, digest=digest)
    if reference is not None:
        result["vs_one_process"] = compare_steps(trained, reference, before)
    return result


def hold_flash_f32(bh, s, d, seed=9):
    """K1 f32 and the fused f32 backward against their plain versions at
    ``(bh, s, d)``: the largest error of each output over its bound (the
    kernels phase's tolerances), and the routes taken."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda") for _ in range(4))
    scale = d**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta, scale)
    grads, expected = fa.flash_attention_bwd(*args), fa.flash_attention_bwd_reference(*args)
    out = dict(forward_route=fa.forward_route(q, k, v), backward_route=fa.backward_route(q, k, v, do),
               o=(o - o_ref).abs().max().item() / TOLERANCE["float32"]["o"],
               lse=(lse - lse_ref).abs().max().item() / TOLERANCE["float32"]["lse"])
    for name, got, want in zip(("dq", "dk", "dv"), grads, expected):
        out[name] = (got - want).abs().max().item() / (BWD_TOLERANCE["float32"] * want.abs().max().item())
    out["ok"] = (out["forward_route"], out["backward_route"]) == ("f32", "f32_fused") and all(
        out[n] <= 1 for n in ("o", "lse", "dq", "dk", "dv"))
    return out


def phase_tp_parity(state, seed=3):
    """The SD1.5 train step at full width in f32 (TF32 off) on one 512x512
    row with fixed draws: as one process (rank 0 first), then on two ranks
    (gloo, cuda:0) of a ``[1, 1, 2]`` mesh with
    ``tensor_parallel_shard_params``, both taking the row, each running
    attention on 4 of the 8 heads. Each rank gathers the trained params,
    EMA, codes and scales whole: the ranks' gathered states bitwise equal;
    rank 0's against the one-process step within ``ddp_parity``'s bounds
    and code-noise rule; each rank's local codes and scales its slices of
    the gathered ones; the step's sums over the axis as the module count
    says (``sd15_tp_sums``). Launches by shape and route: K1 5 at (4, 4096,
    40) and 1 at (1, 4096, 512) (f32), the fused f32 backward 5 at (4, 4096,
    40), Lion's leaf table once per model over the rank's leaves. K1 f32 and
    the fused f32 backward are also held against their plain versions at
    the rank's (4, 4096, 40)."""
    import torch

    from stable_diffusion_training_tpu_torch.train.train_step import make_draws

    workdir = os.path.join(REPO, ".cache", "chip_smoke_tp_parity")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    gen = torch.Generator().manual_seed(seed)
    batch = {
        "pixel_values": torch.rand(TP_PARITY_BATCH, 3, TRAIN_RES, TRAIN_RES, generator=gen) * 2 - 1,
        "input_ids": torch.randint(0, 49408, (TP_PARITY_BATCH * TRAIN_CONCAT, 77), generator=gen),
    }
    latent = (TP_PARITY_BATCH, 4, TRAIN_RES // 8, TRAIN_RES // 8)
    torch.save({"batch": batch, "draws": make_draws(gen, latent, torch.float32, 1000, "cpu")},
               os.path.join(workdir, "inputs.pt"))
    heads = sd15_heads() * TP_PARITY_BATCH // TP_WORLD
    held = hold_flash_f32(heads, (TRAIN_RES // 8) ** 2, 40)
    port = free_port()
    t0 = time.perf_counter()
    run_ranks(ddp_rank, lambda r: ("tp_parity", r, TP_WORLD, port, workdir), TP_WORLD)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(TP_WORLD):
        with open(os.path.join(workdir, f"tp_parity_{r}.json")) as f:
            ranks.append(json.load(f))
    launches = [nonzero(launches_from_json(r["launches"])) for r in ranks]
    launches_ok, whole_expected = [], None
    for r, got in enumerate(launches):
        lion, whole_expected = tp_lion_launches("float32", index=r)
        want = dict(
            flash_fwd={(heads, 4096, 4096, 40, "float32", "f32"): 5,
                       (TP_PARITY_BATCH, 4096, 4096, 512, "float32", "f32"): 1},
            flash_bwd_f32={(heads, 4096, 4096, 40, "float32"): 5}, **lion,
        )
        launches_ok.append(got == nonzero(want))
    ref_loss = ranks[0]["reference_loss"]
    checks = dict(
        ranks_gather_the_same_state=len({r["digest"] for r in ranks}) == 1 and len({r["loss"] for r in ranks}) == 1,
        loss=abs(ranks[0]["loss"] - ref_loss) <= TRAIN_LOSS_REL_TOL * abs(ref_loss),
        vs_one_process=all(v["ok"] for v in ranks[0]["vs_one_process"].values()),
        local_momentum_is_its_slice=all(all(r["local_slices"].values()) for r in ranks),
        whole_leaves_as_the_rule=all(r["whole_leaves"] == whole_expected for r in ranks),
        tp_sums=all(r["tp_sums"] == sd15_tp_sums() for r in ranks),
        each_rank_runs_half_the_heads=all(r["heads"] == [sd15_heads() // TP_WORLD] for r in ranks),
        no_grad_copies=all(r["grad_copies"] == 0 for r in ranks),
        launches=all(launches_ok),
        kernels_held_at_the_rank_shape=held["ok"],
    )
    total = {}
    for got in launches:
        add_launches(total, got)
    state["tp_parity_by_shape"] = total
    row = dict(
        world=TP_WORLD, backend="gloo", mesh=TP_MESH, batch=TP_PARITY_BATCH, resolution=TRAIN_RES,
        dtype="float32", wall_s=wall_s, loss=ranks[0]["loss"], reference_loss=ref_loss,
        loss_rel_diff=abs(ranks[0]["loss"] - ref_loss) / abs(ref_loss), vs_one_process=ranks[0]["vs_one_process"],
        whole_leaves=ranks[0]["whole_leaves"], step_ms=[r["step_ms"] for r in ranks],
        reference_step_ms=ranks[0]["reference_step_ms"], tp_sums=[r["tp_sums"] for r in ranks],
        tp_sums_expected=sd15_tp_sums(), tp_sums_ms=[r["tp_sums_ms"] for r in ranks],
        max_memory_allocated=[r["max_memory_allocated"] for r in ranks], kernels_held=held,
        launches_by_shape=[{k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in got.items()}
                           for got in launches],
        checks=checks, ok=all(checks.values()),
    )
    emit("tp_parity", **row)
    shutil.rmtree(workdir, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"tp_parity failed its checks: {checks}")


def tp_trainer_rank(rank, workdir):
    """``trainer.main`` once on this rank over the in-memory batches (every
    rank the whole batch: the model_parallel ranks take the same rows),
    with the step table, the TP sums, the writers and the saves wrapped
    and, at the chunk checkpoint, the fingerprints of the rank's UNet and
    text encoder states."""
    import torch

    from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.optim import lion8bit
    from stable_diffusion_training_tpu_torch.train import checkpoint, eval_sampler, trainer

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    set_tf32(False)
    steps, sums, fingerprints, per_step, evals = [], {"forward": [], "backward": []}, [], [], []
    calls = dict(write_model=0, write_train_state=0, json=0, png=0)
    timed_step_table(steps)
    timed_tp_sums(sums)
    step_table = trainer.bucket_train_steps

    def summed_steps(training_config, frozen_vae, mesh=None):
        def wrap(step):
            def run(*args):
                marks = {k: len(v) for k, v in sums.items()}
                out = step(*args)
                per_step.append({k: (len(v) - marks[k], sum(v[marks[k]:])) for k, v in sums.items()})
                return out
            return run
        return {key: wrap(s) for key, s in step_table(training_config, frozen_vae, mesh=mesh).items()}

    trainer.bucket_train_steps = summed_steps
    sample = eval_sampler.EvalSampler.maybe_sample

    def timed_sample(self, step, *args, **kwargs):
        before = launch_snapshot(fa, lk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(self, step, *args, **kwargs)
        torch.cuda.synchronize()
        launched = launch_diff(launch_snapshot(fa, lk), before)
        if any(launched.values()):
            evals.append(dict(step=step, ms=(time.perf_counter() - t0) * 1e3, launches=launches_json(launched)))
        return out

    eval_sampler.EvalSampler.maybe_sample = timed_sample

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    checkpoint._write_model = counted("write_model", checkpoint._write_model)
    checkpoint._write_train_state = counted("write_train_state", checkpoint._write_train_state)
    trainer.save_dict_to_json = counted("json", trainer.save_dict_to_json)
    eval_sampler.save_png_images = counted("png", eval_sampler.save_png_images)
    save_chunk = trainer._save_chunk_checkpoints

    def fingerprinted_save(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state, unet_ema,
                           text_encoder_ema, frozen_vae, train_rng=None):
        fingerprints.append(tp_state_fingerprints((unet_state, unet_ema), (text_encoder_state, text_encoder_ema)))
        return save_chunk(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state, unet_ema,
                          text_encoder_ema, frozen_vae, train_rng=train_rng)

    trainer._save_chunk_checkpoints = fingerprinted_save
    broadcasts, checks = timed_replicas(trainer)
    lion8bit.GRAD_COPIES["count"] = 0
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    loader = InMemoryDataLoader.synthetic(TP_TRAINER_STEPS, TRAIN_BATCH, [(TRAIN_RES, TRAIN_RES)],
                                          concat_count=TRAIN_CONCAT, seed=spec["seed"])
    watch = SaveWatch(trainer, spec["run_dir"])
    t0 = time.perf_counter()
    try:
        trainer.main(spec["config_path"], dataloader=loader, tokenizer=None, device=torch.device("cuda", 0))
        torch.cuda.synchronize()
    finally:
        watch.stop()
    return dict(
        steps=[dict(s, launches=launches_json(s["launches"])) for s in steps], sums_per_step=per_step,
        evals=evals, calls=calls, wall_s=time.perf_counter() - t0, fingerprints=fingerprints, saves=watch.row(),
        whole_grads_broadcast_ms=broadcasts, replica_check_s=checks,
        grad_copies=lion8bit.GRAD_COPIES["count"], launches=launches_json(launch_snapshot(fa, lk)),
    )


def timed_replicas(trainer):
    """Wraps the train step's broadcast of the whole leaves' grads from the
    model_parallel axis's first rank (host ms of each, the card
    synchronized before and after) and the trainer's replica check before
    the chunk checkpoint (host s); returns the two lists they fill."""
    import importlib

    import torch

    step_module = importlib.import_module("stable_diffusion_training_tpu_torch.train.train_step")
    broadcast, check = step_module.replicate_, trainer._assert_replicas_alike
    broadcasts, checks = [], []

    def timed_broadcast(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        broadcast(*args, **kwargs)
        torch.cuda.synchronize()
        broadcasts.append((time.perf_counter() - t0) * 1e3)

    def timed_check(*args):
        t0 = time.perf_counter()
        check(*args)
        checks.append(time.perf_counter() - t0)

    step_module.replicate_, trainer._assert_replicas_alike = timed_broadcast, timed_check
    return broadcasts, checks


def tp_nccl_rank(state_dir, workdir):
    """A one-rank NCCL world from torchrun's variables on a ``[1, 1, 1]``
    mesh with ``tensor_parallel_shard_params`` (an axis of one rank: nothing
    is split), its state built while the gloo ranks train: the gloo leg's
    checkpoint, once the phase marks it written, read back whole
    (``restore_train_state``), each gloo rank's slices of the restored UNet
    and text encoder states fingerprinted for the gloo ranks' own, then one
    step of the step table on a synthetic batch of 8, its TP sums
    counted."""
    import torch
    import torch.distributed as dist

    from stable_diffusion_training_tpu_torch.core import create_mesh, initialize_distributed
    from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.parallel import sharding
    from stable_diffusion_training_tpu_torch.train import bucket_train_steps, on_device_model_training_state, trainer
    from stable_diffusion_training_tpu_torch.train.aot import batch_dispatch_key
    from stable_diffusion_training_tpu_torch.train.checkpoint import restore_train_state

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    set_tf32(False)
    initialize_distributed()
    device = torch.device("cuda", 0)
    mesh = create_mesh((1, 1, 1), device_type="cuda")
    config = train_config(mesh_shape=[1, 1, 1], tensor_parallel_shard_params=True)
    states = on_device_model_training_state(config, device=device, mesh=mesh)
    wait_for(os.path.join(workdir, "checkpoint_ready"))
    t0 = time.perf_counter()
    restored = restore_train_state(state_dir, {
        "unet_state": states[0], "text_encoder_state": states[1], "unet_ema_params": states[2],
        "text_encoder_ema_params": states[3], "train_rng": torch.Generator(device=device),
    })
    restore_s = time.perf_counter() - t0
    unet_state, ema = restored["unet_state"], restored["unet_ema_params"]
    models = {"unet": (unet_state, ema),
              "text_encoder": (restored["text_encoder_state"], restored["text_encoder_ema_params"])}
    slices = []
    for index in range(TP_WORLD):
        got = {}
        for key, (s, e) in models.items():
            plan = sharding.tp_plan(s.model, TpStandInMesh(TP_WORLD, index))
            for n, t in s.params.items():
                take = plan.rows[n].take if n in plan.rows else (lambda x: x)
                got[f"{key}/params/{n}"], got[f"{key}/ema/{n}"] = fingerprint(take(t)), fingerprint(take(e[n]))
            for n, m in s.opt_state[1][0].mu_quant.items():
                if hasattr(m, "codes"):
                    shard = plan.momentum(n, m.codes.shape[1]) if n in plan.rows else None
                    codes, scales = shard.take(m.codes, m.scales) if shard is not None else (m.codes, m.scales)
                    got[f"{key}/codes/{n}"], got[f"{key}/scales/{n}"] = fingerprint(codes), fingerprint(scales)
        slices.append(got)
    # the leaves whole on both gloo ranks
    whole = [f"{key}/{kind}/{n}" for key, (s, _) in models.items()
             for n in s.params if n not in sharding.tp_plan(s.model, TpStandInMesh(TP_WORLD, 0)).rows
             for kind in ("params", "ema")]
    table = bucket_train_steps(config, states[4], mesh=mesh)
    state = [unet_state, restored["text_encoder_state"], ema, restored["text_encoder_ema_params"]]
    loader = InMemoryDataLoader.synthetic(1, TRAIN_BATCH, [(TRAIN_RES, TRAIN_RES)], concat_count=TRAIN_CONCAT,
                                          seed=7)
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    counted = dict(sharding.TP_ALL_REDUCES)
    steps = []
    for batch in trainer._prefetch_to_device(loader, 1, 77, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = table[batch_dispatch_key(batch)](*state, batch, restored["train_rng"], states[4], states[5])
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=out[4]["loss"].item()))
    result = dict(
        backend=dist.get_backend(), world=dist.get_world_size(), steps=steps, slices=slices, whole=whole,
        restore_s=restore_s,
        tp_sums={k: v - counted[k] for k, v in sharding.TP_ALL_REDUCES.items()},
        split=sharding.shard_plan(unet_state.model) is not None,
        launches=launches_json(launch_snapshot(fa, lk)), max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    dist.destroy_process_group()
    with open(os.path.join(workdir, "nccl.json"), "w") as f:
        json.dump(result, f)


def phase_tp_trainer(state, seed=0):
    """``trainer.main`` on SD1.5 at full width, bf16, 512x512, the example
    recipe, global batch 8 on two gloo ranks of cuda:0 on a ``[1, 1, 2]``
    mesh with ``tensor_parallel_shard_params`` (both ranks take the 8 rows;
    each runs attention on 4 of the 8 heads): one chunk of 2 steps from
    in-memory batches with its checkpoint and one DDIM eval (2 steps, on
    every rank, rank 0 writing); then a one-rank NCCL world on ``[1, 1, 1]``
    that reads the checkpoint back whole and takes one step. Checks: finite
    ``loss.csv`` rows, one writer, the JSON, the checkpoint, the ranks'
    losses equal, each step's sums over the axis (``sd15_tp_sums``) and
    launches at the rank's shapes (K1 5 at (32, 4096, 40) and 1 at (8,
    4096, 512), the fused bf16 backward 5 at (32, 4096, 40), Lion's table
    once per model over the rank's leaves), the eval's (K1 5 a DDIM step at
    (8, 4096, 40) and the decode's 1 at (1, 4096, 512)), no grad copied
    before Lion, the checkpoint read back by the NCCL leg equal, in each
    gloo rank's slices, to that rank's UNet and text encoder states at the
    save (fingerprints), the two ranks' params and EMA of the whole leaves
    alike,
    the NCCL leg's backend, loss, launches and sums (none: an axis of one
    rank splits nothing), the whole leaves' grads broadcast from rank 0 in
    each step and the trainer's replica check run once. Prints per rank the
    step p50, the TP sums' ms a step and the broadcast's (host clock, the
    card synchronized around each), the replica check's s and peak memory;
    the ranks share the card, so these describe the check, not scaling."""
    from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file

    prompt = StubTokenizer()(["a photo of an astronaut riding a horse"], padding="max_length").input_ids
    root = os.path.join(REPO, ".cache", "chip_smoke_tp")
    shutil.rmtree(root, ignore_errors=True)
    workdir = os.path.join(root, "ranks")
    os.makedirs(workdir)
    # the mesh goes into the JSON only: this process has no group of two ranks
    run_dir, base, cfg, config_path, _ = trainer_run(
        "chip_smoke_tp/trainer", train_config(), seed, mesh_shape=TP_MESH, tensor_parallel_shard_params=True,
        eval_sample_interval=TP_TRAINER_STEPS, eval_sample_prompt_ids=prompt.tolist(),
        eval_num_inference_steps=TP_EVAL_STEPS, eval_sample_resolution=TRAIN_RES,
        eval_sample_dir=os.path.join(root, "eval"),
    )
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(dict(config_path=config_path, run_dir=run_dir, seed=seed), f)
    ckpt = f"{base}@0"  # the chunk's
    port = free_port()
    # the NCCL leg builds its state beside the gloo ranks, then reads their checkpoint
    leg = start_rank(tp_nccl_rank, (os.path.join(ckpt, "train_state"), workdir))
    try:
        t0 = time.perf_counter()
        run_ranks(ddp_rank, lambda r: ("tp_trainer", r, TP_WORLD, port, workdir), TP_WORLD)
        wall_s = time.perf_counter() - t0
        open(os.path.join(workdir, "checkpoint_ready"), "w").close()
        nccl_wall_s = finish_rank(leg)
    finally:
        stop_rank(leg)
    ranks = []
    for r in range(TP_WORLD):
        with open(os.path.join(workdir, f"tp_trainer_{r}.json")) as f:
            ranks.append(json.load(f))
    with open(cfg["loss_csv"]) as f:
        lines = f.read().splitlines()
    rows = [line.split(",") for line in lines[1:] if line]
    final = read_json_file(config_path)
    saved = all(os.path.isdir(os.path.join(ckpt, d)) for d in ("unet", "vae", "text_encoder", "train_state")) and (
        os.path.isdir(f"{base}-EMA@0/unet"))
    eval_dirs = sorted(os.listdir(cfg["eval_sample_dir"])) if os.path.isdir(cfg["eval_sample_dir"]) else []

    with open(os.path.join(workdir, "nccl.json")) as f:
        nccl = json.load(f)

    heads = sd15_heads() * TRAIN_BATCH // TP_WORLD
    want_eval = dict(flash_fwd={(2 * sd15_heads() // TP_WORLD, 4096, 4096, 40, "bfloat16", "tma_narrow"): 5 * TP_EVAL_STEPS,
                                (1, 4096, 4096, 512, "bfloat16", "tma_wide"): 1})
    launches_ok, totals = [], {}
    for r, got in enumerate(ranks):
        lion, _ = tp_lion_launches("bfloat16", index=r)
        want_step = dict(
            flash_fwd={(heads, 4096, 4096, 40, "bfloat16", "tma_narrow"): 5,
                       (TRAIN_BATCH, 4096, 4096, 512, "bfloat16", "tma_wide"): 1},
            flash_bwd_fused={(heads, 4096, 4096, 40, "bfloat16"): 5}, **lion,
        )
        steps = [launches_from_json(s["launches"]) for s in got["steps"]]
        expected_total = {}
        for _ in range(TP_TRAINER_STEPS):
            add_launches(expected_total, want_step)
        add_launches(expected_total, want_eval)
        total = nonzero(launches_from_json(got["launches"]))
        launches_ok.append(len(steps) == TP_TRAINER_STEPS and all(nonzero(s) == nonzero(want_step) for s in steps)
                           and [nonzero(launches_from_json(e["launches"])) for e in got["evals"]]
                           == [nonzero(want_eval)] and total == nonzero(expected_total))
        add_launches(totals, total)
    state["tp_trainer_by_shape"] = totals
    nccl_lion = {}
    for leaves in sd15_quantized_leaves().values():
        add_launches(nccl_lion, {"lion_leaves": lion_table_launches(leaves, "bfloat16")})
    nccl_launches = nonzero(launches_from_json(nccl["launches"]))
    state["tp_nccl_by_shape"] = nccl_launches
    readback = [nccl["slices"][r] == ranks[r]["fingerprints"][0] if ranks[r]["fingerprints"] else False
                for r in range(TP_WORLD)]
    whole_alike = bool(nccl["whole"]) and all(r["fingerprints"] for r in ranks) and all(
        r["fingerprints"][0][k] == ranks[0]["fingerprints"][0][k] for r in ranks for k in nccl["whole"])
    checks = dict(
        loss_csv=lines[0] == "steps, step_size, loss, time, chunk, seed" and len(rows) == TP_TRAINER_STEPS
        and all(math.isfinite(float(r[2])) for r in rows),
        json=(final["chunk_number"], final["chunk_steps"], final["master_seed"], final["model_path"])
        == (1, 1, seed + 1, ckpt),
        checkpoint=saved,
        rank0_writes=ranks[0]["calls"] == dict(write_model=4, write_train_state=1, json=3, png=1),
        other_ranks_write_nothing=all(not any(r["calls"].values()) for r in ranks[1:]),
        eval_png=eval_dirs == [f"step_{TP_TRAINER_STEPS:08d}"],
        ranks_agree_on_losses=all([s["loss"] for s in r["steps"]] == [s["loss"] for s in ranks[0]["steps"]]
                                  for r in ranks),
        tp_sums=all(len(r["sums_per_step"]) == TP_TRAINER_STEPS and all(
            {k: n for k, (n, _) in s.items()} == sd15_tp_sums() for s in r["sums_per_step"]) for r in ranks),
        launches=all(launches_ok),
        no_grad_copies=all(r["grad_copies"] == 0 for r in ranks),
        checkpoint_read_back_equals_the_slices=all(readback),
        ranks_whole_leaves_alike=whole_alike,
        whole_grads_broadcast_each_step=all(len(r["whole_grads_broadcast_ms"]) == TP_TRAINER_STEPS for r in ranks),
        replicas_checked_before_the_checkpoint=all(len(r["replica_check_s"]) == 1 for r in ranks),
        nccl=nccl["backend"] == "nccl" and nccl["world"] == 1 and len(nccl["steps"]) == 1
        and math.isfinite(nccl["steps"][0]["loss"]) and not nccl["split"]
        and nccl["tp_sums"] == {"forward": 0, "backward": 0}
        and nccl_launches == nonzero(step_launches(TRAIN_BATCH, nccl_lion)),
    )
    per_rank = []
    for r in ranks:
        timed = [s["ms"] for s in r["steps"][1:]]  # the first step holds the set-up
        per_rank.append(dict(
            rank=r["rank"], step_ms=[s["ms"] for s in r["steps"]], step_p50_ms=statistics.median(timed),
            tp_sums_ms_per_step=[{k: ms for k, (_, ms) in s.items()} for s in r["sums_per_step"]],
            tp_sums_ms_p50=statistics.median(sum(ms for _, ms in s.values()) for s in r["sums_per_step"][1:]),
            whole_grads_broadcast_ms=r["whole_grads_broadcast_ms"], replica_check_s=r["replica_check_s"],
            eval_ms=[e["ms"] for e in r["evals"]], max_memory_allocated=r["max_memory_allocated"],
            wall_s=r["wall_s"], losses=[s["loss"] for s in r["steps"]], **r["saves"],
        ))
    row = dict(
        world=TP_WORLD, backend="gloo", mesh=TP_MESH, model="sd15", batch=TRAIN_BATCH, rows_per_rank=TRAIN_BATCH,
        heads_per_rank=sd15_heads() // TP_WORLD, resolution=TRAIN_RES, dtype="bfloat16", steps=len(rows),
        wall_s=wall_s, ranks=per_rank, tp_sums_per_step=sd15_tp_sums(),
        nccl=dict(world=nccl["world"], backend=nccl["backend"], wall_s=nccl_wall_s, step_ms=[s["ms"] for s in nccl["steps"]],
                  loss=nccl["steps"][0]["loss"] if nccl["steps"] else None, restore_s=nccl["restore_s"],
                  tp_sums=nccl["tp_sums"], max_memory_allocated=nccl["max_memory_allocated"]),
        checkpoint_read_back=readback,
        launches_by_shape={k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in totals.items()},
        checks=checks, ok=all(checks.values()),
    )
    emit("tp_trainer", **row)
    shutil.rmtree(root, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"tp_trainer failed its checks: {checks}")


TP_FSDP_MESH = [1, FSDP_WORLD, TP_WORLD]
TP_FSDP_WORLD = FSDP_WORLD * TP_WORLD
TP_FSDP_PARITY_BATCH = 2  # global: one row an fsdp rank, taken by both of its model_parallel ranks
TP_FSDP_TRAINER_STEPS = 2  # one chunk: the first holds the set-up, eval after the second


def tp_fsdp_place(rank):
    """``(fsdp index, model_parallel index)`` of ``rank`` on the ``[1, 2,
    2]`` mesh (row-major)."""
    return divmod(rank, TP_WORLD)


def tp_fsdp_rule(model, rank):
    """The composed rule over ``model``'s quantized leaves for ``rank`` of
    the ``[1, 2, 2]`` mesh, outside a process group: TP's plan
    (``TpStandInMesh``), then FSDP2's ``torch.chunk`` rows of each local
    leaf. Returns (this rank's table leaves at their local shapes, the
    leaves whose momentum stays whole, the plan)."""
    import torch

    from stable_diffusion_training_tpu_torch.parallel.sharding import NestedShard, RowShard, ShardPlan, tp_plan

    fsdp_index, tp_index = tp_fsdp_place(rank)
    tp = tp_plan(model, TpStandInMesh(TP_WORLD, tp_index))
    rows = {}
    for name, p in model.named_parameters():
        shape, outer = list(p.shape), tp.rows.get(name)
        if outer is not None:
            shape[outer.dim] = outer.stop - outer.start
        chunk = -(-shape[0] // FSDP_WORLD)
        inner = RowShard(torch.Size(shape), tuple(min(i * chunk, shape[0]) for i in range(FSDP_WORLD + 1)),
                         fsdp_index, None)
        rows[name] = inner if outer is None else NestedShard(outer, inner)
    plan = ShardPlan(rows, tp.perms, fsdp=True)
    local, whole = [], []
    for name, shape, perm in quantized_leaves(model):
        if plan.momentum(name, LION_BS) is None:
            whole.append((name, shape, perm))
        else:
            inner = rows[name].inner if isinstance(rows[name], NestedShard) else rows[name]
            local.append((name, (inner.stop - inner.start,) + tuple(inner.shape[1:]), perm))
    return local, whole, plan


def sd15_tp_fsdp_rules(rank=0):
    """{model: tp_fsdp_rule} of SD1.5's UNet and text encoder."""
    from stable_diffusion_training_tpu_torch.models import CLIPTextModel, UNet2DConditionModel, configs

    return {
        "unet": tp_fsdp_rule(UNet2DConditionModel(**configs.SD15_UNET, device="meta"), rank),
        "text_encoder": tp_fsdp_rule(CLIPTextModel(**configs.CLIP_VIT_L, device="meta"), rank),
    }


def tp_fsdp_lion_launches(dtype_name, rank):
    """One rank's Lion launches of one SD1.5 update under the composed
    rule (the leaf table once per model over its local leaves, the
    single-leaf entry once per leaf kept whole), and those leaves' names."""
    launches, whole = {}, {}
    for key, (local, kept, _) in sd15_tp_fsdp_rules(rank).items():
        add_launches(launches, {"lion_leaves": lion_table_launches(local, dtype_name)})
        for _, shape, _ in kept:
            add_launches(launches, {"lion_single": {(math.prod(shape) // LION_BS, LION_BS, dtype_name): 1}})
        whole[key] = [name for name, _, _ in kept]
    return launches, whole


def rank_rows(batch, rank):
    """The rows of a global batch that ``rank``'s fsdp index takes (its
    model_parallel partner takes the same)."""
    index, _ = tp_fsdp_place(rank)
    return {k: v[index * (v.shape[0] // FSDP_WORLD):(index + 1) * (v.shape[0] // FSDP_WORLD)]
            for k, v in batch.items()}


def to_host(tree):
    """``tree`` (dicts of tensors and ``QuantizedMomentum``) in host memory."""
    from stable_diffusion_training_tpu_torch.optim import QuantizedMomentum

    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedMomentum):
        return QuantizedMomentum(tree.codes.cpu(), tree.scales.cpu())
    if isinstance(tree, tuple):
        return tuple(to_host(v) for v in tree)
    return tree.detach().cpu()


def tp_fsdp_parity_rank(rank, workdir):
    """Rank 0 first takes the step as one process over the global batch
    (the reference, kept in host memory with the params before it); then
    the four ranks take it with the UNet's and the text encoder's
    projections split over the model_parallel axis and every leaf sharded
    over the fsdp axis, each fsdp rank on its row, counting and timing the
    TP sums and FSDP2's collectives, and gather the trained state whole
    into host memory: rank 0 holds it against the reference, and each rank
    its local Lion codes and scales against its parts of the gathered
    ones."""
    import torch

    from stable_diffusion_training_tpu_torch.core import create_mesh, slice_batch_for_process
    from stable_diffusion_training_tpu_torch.core.distributed import barrier
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.optim import lion8bit
    from stable_diffusion_training_tpu_torch.parallel import sharding
    from stable_diffusion_training_tpu_torch.train import on_device_model_training_state, train_step

    set_tf32(False)
    marks = [("start", time.perf_counter())]  # where the rank's seconds go
    device = torch.device("cuda", 0)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"))
    batch = {k: v.to(device) for k, v in inputs["batch"].items()}
    draws = {k: v.to(device) for k, v in inputs["draws"].items()}

    def step(states, rows, mesh, ema_rate):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*states[:4], rows, None, states[4], states[5], draws=draws, mesh=mesh,
                         strip_bos_eos_token=True, ema_rate=ema_rate, text_context_window=77)
        return out[4]["loss"].item(), (time.perf_counter() - t0) * 1e3

    result, reference, before = {}, None, None
    # the mesh's rows (two blocks: the fsdp ranks split them), no split, no mesh: one process
    cfg = train_config(mixed_precision="float32", batch_size=TP_FSDP_PARITY_BATCH, mesh_shape=TP_FSDP_MESH)
    if rank == 0:
        ref_states = on_device_model_training_state(cfg, device=device)
        before = {key: to_host(dict(s.params)) for key, s in (("unet", ref_states[0]), ("text_encoder", ref_states[1]))}
        result["reference_loss"], result["reference_step_ms"] = step(ref_states, batch, None, cfg.ema_rate)
        reference = {key: (to_host(dict(s.params)), to_host(dict(s.opt_state[1][0].mu_quant)))
                     for key, s in (("unet", ref_states[0]), ("text_encoder", ref_states[1]))}
        del ref_states
        torch.cuda.empty_cache()
        result["reference_max_memory_allocated"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    barrier()
    marks.append(("reference", time.perf_counter()))
    cfg = train_config(mixed_precision="float32", batch_size=TP_FSDP_PARITY_BATCH, mesh_shape=TP_FSDP_MESH,
                       fsdp_shard_params=True, tensor_parallel_shard_params=True)
    mesh = create_mesh(tuple(TP_FSDP_MESH), device_type="cuda")
    states = on_device_model_training_state(cfg, device=device, mesh=mesh)
    marks.append(("set_up", time.perf_counter()))
    sums, comms = {"forward": [], "backward": []}, {"all_gather": [], "reduce_scatter": []}
    timed_tp_sums(sums)
    timed_fsdp_comms(comms)
    lion8bit.GRAD_COPIES["count"] = 0
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    counted = dict(sharding.TP_ALL_REDUCES)
    result["loss"], result["step_ms"] = step(states, slice_batch_for_process(batch, mesh), mesh, cfg.ema_rate)
    result["launches"] = launches_json(launch_snapshot(fa, lk))
    result["tp_sums"] = {k: v - counted[k] for k, v in sharding.TP_ALL_REDUCES.items()}
    result["tp_sums_ms"] = {k: sum(v) for k, v in sums.items()}
    result["comms_ms"] = {k: sum(v) for k, v in comms.items()}
    result["comms_calls"] = {k: len(v) for k, v in comms.items()}
    result["grad_copies"] = lion8bit.GRAD_COPIES["count"]
    result["heads"] = sorted({m.heads for m in states[0].model.modules() if hasattr(m, "to_q")})
    result["step_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    marks.append(("step", time.perf_counter()))
    torch.cuda.empty_cache()  # the step's cached blocks, for the whole state the four ranks gather
    trained, local_slices, whole, digest = whole_trained_state(states)
    result.update(local_slices=local_slices, whole_leaves=whole, digest=digest)
    marks.append(("gather_and_digest", time.perf_counter()))
    if reference is not None:
        result["vs_one_process"] = compare_steps(trained, reference, before)
    marks.append(("compare", time.perf_counter()))
    result["seconds"] = {label: t - marks[i][1] for i, (label, t) in enumerate(marks[1:])}
    return result


def phase_tp_fsdp_parity(state, seed=3):
    """The SD1.5 train step at full width in f32 (TF32 off) over a global
    batch of 2 at 512x512 with fixed global draws: as one process (rank 0
    first), then on four ranks (gloo, cuda:0) of a ``[1, 2, 2]`` mesh with
    ``tensor_parallel_shard_params`` and ``fsdp_shard_params``: each fsdp
    rank takes one row, its two model_parallel ranks 4 of the 8 heads each,
    every leaf (the TP slices and the whole ones) sharded over the fsdp
    pair. Each rank gathers the trained params, EMA, codes and scales
    whole: the ranks' gathered states bitwise equal; rank 0's against the
    one-process step within ``ddp_parity``'s bounds and code-noise rule;
    each rank's local codes and scales its parts of the gathered ones; the
    leaves kept whole those of the composed rule; the sums over the
    model_parallel axis as the module count says (``sd15_tp_sums``) and
    FSDP2's collectives run. Launches by shape and route: K1 5 at (4, 4096,
    40) and 1 at (1, 4096, 512) (f32), the fused f32 backward 5 at (4, 4096,
    40), Lion's leaf table once per model over the rank's local leaves. K1
    f32 and the fused f32 backward are also held against their plain
    versions at the rank's (4, 4096, 40)."""
    import torch

    from stable_diffusion_training_tpu_torch.train.train_step import make_draws

    workdir = os.path.join(REPO, ".cache", "chip_smoke_tp_fsdp_parity")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    gen = torch.Generator().manual_seed(seed)
    batch = {
        "pixel_values": torch.rand(TP_FSDP_PARITY_BATCH, 3, TRAIN_RES, TRAIN_RES, generator=gen) * 2 - 1,
        "input_ids": torch.randint(0, 49408, (TP_FSDP_PARITY_BATCH * TRAIN_CONCAT, 77), generator=gen),
    }
    latent = (TP_FSDP_PARITY_BATCH, 4, TRAIN_RES // 8, TRAIN_RES // 8)
    torch.save({"batch": batch, "draws": make_draws(gen, latent, torch.float32, 1000, "cpu")},
               os.path.join(workdir, "inputs.pt"))
    rows = TP_FSDP_PARITY_BATCH // FSDP_WORLD
    heads = sd15_heads() * rows // TP_WORLD
    held = hold_flash_f32(heads, (TRAIN_RES // 8) ** 2, 40)
    port = free_port()
    t0 = time.perf_counter()
    run_ranks(ddp_rank, lambda r: ("tp_fsdp_parity", r, TP_FSDP_WORLD, port, workdir), TP_FSDP_WORLD)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(TP_FSDP_WORLD):
        with open(os.path.join(workdir, f"tp_fsdp_parity_{r}.json")) as f:
            ranks.append(json.load(f))
    launches = [nonzero(launches_from_json(r["launches"])) for r in ranks]
    launches_ok, whole_ok = [], []
    for r, got in enumerate(launches):
        lion, whole_expected = tp_fsdp_lion_launches("float32", r)
        want = dict(
            flash_fwd={(heads, 4096, 4096, 40, "float32", "f32"): 5, (rows, 4096, 4096, 512, "float32", "f32"): 1},
            flash_bwd_f32={(heads, 4096, 4096, 40, "float32"): 5}, **lion,
        )
        launches_ok.append(got == nonzero(want))
        whole_ok.append(ranks[r]["whole_leaves"] == whole_expected)
    ref_loss = ranks[0]["reference_loss"]
    checks = dict(
        ranks_gather_the_same_state=len({r["digest"] for r in ranks}) == 1 and len({r["loss"] for r in ranks}) == 1,
        loss=abs(ranks[0]["loss"] - ref_loss) <= TRAIN_LOSS_REL_TOL * abs(ref_loss),
        vs_one_process=all(v["ok"] for v in ranks[0]["vs_one_process"].values()),
        local_momentum_is_its_part=all(all(r["local_slices"].values()) for r in ranks),
        whole_leaves_as_the_rule=all(whole_ok),
        tp_sums=all(r["tp_sums"] == sd15_tp_sums() for r in ranks),
        fsdp_collectives=all(r["comms_calls"]["all_gather"] > 0 and r["comms_calls"]["reduce_scatter"] > 0
                             for r in ranks),
        each_rank_runs_half_the_heads=all(r["heads"] == [sd15_heads() // TP_WORLD] for r in ranks),
        no_grad_copies=all(r["grad_copies"] == 0 for r in ranks),
        launches=all(launches_ok),
        kernels_held_at_the_rank_shape=held["ok"],
    )
    total = {}
    for got in launches:
        add_launches(total, got)
    state["tp_fsdp_parity_by_shape"] = total
    row = dict(
        world=TP_FSDP_WORLD, backend="gloo", mesh=TP_FSDP_MESH, batch=TP_FSDP_PARITY_BATCH, rows_per_rank=rows,
        heads_per_rank=sd15_heads() // TP_WORLD, resolution=TRAIN_RES, dtype="float32", wall_s=wall_s,
        loss=ranks[0]["loss"], reference_loss=ref_loss, loss_rel_diff=abs(ranks[0]["loss"] - ref_loss) / abs(ref_loss),
        vs_one_process=ranks[0]["vs_one_process"], whole_leaves=ranks[0]["whole_leaves"],
        step_ms=[r["step_ms"] for r in ranks], reference_step_ms=ranks[0]["reference_step_ms"],
        tp_sums=[r["tp_sums"] for r in ranks], tp_sums_expected=sd15_tp_sums(),
        tp_sums_ms=[r["tp_sums_ms"] for r in ranks], comms_ms=[r["comms_ms"] for r in ranks],
        comms_calls=[r["comms_calls"] for r in ranks], seconds=[r["seconds"] for r in ranks],
        reference_max_memory_allocated=ranks[0]["reference_max_memory_allocated"],
        step_max_memory_allocated=[r["step_max_memory_allocated"] for r in ranks],
        max_memory_allocated=[r["max_memory_allocated"] for r in ranks], kernels_held=held,
        launches_by_shape=[{k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in got.items()}
                           for got in launches],
        checks=checks, ok=all(checks.values()),
    )
    emit("tp_fsdp_parity", **row)
    shutil.rmtree(workdir, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"tp_fsdp_parity failed its checks: {checks}")


def tp_fsdp_trainer_rank(rank, workdir):
    """``trainer.main`` once on this rank over the in-memory batches cut to
    its fsdp index's rows, with the step table, the TP sums, FSDP2's
    comms, the writers and the saves wrapped and, at the chunk checkpoint,
    the fingerprints of the rank's UNet and text encoder states."""
    import torch

    from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader, synthetic_batch
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.optim import lion8bit
    from stable_diffusion_training_tpu_torch.train import checkpoint, eval_sampler, trainer

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    set_tf32(False)
    steps, fingerprints, per_step, evals = [], [], [], []
    sums, comms = {"forward": [], "backward": []}, {"all_gather": [], "reduce_scatter": []}
    calls = dict(write_model=0, write_train_state=0, json=0, png=0)
    timed_step_table(steps)
    timed_tp_sums(sums)
    timed_fsdp_comms(comms)
    step_table = trainer.bucket_train_steps

    def measured_steps(training_config, frozen_vae, mesh=None):
        def wrap(step):
            def run(*args):
                marks = {k: len(v) for k, v in (*sums.items(), *comms.items())}
                out = step(*args)
                per_step.append({k: (len(v) - marks[k], sum(v[marks[k]:])) for k, v in (*sums.items(), *comms.items())})
                return out
            return run
        return {key: wrap(s) for key, s in step_table(training_config, frozen_vae, mesh=mesh).items()}

    trainer.bucket_train_steps = measured_steps
    sample = eval_sampler.EvalSampler.maybe_sample

    def timed_sample(self, step, *args, **kwargs):
        before = launch_snapshot(fa, lk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(self, step, *args, **kwargs)
        torch.cuda.synchronize()
        launched = launch_diff(launch_snapshot(fa, lk), before)
        if any(launched.values()):
            evals.append(dict(step=step, ms=(time.perf_counter() - t0) * 1e3, launches=launches_json(launched)))
        return out

    eval_sampler.EvalSampler.maybe_sample = timed_sample

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    checkpoint._write_model = counted("write_model", checkpoint._write_model)
    checkpoint._write_train_state = counted("write_train_state", checkpoint._write_train_state)
    trainer.save_dict_to_json = counted("json", trainer.save_dict_to_json)
    eval_sampler.save_png_images = counted("png", eval_sampler.save_png_images)
    save_chunk = trainer._save_chunk_checkpoints

    def fingerprinted_save(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state, unet_ema,
                           text_encoder_ema, frozen_vae, train_rng=None):
        fingerprints.append(tp_state_fingerprints((unet_state, unet_ema), (text_encoder_state, text_encoder_ema)))
        return save_chunk(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state, unet_ema,
                          text_encoder_ema, frozen_vae, train_rng=train_rng)

    trainer._save_chunk_checkpoints = fingerprinted_save
    broadcasts, checks = timed_replicas(trainer)
    lion8bit.GRAD_COPIES["count"] = 0
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    # InMemoryDataLoader.synthetic's global batches, each cut to the rank's rows
    loader = InMemoryDataLoader([
        rank_rows(synthetic_batch(TRAIN_BATCH, (TRAIN_RES, TRAIN_RES), concat_count=TRAIN_CONCAT, seed=spec["seed"] + i),
                  rank)
        for i in range(TP_FSDP_TRAINER_STEPS)
    ])
    watch = SaveWatch(trainer, spec["run_dir"])
    t0 = time.perf_counter()
    try:
        trainer.main(spec["config_path"], dataloader=loader, tokenizer=None, device=torch.device("cuda", 0))
        torch.cuda.synchronize()
    finally:
        watch.stop()
    return dict(
        steps=[dict(s, launches=launches_json(s["launches"])) for s in steps], per_step=per_step,
        evals=evals, calls=calls, wall_s=time.perf_counter() - t0, fingerprints=fingerprints, saves=watch.row(),
        whole_grads_broadcast_ms=broadcasts, replica_check_s=checks,
        grad_copies=lion8bit.GRAD_COPIES["count"], launches=launches_json(launch_snapshot(fa, lk)),
    )


def tp_fsdp_nccl_rank(state_dir, workdir):
    """A one-rank NCCL world from torchrun's variables on a ``[1, 1, 1]``
    mesh with both flags (FSDP2 on one rank, an axis of one rank for TP:
    nothing split, no collective), its state built while the gloo ranks
    train: the gloo leg's checkpoint, once the phase marks it written, read
    back whole (``restore_train_state``), each gloo rank's parts of the restored
    UNet and text encoder states fingerprinted for the gloo ranks' own
    (``tp_fsdp_rule``'s plan), then one step of the step table on a
    synthetic batch of 8, its TP sums counted."""
    import torch
    import torch.distributed as dist

    from stable_diffusion_training_tpu_torch.core import create_mesh, initialize_distributed
    from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader
    from stable_diffusion_training_tpu_torch.models import CLIPTextModel, UNet2DConditionModel, configs
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk
    from stable_diffusion_training_tpu_torch.parallel import sharding
    from stable_diffusion_training_tpu_torch.train import bucket_train_steps, on_device_model_training_state, trainer
    from stable_diffusion_training_tpu_torch.train.aot import batch_dispatch_key
    from stable_diffusion_training_tpu_torch.train.checkpoint import restore_train_state

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    set_tf32(False)
    initialize_distributed()
    device = torch.device("cuda", 0)
    mesh = create_mesh((1, 1, 1), device_type="cuda")
    config = train_config(mesh_shape=[1, 1, 1], fsdp_shard_params=True, tensor_parallel_shard_params=True)
    t0 = time.perf_counter()
    states = on_device_model_training_state(config, device=device, mesh=mesh)
    set_up_s = time.perf_counter() - t0
    wait_for(os.path.join(workdir, "checkpoint_ready"))
    t0 = time.perf_counter()
    restored = restore_train_state(state_dir, {
        "unet_state": states[0], "text_encoder_state": states[1], "unet_ema_params": states[2],
        "text_encoder_ema_params": states[3], "train_rng": torch.Generator(device=device),
    })
    restore_s = time.perf_counter() - t0
    unet_state, ema = restored["unet_state"], restored["unet_ema_params"]
    models = {"unet": (unet_state, ema, UNet2DConditionModel(**configs.SD15_UNET, device="meta")),
              "text_encoder": (restored["text_encoder_state"], restored["text_encoder_ema_params"],
                               CLIPTextModel(**configs.CLIP_VIT_L, device="meta"))}
    slices, whole = [], []
    t0 = time.perf_counter()
    for rank in range(TP_FSDP_WORLD):
        got = {}
        for key, (s, e, meta) in models.items():
            plan = tp_fsdp_rule(meta, rank)[2]
            if rank == 0:  # the leaves whole on both model_parallel ranks of an fsdp index
                whole += [f"{key}/{kind}/{n}" for n in s.params if n not in plan.tp_names for kind in ("params", "ema")]
            for n, t in s.params.items():
                got[f"{key}/params/{n}"], got[f"{key}/ema/{n}"] = fingerprint(plan.take(n, t)), fingerprint(plan.take(n, e[n]))
            for n, m in s.opt_state[1][0].mu_quant.items():
                if hasattr(m, "codes"):
                    shard = plan.momentum(n, m.codes.shape[1])
                    codes, scales = shard.take(m.codes, m.scales) if shard is not None else (m.codes, m.scales)
                    got[f"{key}/codes/{n}"], got[f"{key}/scales/{n}"] = fingerprint(codes), fingerprint(scales)
        slices.append(got)
    fingerprint_s = time.perf_counter() - t0
    table = bucket_train_steps(config, states[4], mesh=mesh)
    state = [unet_state, restored["text_encoder_state"], ema, restored["text_encoder_ema_params"]]
    loader = InMemoryDataLoader.synthetic(1, TRAIN_BATCH, [(TRAIN_RES, TRAIN_RES)], concat_count=TRAIN_CONCAT,
                                          seed=7)
    fa.reset_launch_counts()
    lk.reset_launch_counts()
    counted = dict(sharding.TP_ALL_REDUCES)
    steps = []
    for batch in trainer._prefetch_to_device(loader, 1, 77, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = table[batch_dispatch_key(batch)](*state, batch, restored["train_rng"], states[4], states[5])
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=out[4]["loss"].item()))
    plan = unet_state.plan
    result = dict(
        backend=dist.get_backend(), world=dist.get_world_size(), steps=steps, slices=slices, whole=whole,
        set_up_s=set_up_s, restore_s=restore_s, fingerprint_s=fingerprint_s,
        tp_sums={k: v - counted[k] for k, v in sharding.TP_ALL_REDUCES.items()},
        tp_split=bool(plan is not None and plan.tp_names), fsdp=bool(plan is not None and plan.fsdp),
        launches=launches_json(launch_snapshot(fa, lk)), max_memory_allocated=torch.cuda.max_memory_allocated(),
    )
    dist.destroy_process_group()
    with open(os.path.join(workdir, "nccl.json"), "w") as f:
        json.dump(result, f)


def phase_tp_fsdp_trainer(state, seed=0):
    """``trainer.main`` on SD1.5 at full width, bf16, 512x512, the example
    recipe, global batch 8 on four gloo ranks of cuda:0 on a ``[1, 2, 2]``
    mesh with ``tensor_parallel_shard_params`` and ``fsdp_shard_params``:
    each fsdp rank takes 4 rows, each model_parallel rank 4 of the 8 heads,
    every leaf sharded over the fsdp pair. One chunk of 2 steps from
    in-memory batches with its checkpoint and one DDIM eval (2 steps, on
    every rank, rank 0 writing); then a one-rank NCCL world on ``[1, 1,
    1]`` that reads the checkpoint back whole and takes one step. Checks:
    finite ``loss.csv`` rows, one writer, the JSON, the checkpoint, the
    ranks' losses equal, each step's TP sums (``sd15_tp_sums``), FSDP2's
    collectives and launches at the rank's shapes (K1 5 at (16, 4096, 40)
    and 1 at (4, 4096, 512), the fused bf16 backward 5 at (16, 4096, 40),
    Lion's table once per model over the rank's local leaves), the eval's
    (K1 5 a DDIM step at (8, 4096, 40) and the decode's 1 at (1, 4096,
    512)), no grad copied before Lion, the checkpoint read back by the NCCL
    leg equal, in each gloo rank's parts, to that rank's states at the save
    (fingerprints), each model_parallel pair's shards of the whole leaves
    alike, the whole leaves' grads broadcast in each step and the replica
    check run once, the NCCL leg's backend, loss, launches and sums (none).
    Prints per rank the step p50, the TP sums' and FSDP2's collectives' ms
    a step (host clock, the card synchronized around each), the
    broadcast's, the replica check's s and peak memory; the four ranks
    share the card, so these describe the check, not scaling."""
    from stable_diffusion_training_tpu_torch.utils.json_io import read_json_file

    prompt = StubTokenizer()(["a photo of an astronaut riding a horse"], padding="max_length").input_ids
    root = os.path.join(REPO, ".cache", "chip_smoke_tp_fsdp")
    shutil.rmtree(root, ignore_errors=True)
    workdir = os.path.join(root, "ranks")
    os.makedirs(workdir)
    # the mesh goes into the JSON only: this process has no group of four ranks
    run_dir, base, cfg, config_path, _ = trainer_run(
        "chip_smoke_tp_fsdp/trainer", train_config(), seed, mesh_shape=TP_FSDP_MESH, fsdp_shard_params=True,
        tensor_parallel_shard_params=True, eval_sample_interval=TP_FSDP_TRAINER_STEPS,
        eval_sample_prompt_ids=prompt.tolist(), eval_num_inference_steps=TP_EVAL_STEPS,
        eval_sample_resolution=TRAIN_RES, eval_sample_dir=os.path.join(root, "eval"),
    )
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(dict(config_path=config_path, run_dir=run_dir, seed=seed), f)
    ckpt = f"{base}@0"  # the chunk's
    port = free_port()
    # the NCCL leg builds its state beside the gloo ranks, then reads their checkpoint
    leg = start_rank(tp_fsdp_nccl_rank, (os.path.join(ckpt, "train_state"), workdir))
    try:
        t0 = time.perf_counter()
        run_ranks(ddp_rank, lambda r: ("tp_fsdp_trainer", r, TP_FSDP_WORLD, port, workdir), TP_FSDP_WORLD)
        wall_s = time.perf_counter() - t0
        open(os.path.join(workdir, "checkpoint_ready"), "w").close()
        nccl_wall_s = finish_rank(leg)
    finally:
        stop_rank(leg)
    ranks = []
    for r in range(TP_FSDP_WORLD):
        with open(os.path.join(workdir, f"tp_fsdp_trainer_{r}.json")) as f:
            ranks.append(json.load(f))
    with open(cfg["loss_csv"]) as f:
        lines = f.read().splitlines()
    rows = [line.split(",") for line in lines[1:] if line]
    final = read_json_file(config_path)
    saved = all(os.path.isdir(os.path.join(ckpt, d)) for d in ("unet", "vae", "text_encoder", "train_state")) and (
        os.path.isdir(f"{base}-EMA@0/unet"))
    eval_dirs = sorted(os.listdir(cfg["eval_sample_dir"])) if os.path.isdir(cfg["eval_sample_dir"]) else []

    with open(os.path.join(workdir, "nccl.json")) as f:
        nccl = json.load(f)

    rows_per_rank = TRAIN_BATCH // FSDP_WORLD
    heads = sd15_heads() * rows_per_rank // TP_WORLD
    want_eval = dict(flash_fwd={(2 * sd15_heads() // TP_WORLD, 4096, 4096, 40, "bfloat16", "tma_narrow"):
                                5 * TP_EVAL_STEPS, (1, 4096, 4096, 512, "bfloat16", "tma_wide"): 1})
    launches_ok, totals = [], {}
    for r, got in enumerate(ranks):
        lion, _ = tp_fsdp_lion_launches("bfloat16", r)
        want_step = dict(
            flash_fwd={(heads, 4096, 4096, 40, "bfloat16", "tma_narrow"): 5,
                       (rows_per_rank, 4096, 4096, 512, "bfloat16", "tma_wide"): 1},
            flash_bwd_fused={(heads, 4096, 4096, 40, "bfloat16"): 5}, **lion,
        )
        steps = [launches_from_json(s["launches"]) for s in got["steps"]]
        expected_total = {}
        for _ in range(TP_FSDP_TRAINER_STEPS):
            add_launches(expected_total, want_step)
        add_launches(expected_total, want_eval)
        total = nonzero(launches_from_json(got["launches"]))
        launches_ok.append(len(steps) == TP_FSDP_TRAINER_STEPS and all(nonzero(s) == nonzero(want_step) for s in steps)
                           and [nonzero(launches_from_json(e["launches"])) for e in got["evals"]]
                           == [nonzero(want_eval)] and total == nonzero(expected_total))
        add_launches(totals, total)
    state["tp_fsdp_trainer_by_shape"] = totals
    nccl_lion = {}
    for leaves in sd15_quantized_leaves().values():
        add_launches(nccl_lion, {"lion_leaves": lion_table_launches(leaves, "bfloat16")})
    nccl_launches = nonzero(launches_from_json(nccl["launches"]))
    state["tp_fsdp_nccl_by_shape"] = nccl_launches
    readback = [nccl["slices"][r] == ranks[r]["fingerprints"][0] if ranks[r]["fingerprints"] else False
                for r in range(TP_FSDP_WORLD)]
    # each model_parallel pair (ranks 2f and 2f + 1) holds the same shards of the whole leaves
    whole_alike = bool(nccl["whole"]) and all(r["fingerprints"] for r in ranks) and all(
        ranks[2 * f + 1]["fingerprints"][0][k] == ranks[2 * f]["fingerprints"][0][k]
        for f in range(FSDP_WORLD) for k in nccl["whole"])
    checks = dict(
        loss_csv=lines[0] == "steps, step_size, loss, time, chunk, seed" and len(rows) == TP_FSDP_TRAINER_STEPS
        and all(math.isfinite(float(r[2])) for r in rows),
        json=(final["chunk_number"], final["chunk_steps"], final["master_seed"], final["model_path"])
        == (1, 1, seed + 1, ckpt),
        checkpoint=saved,
        rank0_writes=ranks[0]["calls"] == dict(write_model=4, write_train_state=1, json=3, png=1),
        other_ranks_write_nothing=all(not any(r["calls"].values()) for r in ranks[1:]),
        eval_png=eval_dirs == [f"step_{TP_FSDP_TRAINER_STEPS:08d}"],
        ranks_agree_on_losses=all([s["loss"] for s in r["steps"]] == [s["loss"] for s in ranks[0]["steps"]]
                                  for r in ranks),
        tp_sums=all(len(r["per_step"]) == TP_FSDP_TRAINER_STEPS and all(
            {k: s[k][0] for k in ("forward", "backward")} == sd15_tp_sums() for s in r["per_step"]) for r in ranks),
        fsdp_collectives=all(all(s["all_gather"][0] > 0 and s["reduce_scatter"][0] > 0 for s in r["per_step"])
                             for r in ranks),
        launches=all(launches_ok),
        no_grad_copies=all(r["grad_copies"] == 0 for r in ranks),
        checkpoint_read_back_equals_the_parts=all(readback),
        pairs_whole_leaves_alike=whole_alike,
        whole_grads_broadcast_each_step=all(len(r["whole_grads_broadcast_ms"]) == TP_FSDP_TRAINER_STEPS
                                            for r in ranks),
        replicas_checked_before_the_checkpoint=all(len(r["replica_check_s"]) == 1 for r in ranks),
        nccl=nccl["backend"] == "nccl" and nccl["world"] == 1 and len(nccl["steps"]) == 1
        and math.isfinite(nccl["steps"][0]["loss"]) and nccl["fsdp"] and not nccl["tp_split"]
        and nccl["tp_sums"] == {"forward": 0, "backward": 0}
        and nccl_launches == nonzero(step_launches(TRAIN_BATCH, nccl_lion)),
    )
    per_rank = []
    for r in ranks:
        timed = [s["ms"] for s in r["steps"][1:]]  # the first step holds the set-up
        later = r["per_step"][1:]
        per_rank.append(dict(
            rank=r["rank"], place=tp_fsdp_place(r["rank"]), step_ms=[s["ms"] for s in r["steps"]],
            step_p50_ms=statistics.median(timed),
            tp_sums_ms_p50=statistics.median(s["forward"][1] + s["backward"][1] for s in later),
            fsdp_comms_ms_p50=statistics.median(s["all_gather"][1] + s["reduce_scatter"][1] for s in later),
            per_step=r["per_step"], whole_grads_broadcast_ms=r["whole_grads_broadcast_ms"],
            replica_check_s=r["replica_check_s"], eval_ms=[e["ms"] for e in r["evals"]],
            max_memory_allocated=r["max_memory_allocated"], wall_s=r["wall_s"],
            losses=[s["loss"] for s in r["steps"]], **r["saves"],
        ))
    row = dict(
        world=TP_FSDP_WORLD, backend="gloo", mesh=TP_FSDP_MESH, model="sd15", batch=TRAIN_BATCH,
        rows_per_rank=rows_per_rank, heads_per_rank=sd15_heads() // TP_WORLD, resolution=TRAIN_RES,
        dtype="bfloat16", steps=len(rows), wall_s=wall_s, ranks=per_rank, tp_sums_per_step=sd15_tp_sums(),
        nccl=dict(world=nccl["world"], backend=nccl["backend"], wall_s=nccl_wall_s,
                  step_ms=[s["ms"] for s in nccl["steps"]], loss=nccl["steps"][0]["loss"] if nccl["steps"] else None,
                  set_up_s=nccl["set_up_s"], restore_s=nccl["restore_s"], fingerprint_s=nccl["fingerprint_s"],
                  tp_sums=nccl["tp_sums"], max_memory_allocated=nccl["max_memory_allocated"]),
        checkpoint_read_back=readback,
        launches_by_shape={k: {"x".join(map(str, s)): n for s, n in v.items()} for k, v in totals.items()},
        checks=checks, ok=all(checks.values()),
    )
    emit("tp_fsdp_trainer", **row)
    shutil.rmtree(root, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"tp_fsdp_trainer failed its checks: {checks}")


VAE_POLY_BATCH = 8  # train's VAE encode: global batch 8 at 512x512


def phase_vae_polyphase(state, seed=5, repeats=5):
    """The SD1.5 VAE encode at full width, 512x512, batch 8, in bf16 and f32
    (TF32 off): the encoder with ``polyphase_downsample`` (``ops.conv``: each
    of its three stride-2 convs as four stride-1 convs, f32 partials)
    against the stride-2 form holding the same seeded weights. In f32 the
    moments agree within 1e-4 of the largest |mean|; in bf16 each form is
    held against the f32 stride-2 encode of the same bf16 weights and
    pixels, and the polyphase form is no further off than twice the
    stride-2 form. Also: finite moments of the expected shape, and K1 once
    per encode at (8, 4096, 512) on the wide tensor-core route (bf16) or the
    f32 route, counted in the polyphase run. Prints each form's device ms
    (CUDA events) and their ratio; the JAX package measured the polyphase
    form slower on its TPU and kept it off by default."""
    import torch

    from stable_diffusion_training_tpu_torch.models import AutoencoderKL, configs
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(VAE_POLY_BATCH, 3, TRAIN_RES, TRAIN_RES, generator=gen, device="cuda") * 2 - 1
    total, out = {}, {}

    def moments(dist):
        return torch.cat([dist.mean, dist.logvar], dim=1).float()

    for dtype, route in ((torch.bfloat16, "tma_wide"), (torch.float32, "f32")):
        name_dt = str(dtype).replace("torch.", "")
        plain = seeded_models(seed, dtype, vae=(AutoencoderKL, configs.SD_VAE))["vae"]
        poly = AutoencoderKL(**configs.SD_VAE, device="cuda", dtype=dtype, polyphase_downsample=True)
        poly.load_state_dict(plain.state_dict())
        pixels = x.to(dtype)
        with torch.no_grad():
            fa.reset_launch_counts()
            got = moments(poly.encode(pixels).latent_dist)
            torch.cuda.synchronize()
            launches = dict(fa.flash_attention_fwd.launches_by_shape)
            want = moments(plain.encode(pixels).latent_dist)
            err = (got - want).abs().max().item()
            scale = want[:, :4].abs().max().item()
            if dtype == torch.float32:
                truth_err = None
                close = err <= 1e-4 * scale
            else:  # each bf16 form against the f32 stride-2 encode of the same bf16 weights and pixels
                ref = AutoencoderKL(**configs.SD_VAE, device="cuda", dtype=torch.float32)
                ref.load_state_dict(plain.state_dict())
                truth = moments(ref.encode(pixels.float()).latent_dist)
                del ref
                truth_err = dict(polyphase=(got - truth).abs().max().item(), stride2=(want - truth).abs().max().item())
                close = truth_err["polyphase"] <= 2 * truth_err["stride2"]
            finite = bool(torch.isfinite(got).all())
            shape = tuple(got.shape)
            poly_ms = cuda_ms(lambda: poly.encode(pixels), repeats)
            plain_ms = cuda_ms(lambda: plain.encode(pixels), repeats)
        key = (VAE_POLY_BATCH, 4096, 4096, 512, name_dt, route)
        add_launches(total, {"flash_fwd": launches})
        checks = dict(moments=close, finite=finite, shape=shape == (VAE_POLY_BATCH, 8, TRAIN_RES // 8, TRAIN_RES // 8),
                      launches=launches == {key: 1})
        out[name_dt] = dict(max_abs_err=err, largest_mean=scale, vs_f32_stride2=truth_err, polyphase_ms=poly_ms,
                            stride2_ms=plain_ms, ratio=poly_ms / plain_ms,
                            launches={"x".join(map(str, k)): n for k, n in launches.items()},
                            checks=checks, ok=all(checks.values()))
        del plain, poly, got, want
        torch.cuda.empty_cache()
    state["vae_polyphase_by_shape"] = total
    row = dict(model="sd15 vae", batch=VAE_POLY_BATCH, resolution=TRAIN_RES, by_dtype=out,
               ok=all(v["ok"] for v in out.values()))
    emit("vae_polyphase", **row)
    if not row["ok"]:
        raise AssertionError(f"vae_polyphase failed its checks: {out}")


# forward cases whose f32 shape a path runs: the f32 UNet call of the parity
# phase, the f32 train step
F32_FWD_PATHS = {
    "unet_l0": "parity", "unet_train": "train_f32", "vae_encode": "train_f32 and vae_polyphase", "sdxl_unet_l1": "sdxl_parity",
    "sdxl_train_parity_l1": "sdxl_train_parity", "sd21_parity_l1": "sd21_parity", "sd21_parity_l2": "sd21_parity",
    "vae_mid": "ddp_parity, fsdp_parity, tp_parity and tp_fsdp_parity ranks",
    "ddp_parity_unet": "ddp_parity and fsdp_parity ranks", "tp_parity_unet": "tp_parity and tp_fsdp_parity ranks",
}
SHORT = {"bfloat16": "bf16", "float32": "f32"}


def kernels_line(state):
    """The per-kernel record: each kernel at each shape its main paths give
    it, with its launches at that shape in the run of its path (the serving
    slice's, SDXL's and the refiner's, the timed train steps', SDXL's cache
    pass, the parity, sdxl_parity, train_parity and sdxl_train_parity calls)
    and its numbers from the kernels phase."""
    train = state.get("train_by_shape", {})
    train_f32 = state.get("train_f32_by_shape", {})
    sdxl_train = state.get("sdxl_train_by_shape", {})
    sdxl_train_parity = state.get("sdxl_train_parity_by_shape", {})
    sd21_trainer = state.get("sd21_trainer_by_shape", {})
    sd21_parity = state.get("sd21_parity_by_shape", {})
    # data parallelism: the launches of every rank's run, summed
    ddp_parity = state.get("ddp_parity_by_shape", {})
    ddp_trainer = state.get("ddp_trainer_by_shape", {})
    # FSDP: every gloo rank's run summed, fsdp_trainer's NCCL leg with them
    fsdp_parity = state.get("fsdp_parity_by_shape", {})
    fsdp_trainer = state.get("fsdp_trainer_by_shape", {})
    # TP: every gloo rank's run summed; tp_trainer's NCCL leg (one rank, whole models) apart
    tp_parity = state.get("tp_parity_by_shape", {})
    tp_trainer = state.get("tp_trainer_by_shape", {})
    tp_nccl = state.get("tp_nccl_by_shape", {})
    # TP with FSDP: every gloo rank's run summed; the NCCL leg (one rank) apart
    tp_fsdp_parity = state.get("tp_fsdp_parity_by_shape", {})
    tp_fsdp_trainer = state.get("tp_fsdp_trainer_by_shape", {})
    tp_fsdp_nccl = state.get("tp_fsdp_nccl_by_shape", {})
    vae_polyphase = state.get("vae_polyphase_by_shape", {})
    train_buckets = state.get("train_buckets_by_shape", {})  # train's 832x832 and 1088x1088 steps
    paths = {
        "bfloat16": [state.get(f"{p}_by_shape", {}) for p in ("slice", "sdxl", "sdxl_refiner", "sdxl_cache", "sd21")]
        + [train.get("flash_fwd", {}), sdxl_train.get("flash_fwd", {}), sd21_trainer.get("flash_fwd", {}),
           ddp_trainer.get("flash_fwd", {}), fsdp_trainer.get("flash_fwd", {}), tp_trainer.get("flash_fwd", {}),
           tp_nccl.get("flash_fwd", {}), tp_fsdp_trainer.get("flash_fwd", {}), tp_fsdp_nccl.get("flash_fwd", {}),
           vae_polyphase.get("flash_fwd", {}), train_buckets.get("flash_fwd", {})],
        "float32": [state.get(f"{p}_by_shape", {}) for p in ("parity", "sdxl_parity")]
        + [train_f32.get("flash_fwd", {}), sdxl_train_parity.get("flash_fwd", {}), sd21_parity.get("flash_fwd", {}),
           ddp_parity.get("flash_fwd", {}), fsdp_parity.get("flash_fwd", {}), tp_parity.get("flash_fwd", {}),
           tp_fsdp_parity.get("flash_fwd", {}), vae_polyphase.get("flash_fwd", {})],
    }
    entries = []
    for row in state.get("kernel_cases", []):
        bh, sq, d = row["shape_q"]
        shape = (bh, sq, row["shape_k"][1], d, row["dtype"], row["route"])  # the forward's by-shape key
        if row["case"].startswith("ragged") or (row["dtype"] == "float32" and row["case"] not in F32_FWD_PATHS):
            continue  # no path runs the forward kernel at this shape and dtype
        path = "" if row["dtype"] == "bfloat16" else f"; path: {F32_FWD_PATHS[row['case']]}"
        entries.append(dict(
            name=(f"flash_attention_fwd[{row['case']} {'x'.join(map(str, shape[:4]))} {SHORT[row['dtype']]}; "
                  f"route {row['route']}{path}]"),
            route="cuda", source=f"{CSRC}/flash_attention_fwd.cu",
            replaces=f"{JAX_OPS}/flash_attention.py:47",
            launches=sum(p.get(shape, 0) for p in paths[row["dtype"]]),
            max_abs_err=row["max_abs_err_o"], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
        ))
    f32_paths = {  # the fused f32 kernel's launches by shape, and the runs they come from
        "unet_train_f32": [(state.get("train_parity_f32_by_shape", {}), "train_parity f32"),
                           (ddp_parity.get("flash_bwd_f32", {}), "ddp_parity ranks"),
                           (fsdp_parity.get("flash_bwd_f32", {}), "fsdp_parity ranks")],
        "unet_train_f32_b8": [(train_f32.get("flash_bwd_f32", {}), "train_f32")],
        "sdxl_train_parity_f32": [(sdxl_train_parity.get("flash_bwd_f32", {}), "sdxl_train_parity")],
        "sd21_parity_l1_f32": [(sd21_parity.get("flash_bwd_f32", {}), "sd21_parity")],
        "sd21_parity_l2_f32": [(sd21_parity.get("flash_bwd_f32", {}), "sd21_parity")],
        "tp_parity_unet_f32": [(tp_parity.get("flash_bwd_f32", {}), "tp_parity ranks"),
                               (tp_fsdp_parity.get("flash_bwd_f32", {}), "tp_fsdp_parity ranks")],
    }
    bf16_paths = {  # the fused bf16 kernel's, likewise
        "unet_train": [(train.get("flash_bwd_fused", {}), "train"),
                       (tp_nccl.get("flash_bwd_fused", {}), "tp_trainer nccl"),
                       (tp_fsdp_nccl.get("flash_bwd_fused", {}), "tp_fsdp_trainer nccl")],
        "tp_fsdp_unet_train": [(tp_fsdp_trainer.get("flash_bwd_fused", {}), "tp_fsdp_trainer ranks")],
        "sdxl_train": [(sdxl_train.get("flash_bwd_fused", {}), "sdxl_train"),
                       (fsdp_trainer.get("flash_bwd_fused", {}), "fsdp_trainer nccl")],
        "sdxl_train_bucket": [(sdxl_train.get("flash_bwd_fused", {}), "sdxl_train 1152x896"),
                              (fsdp_trainer.get("flash_bwd_fused", {}), "fsdp_trainer nccl 1152x896")],
        "fsdp_sdxl_train": [(fsdp_trainer.get("flash_bwd_fused", {}), "fsdp_trainer ranks")],
        "fsdp_sdxl_train_bucket": [(fsdp_trainer.get("flash_bwd_fused", {}), "fsdp_trainer ranks 1152x896")],
        "sd21_train_l1": [(sd21_trainer.get("flash_bwd_fused", {}), "sd21_trainer")],
        "sd21_train_l2": [(sd21_trainer.get("flash_bwd_fused", {}), "sd21_trainer")],
        "sd21_train_bucket_l1": [(sd21_trainer.get("flash_bwd_fused", {}), "sd21_trainer 896x640")],
        "sd21_train_bucket_l2": [(sd21_trainer.get("flash_bwd_fused", {}), "sd21_trainer 896x640")],
        "ddp_unet_train": [(ddp_trainer.get("flash_bwd_fused", {}), "ddp_trainer ranks"),
                           (tp_trainer.get("flash_bwd_fused", {}), "tp_trainer ranks")],
        # the wide-head fused kernel (route fused_wide)
        "sd15_bucket_832_l1": [(train_buckets.get("flash_bwd_fused_wide", {}), "train 832x832")],
        "sd15_bucket_1088_l1": [(train_buckets.get("flash_bwd_fused_wide", {}), "train 1088x1088")],
    }
    for row in state.get("bwd_cases", []):
        bh, sq, d = row["shape_q"]
        shape = (bh, sq, row["shape_k"][1], d, row["dtype"])
        dims = "x".join(map(str, shape[:4]))
        common = dict(
            route="cuda", source=f"{CSRC}/flash_attention_bwd.cu", plain_ms=row["plain_ms"],
            library_ms=row["library_ms"],
        )
        if row["case"] in bf16_paths:  # a train step runs a fused bf16 kernel at this shape
            wrapper = "flash_attention_bwd_fused_wide" if row["route"] == "fused_wide" else "flash_attention_bwd_fused"
            for counts, path in bf16_paths[row["case"]]:
                entries.append(dict(
                    common, name=f"{wrapper}[{row['case']} {dims} bf16; K2 and K3 in one kernel; path: {path}]",
                    replaces=f"{JAX_OPS}/flash_attention.py:105,147",
                    launches=counts.get(shape, 0),
                    max_abs_err=max(row["max_abs_err"].values()), ms=row["call_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                ))
        elif row["case"] in f32_paths:
            for counts, path in f32_paths[row["case"]]:
                entries.append(dict(
                    common, name=f"flash_attention_bwd_f32_fused[{row['case']} {dims} f32; K2 and K3 in one "
                    f"kernel; path: {path}]",
                    replaces=f"{JAX_OPS}/flash_attention.py:105,147", launches=counts.get(shape, 0),
                    max_abs_err=max(row["max_abs_err"].values()), ms=row["call_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                ))
        elif row["route"] == "cuda_cores":
            # the CUDA-core pair, each kernel with its own time and work; the
            # plain and library times are the whole backward's. No path
            # of this script takes it (bf16 at D <= 128 and f32 at D <= 64
            # have their fused kernels; train_f32 steps at 512x512, where
            # the D = 80 level is plain attention): its path is its own
            # case, two calls.
            for kernel, grads, line in (("dq", ("dq",), 105), ("dkv", ("dk", "dv"), 147)):
                own = row["per_kernel"][kernel]
                entries.append(dict(
                    common, name=f"flash_attention_bwd_{kernel}[{row['case']} {dims} {SHORT[row['dtype']]}; "
                    f"path: its kernels-phase case]",
                    replaces=f"{JAX_OPS}/flash_attention.py:{line}", launches=row["launches"][f"bwd_{kernel}"],
                    max_abs_err=max(row["max_abs_err"][g] for g in grads), ms=own["ms"],
                    bound_ms=own["bound_ms"], bound_by=own["bound_by"],
                ))
    # the leaf-table entry: the train step's Lion, one launch per model a step
    train_paths = {"bfloat16": [(train, "train"), (ddp_trainer, "ddp_trainer ranks"), (tp_nccl, "tp_trainer nccl"),
                                (tp_fsdp_nccl, "tp_fsdp_trainer nccl")],
                   "float32": [(train_f32, "train_f32"), (ddp_parity, "ddp_parity ranks")]}
    for row in state.get("lion_model_cases", []):
        if row["compander"] != "exact":
            continue  # the train step's setting
        if row["model"] == "sdxl_unet":
            runs = [(sdxl_train, "sdxl_train"), (fsdp_trainer, "fsdp_trainer nccl")]
        elif row["model"] == "sdxl_unet_fsdp_half":
            runs = [(fsdp_trainer, "fsdp_trainer ranks")]
        elif row["model"].endswith("_fsdp_half"):
            runs = [(fsdp_parity, "fsdp_parity ranks")]
        elif row["model"].endswith("_tp_fsdp_quarter"):
            runs = ([(tp_fsdp_parity, "tp_fsdp_parity ranks")] if row["dtype"] == "float32"
                    else [(tp_fsdp_trainer, "tp_fsdp_trainer ranks")])
        elif row["model"].endswith("_tp_half"):
            runs = [(tp_parity, "tp_parity ranks")] if row["dtype"] == "float32" else [(tp_trainer, "tp_trainer ranks")]
        elif row["model"].startswith("sd21_"):
            runs = [(sd21_trainer, "sd21_trainer")]
        else:
            runs = train_paths[row["dtype"]]
        for counts, path in runs:
            entries.append(dict(
                name=(f"lion8bit_update_leaves[{row['model']} {row['leaves']} leaves {row['elements']} elements "
                      f"bs{row['bs']} {SHORT[row['dtype']]} exact, grads in torch layout, "
                      f"{len(row['launch_shapes'])} launch(es) a call; path: {path}]"),
                route="cuda", source=f"{CSRC}/lion8bit_update.cu",
                replaces=f"{JAX_OPS}/lion_kernel.py:56,274",
                launches=sum(counts.get("lion_leaves", {}).get(tuple(k), 0) for k in row["launch_shapes"]),
                max_abs_err=float(row["max_code_diff"]), ms=row["kernel_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=None,
            ))
    for row in state.get("lion_cases", []):
        if row["compander"] != "exact" or row["bs"] != LION_BS:
            continue  # the train step's setting
        # the earlier entries over grads in JAX order: no model path takes
        # them since the leaf table; their path is their kernels-phase case
        single = row["entry"] == "single"
        entries.append(dict(
            name=(f"lion8bit_update{'' if single else '_multi'}[{row['case']} "
                  f"{row['leaves']} leaves {row['elements']} elements bs{row['bs']} bf16 exact"
                  f"{', one launch per leaf' if single else ''}; path: its kernels-phase case]"),
            route="cuda", source=f"{CSRC}/lion8bit_update.cu",
            replaces=f"{JAX_OPS}/lion_kernel.py:{56 if single else 274}",
            launches=row["path_launches"],
            max_abs_err=float(row["max_code_diff"]), ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None,
        ))
    for row in state.get("lion_fused_cases", []):
        # K6/K7's path is their own entry: launches from each case's path run
        entries.append(dict(
            name=(f"fused_lion8bit_update[layout={row['layout']} {row['blocks']}x{row['bs']} "
                  f"{row['dtype']} exact{', cooperative' if row['cooperative'] else ''}; "
                  f"path: the fused_lion8bit_update entry]"),
            route="cuda", source=f"{CSRC}/lion8bit_update.cu",
            replaces=f"{JAX_OPS}/lion_kernel.py:{393 if row['layout'] == 'narrow' else 221}",
            launches=row["path_launches"], max_abs_err=float(row["max_code_diff"]),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
        ))
    return {"kernels": entries}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES))
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ not found beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if any(p in phases for p in RANK_PHASES):
        import multiprocessing.forkserver

        rank_context()
        multiprocessing.forkserver.ensure_running()  # its imports overlap the phases before the ranks
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    open(RECORD, "w").close()

    state = {"phases": phases}
    phase_gpu(state)  # always: every number below stands beside this card
    runners = dict(
        build=phase_build, kernels=phase_kernels, parity=phase_parity, slice=phase_slice,
        sdxl_parity=phase_sdxl_parity, sdxl=phase_sdxl, sdxl_refiner=phase_sdxl_refiner,
        train_parity=phase_train_parity, train=phase_train, trace_audit=phase_trace_audit,
        train_f32=lambda st: phase_train(st, warmup=2, steps=3, dtype="float32"), trainer=phase_trainer,
        sdxl_train_parity=phase_sdxl_train_parity, sdxl_train=phase_sdxl_train, sdxl_trainer=phase_sdxl_trainer,
        sd21_parity=phase_sd21_parity, sd21=phase_sd21, sd21_trainer=phase_sd21_trainer,
        ddp_parity=phase_ddp_parity, ddp_trainer=phase_ddp_trainer, fsdp_parity=phase_fsdp_parity,
        fsdp_trainer=phase_fsdp_trainer, tp_parity=phase_tp_parity, tp_trainer=phase_tp_trainer,
        tp_fsdp_parity=phase_tp_fsdp_parity, tp_fsdp_trainer=phase_tp_fsdp_trainer, vae_polyphase=phase_vae_polyphase,
    )
    started, seconds = time.perf_counter(), {}
    for name in ALL_PHASES[1:]:
        if name in phases:
            t0 = time.perf_counter()
            runners[name](state)
            seconds[name] = time.perf_counter() - t0
    shutil.rmtree(SDXL_CACHE_DIR, ignore_errors=True)  # sdxl_train's, read again by fsdp_trainer
    emit("phase_seconds", seconds=seconds, total_s=time.perf_counter() - started)

    line = kernels_line(state)
    if PATH_PHASES <= set(phases):
        idle = [e["name"] for e in line["kernels"] if not e["launches"]]
        if idle:
            raise AssertionError(f"checked at a shape its path never launched it at: {idle}")
    with open(RECORD, "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(line))
    print(state["smi"])
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
