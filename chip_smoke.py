#!/usr/bin/env python3
"""Drive the PyTorch port (``stable_diffusion_training_tpu_torch``) on one
NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases gpu,build,kernels
    python3 chip_smoke.py --phases gpu,build,train_f32   # the f32 train step alone
    python3 chip_smoke.py --phases gpu,build,sdxl_parity,sdxl,sdxl_refiner   # SDXL serving

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
   and wide kernels) is missing or spills.
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   with max errors against the stated tolerances, kernel / plain / library
   device times (CUDA events; the calls queued behind a spin kernel so the
   host's time per call is left out and reported apart where it matters)
   and the card's least time for the same work:
   flash-attention forward (K1) at the serving path's shapes, (16, 4096, 40)
   and (1, 4096, 512), in bf16 and f32 (TF32 off), at the train step's,
   (64, 4096, 40) and (8, 4096, 512) in bf16 and f32, at SDXL's, (20, 4096,
   64) in bf16 and f32, (24, 4096, 64) and (1, 16384, 512) in bf16, plus ragged cases
   (D = 40 and 512 with query and key counts off the tiles, D = 64 and 36),
   each with its route (``forward_route``: bf16 narrow or wide tensor-core
   kernel, the f32 kernels, the older CUDA-core kernel), whose counter
   alone must move, a repeat on the same inputs (bitwise equal on the f32
   route), the host's ms per call and the bytes the kernel streams from
   L2; at the four f32 shapes the older CUDA-core kernel, which the f32
   route replaced, checked and timed on the same inputs;
   flash-attention backward on its three routes (``backward_route``): the
   fused tensor-core kernel (bf16, K2 and K3 in one) at the train step's
   (64, 4096, 40) and at ragged cases (D = 64, and D = 40 with both counts
   off the tiles); the fused f32 kernel (K2 and K3 in one, CUDA cores) at
   train_parity's (8, 4096, 40), train_f32's (64, 4096, 40) and the same
   two ragged cases; the CUDA-core K2 and K3 at D = 36 bf16 (and, timed
   only, at (8, 4096, 40) f32 beside the fused f32 kernel): the whole
   call's time, each kernel's (torch.profiler), host ms per call, the fused
   kernels' dQ reduce-add or partial bytes, and two runs on the same inputs
   (dK and dV must be bitwise equal, and dQ too except on the bf16 route,
   whose dQ adds land in any order); the 8-bit Lion update of each SD1.5
   model (``lion_model``: every quantized leaf at its real torch shape and
   permutation, bs 16, bf16 grads with both companders and f32 grads): the
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
   own case; ``probe_lion.py``'s variants of both Lion kernels (what powf,
   the divides, the transposed reads and the math cost), the base ones
   held to the plain version's signs; the functional entry ``fused_lion8bit_update``
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
   torch.profiler (``profile`` line).
11. ``train_f32``: the same step with ``mixed_precision: "float32"`` (TF32
   off), the fidelity configuration: 2 warm-up steps, then 3 timed (K1 5 +
   1 on the f32 route, none on the older CUDA-core forward; the fused f32
   backward 5, the bf16 one and the CUDA-core pair
   none, Lion as above with f32 grads), step p50, images/s, peak memory, then
   one step under torch.profiler (``profile`` line: the backward's device
   time, the idle share). f32 dQ repeats bitwise; bf16 dQ does not.
12. ``trainer``: the port's trainer through ``trainer.main``, the body of
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

Any failed check raises, so the script exits non-zero and prints no result.
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
    "train_f32", "trainer",
)
# the phases whose runs give the kernels line its launches
PATH_PHASES = {"kernels", "parity", "slice", "sdxl_parity", "sdxl", "sdxl_refiner", "train_parity", "train", "train_f32"}

# H100 SXM peaks (NVIDIA data sheet, dense): 989 TFLOP/s bf16 tensor core,
# 67 TFLOP/s f32 on the CUDA cores (TF32 would change the numerics), 3.35
# TB/s HBM3. exp runs on the SFUs: 16 results per clock per SM (CUDA
# programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz boost.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_EXPS = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12

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
HOPPER_KERNELS = ("flash_fwd_tma_kernel", "flash_bwd_fused_kernel")
# the f32 kernels (CUDA cores, cp.async): the fused backward and the
# forward's two; each built, and spilling nothing
F32_KERNELS = ("flash_bwd_f32_fused_kernel", "flash_fwd_f32_narrow_kernel", "flash_fwd_f32_wide_kernel")


def emit(phase, **fields):
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    with open(RECORD, "a") as f:
        f.write(line + "\n")


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
    """Builds every kernel library; reads back, from the ptxas report and
    the built code, what each kernel became: registers and spill bytes of
    every kernel, and for each flash-attention Hopper kernel (the forward's
    and the fused backward) its count of wgmma (``HGMMA``) and TMA load
    (``UTMALDG``) instructions. Those kernels must be built, use both and
    spill nothing; the f32 kernels (``F32_KERNELS``) must be built and
    spill nothing."""
    from stable_diffusion_training_tpu_torch.ops import cuda_build, flash_attention, lion_kernel

    start = time.perf_counter()
    paths = cuda_build.build_many({**flash_attention.LIBRARIES, **lion_kernel.LIBRARIES})
    seconds = time.perf_counter() - start
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
        kernels=kernels, ptxas_advisories=advisories,
    )
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


def _bound(bh, sq, sk, d, dtype_name, products=2, exps=1, reads_q=2, reads_k=2, writes_q=0, writes_k=0, stats=1,
           f32_q=0):
    """Least time for attention work: ``products`` matmuls of 2*bh*sq*sk*d
    flops and ``exps`` exps per logit against HBM traffic of ``reads_q`` +
    ``writes_q`` (bh, sq, d) and ``reads_k`` + ``writes_k`` (bh, sk, d)
    tensors, ``stats`` f32 (bh, sq) rows and ``f32_q`` passes over an f32
    (bh, sq, d) tensor."""
    import torch

    itemsize = torch.finfo(getattr(torch, dtype_name)).bits // 8
    flops = 2.0 * products * bh * sq * sk * d
    n_exps = float(exps) * bh * sq * sk
    nbytes = itemsize * bh * d * ((reads_q + writes_q) * sq + (reads_k + writes_k) * sk)
    nbytes += 4 * stats * bh * sq + 4 * f32_q * bh * sq * d
    times = {
        "operations": max(flops / PEAK_FLOPS[dtype_name], n_exps / PEAK_EXPS),
        "bytes": nbytes / PEAK_BYTES,
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by, flops


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
            o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale)
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
            plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_reference(q, k, v, scale), reps)
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
            bound_ms, bound_by, flops = _bound(bh, sq, sk, d, name_dt, reads_q=1, writes_q=1)
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
    state["lion_probe_cases"] = lion_probe_cases()
    bad = [
        r for r in results + state["bwd_cases"] + state["lion_cases"] + state["lion_fused_cases"]
        + state["lion_model_cases"] + state["lion_probe_cases"] if not r["ok"]
    ]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


# launches of one flash_attention_bwd call, by route (fa.backward_route)
BWD_ROUTE_LAUNCHES = {
    "fused": dict(bwd_fused=1, bwd_f32=0, bwd_dq=0, bwd_dkv=0),
    "f32_fused": dict(bwd_fused=0, bwd_f32=1, bwd_dq=0, bwd_dkv=0),
    "cuda_cores": dict(bwd_fused=0, bwd_f32=0, bwd_dq=1, bwd_dkv=1),
}


def bwd_launches(fa):
    return dict(bwd_fused=fa.flash_attention_bwd_fused.launches, bwd_f32=fa.flash_attention_bwd_f32_fused.launches,
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
        fused = route == "fused"
        args = (q, k, v, do, lse, delta, scale)
        fa.reset_launch_counts()
        grads = fa.flash_attention_bwd(*args)
        again = fa.flash_attention_bwd(*args)
        torch.cuda.synchronize()
        launches = bwd_launches(fa)
        expected = fa.flash_attention_bwd_reference(*args)
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
        reps = 10 if d <= 64 else 3
        host = []
        call_ms = cuda_ms(lambda: fa.flash_attention_bwd(*args), reps, host=host)
        kernel_ms = profiled_kernel_ms(lambda: fa.flash_attention_bwd(*args), reps)
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(*args), 2, warmup=1)
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
        if name == "unet_train_f32":  # the route it replaces, on the same inputs
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
        f32_q = {"fused": 2, "f32_fused": 2 * n_parts, "cuda_cores": 0}[route]
        bound = _bound(bh, sq, sk, d, name_dt, products=5, writes_q=1, writes_k=2, stats=2, f32_q=f32_q)
        per_kernel = {}
        if route == "f32_fused":
            for kernel in ("flash_bwd_f32_fused_kernel", "flash_bwd_f32_dq_sum_kernel"):
                per_kernel[kernel] = dict(ms=sum(ms for n, ms in kernel_ms.items() if kernel in n))
        if route == "cuda_cores":
            for kernel, products, writes in (("dq", 3, dict(writes_q=1)), ("dkv", 4, dict(writes_k=2))):
                own = _bound(bh, sq, sk, d, name_dt, products=products, stats=2, **writes)
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
        # bf16 grad in, bf16 sign out, int8 codes in and out, f32 scale in and out per block
        nbytes = n * (2 + 2 + 1 + 1) + (n // bs) * 8
        row = dict(
            case=name, entry=entry, compander=compander, bs=bs, leaves=len(sizes), elements=n,
            path_launches=path_launches,
            launch_shapes=sorted({(m // bs, bs) for m in sizes}) if entry == "single"
            else [(len(sizes), n // bs, bs)],
            updates_equal=updates_equal, scales_equal=scales_equal, max_code_diff=max_code_diff,
            codes_off_by_one=codes_off, ok=updates_equal and scales_equal and max_code_diff <= 1,
            kernel_ms=kernel_ms, host_ms_per_call=host[0], plain_ms=plain_ms,
            bound_ms=nbytes / PEAK_BYTES * 1e3,
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
        # grad in, sign out (grad's dtype), int8 codes in and out, f32 scale in and out per block
        nbytes = n * (2 * grad.element_size() + 2) + nb * 8
        row = dict(
            case=f"largest_unet_leaf_{layout}_bs{bs}_{name_dt}", layout=layout, bs=bs, dtype=name_dt,
            elements=n, blocks=nb, cooperative=bs > 64, path_launches=launches,
            updates_equal=updates_equal, scales_equal=scales_equal, max_code_diff=max_code_diff,
            codes_off_by_one=codes_off,
            ok=updates_equal and scales_equal and max_code_diff <= 1 and launches == 3,
            kernel_ms=kernel_ms, entry_ms=entry_ms, plain_ms=plain_ms,
            bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes", gbytes_per_s=nbytes / kernel_ms / 1e6,
        )
        rows.append(row)
        emit("kernels_lion_fused", **row)
        del grad, codes, scales, c, s, work_codes, work_scales
        torch.cuda.empty_cache()
    return rows


def sd15_quantized_leaves():
    """{model: [(name, torch shape, permutation to the JAX layout)]} of the
    SD1.5 leaves that the example config quantizes."""
    from stable_diffusion_training_tpu_torch.models import CLIPTextModel, UNet2DConditionModel, configs, hf_io
    from stable_diffusion_training_tpu_torch.optim import create_mask

    out = {}
    for model_name, model in (
        ("unet", UNet2DConditionModel(**configs.SD15_UNET, device="meta")),
        ("text_encoder", CLIPTextModel(**configs.CLIP_VIT_L, device="meta")),
    ):
        mask = create_mask(model, EXAMPLE_EXCLUDED_FROM_QUANTIZATION)
        paths = hf_io.jax_param_paths(model)
        out[model_name] = [(n, tuple(p.shape), paths[n][1]) for n, p in model.named_parameters() if mask[n]]
    return out


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


def lion_model_cases():
    """The whole 8-bit Lion update of each SD1.5 model at its real leaf
    shapes and permutations, bs 16: the new route (``lion8bit_update_leaves_``,
    one launch, grads in torch layout) against its plain version
    (``lion8bit_update_leaves_reference``) and against the old route (permute
    copies, the single-leaf entry per leaf over the bucket limit, the
    multi-leaf entry over the rest) on the same inputs: update signs and
    scales bitwise equal to the plain version, codes at most one apart
    (counted), codes bitwise equal to the old route's (both are powf's).
    Times: each route's device ms and host ms a call, the old route's copies
    and kernels apart, the bound (bytes of the fused update) and GB/s."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk

    rows = []
    for model_name, leaves in sd15_quantized_leaves().items():
        for dtype, compander in ((torch.bfloat16, "exact"), (torch.bfloat16, "fast"), (torch.float32, "exact")):
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
            launches = lk.lion8bit_update_leaves_.launches
            old_route = lambda: old_lion_route(leaves, grads, old_c, old_s, compander)
            old_route()
            torch.cuda.synchronize()
            updates_equal = all(bool(torch.equal(u, e)) for u, e in zip(upds, e_upd))
            contiguous = all(u.is_contiguous() and u.shape == g.shape for u, g in zip(upds, grads))
            scales_equal = all(bool(torch.equal(s, e)) for s, e in zip(new_s, e_scales))
            max_code_diff = max(int((c.int() - e.int()).abs().max()) for c, e in zip(new_c, e_codes))
            codes_off = sum(int((c != e).sum()) for c, e in zip(new_c, e_codes))
            codes_differ_from_old = sum(int((c != o).sum()) for c, o in zip(new_c, old_c))
            scales_differ_from_old = sum(int((s != o).sum()) for s, o in zip(new_s, old_s))
            del e_upd, e_codes, e_scales, upds
            n = sum(g.numel() for g in grads)
            nb = n // LION_BS
            host_new, host_old = [], []
            new_ms = cuda_ms(lambda: lk.lion8bit_update_leaves_(grads, table, compander=compander), 10, host=host_new)
            old_ms = cuda_ms(old_route, 5, host=host_old)
            copies_ms = cuda_ms(lambda: permute_grads(leaves, grads), 5)
            jax_grads = permute_grads(leaves, grads)
            old_kernels_ms = cuda_ms(lambda: old_lion_route(leaves, grads, old_c, old_s, compander, jax_grads), 5)
            del jax_grads
            plain_ms = cuda_ms(lambda: lk.lion8bit_update_leaves_reference(grads, codes, scales, perms,
                                                                           compander=compander), 1, warmup=1)
            # grad in, sign out (grad's dtype), int8 code in and out, f32 scale in and out per block
            nbytes = n * (2 * grads[0].element_size() + 2) + nb * 8
            bound_ms = nbytes / PEAK_BYTES * 1e3
            ok = (updates_equal and contiguous and scales_equal and max_code_diff <= 1 and launches == 1
                  and codes_differ_from_old == 0 and scales_differ_from_old == 0)
            row = dict(
                case=f"{model_name}_{name_dt}_{compander}", model=model_name, dtype=name_dt, compander=compander,
                bs=LION_BS, leaves=len(leaves), transposed_leaves=sum(perm is not None for perm in perms),
                elements=n, launches_per_call=launches, table_tiles=table.n_tiles,
                updates_equal=updates_equal, updates_contiguous_torch_layout=contiguous, scales_equal=scales_equal,
                max_code_diff=max_code_diff, codes_off_by_one=codes_off,
                codes_differ_from_old_route=codes_differ_from_old,
                scales_differ_from_old_route=scales_differ_from_old, ok=ok,
                kernel_ms=new_ms, host_ms_per_call=host_new[0], plain_ms=plain_ms,
                old_route_ms=old_ms, old_route_host_ms_per_call=host_old[0], old_permute_copies_ms=copies_ms,
                old_kernels_ms=old_kernels_ms, bound_ms=bound_ms, bound_by="bytes",
                share_of_bound=bound_ms / new_ms, gbytes_per_s=nbytes / new_ms / 1e6,
                launch_shape=[len(leaves), n, LION_BS, name_dt],
            )
            rows.append(row)
            emit("kernels_lion_model", **row)
            del grads, codes, scales, new_c, new_s, old_c, old_s, table
            torch.cuda.empty_cache()
    both = {}
    for r in rows:
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


def lion_probe_cases():
    """``probe_lion.py``'s variants (both Lion kernels with powf, divides,
    transposed reads or math edited out) over each model's leaves, bf16,
    exact: what each part costs. A base variant must match the plain
    version's signs."""
    import probe_lion

    rows, summary = probe_lion.measure(reps=5, report=lambda row: emit("kernels_lion_probe", **row))
    emit("kernels_lion_probe_saved", **summary)
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
            "one CFG denoise step (UNet batch 2 + DDIM step)", {"flash_ms": ("flash_fwd",)}, top=15,
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
            "one SDXL CFG denoise step (UNet batch 2 at 128x128 latents + DDIM step)",
            {"flash_ms": ("flash_fwd",)}, top=15,
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
            "one SDXL refiner CFG denoise step (UNet batch 2 at 128x128 latents + DDIM step)",
            {"flash_ms": ("flash_fwd",)}, top=15,
        )
    del pipe, models, results
    state.pop("sdxl_image", None)
    torch.cuda.empty_cache()


def profile_step(fn, what, groups, top):
    """Where one step's device time goes: torch.profiler's kernel table for
    one call of ``fn``, the device's busy share of its wall time (one
    stream, so the kernels' sum is the busy time), and the device ms of
    each of ``groups`` ({field: kernel-name substrings})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = host_ms(fn)
    kernels = sorted(device_kernels(prof), reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    emit(
        "profile", what=what, wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms,
        **{field: sum(ms for ms, _, name in kernels if any(n in name for n in names))
           for field, names in groups.items()},
        h2d_copies=sum(n for _, n, name in kernels if "Memcpy HtoD" in name),
        n_kernel_names=len(kernels), n_launches=sum(n for _, n, _ in kernels),
        top=[dict(ms=ms, count=n, name=name[:120]) for ms, n, name in kernels[:top]],
    )


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
    kernel_launches = dict(fwd=5, fwd_routes={"f32": 5}, bwd_fused=0, bwd_f32=5, bwd_dq=0, bwd_dkv=0)
    bf16_launches = dict(fwd=5, fwd_routes={"tma_narrow": 5}, bwd_fused=5, bwd_f32=0, bwd_dq=0, bwd_dkv=0)
    plain_launches = dict(fwd=0, fwd_routes={}, bwd_fused=0, bwd_f32=0, bwd_dq=0, bwd_dkv=0)
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

    def step():
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
        flash_fwd=6 * steps, flash_bwd_fused=0, flash_bwd_f32=0, flash_bwd_dq=0, flash_bwd_dkv=0,
        lion_leaves=2 * steps, lion_single=0, lion_multi=0,
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
    profile_step(
        step, f"one SD1.5 train step ({dtype}, batch 8, 512x512)",
        {"flash_fwd_ms": ("flash_fwd",), "flash_bwd_ms": ("flash_bwd", "bwd_dq_kernel", "bwd_dkv_kernel"),
         "lion_ms": ("lion_leaves", "lion_single", "lion_multi")}, top=20,
    )


def train_launches(fa, lk):
    """The launch counts of the train step's kernels, by wrapper."""
    return dict(
        flash_fwd=fa.flash_attention_fwd.launches, flash_bwd_fused=fa.flash_attention_bwd_fused.launches,
        flash_bwd_f32=fa.flash_attention_bwd_f32_fused.launches,
        flash_bwd_dq=fa.flash_attention_bwd_dq.launches, flash_bwd_dkv=fa.flash_attention_bwd_dkv.launches,
        lion_leaves=lk.lion8bit_update_leaves_.launches, lion_single=lk.lion8bit_update_.launches,
        lion_multi=lk.lion8bit_update_multi_.launches,
    )


TRAINER_STEPS = 3  # steps per chunk (the example config's chunks run to the loader's end)
# kernels the bf16 step never launches: the f32 and CUDA-core backwards, and
# Lion's earlier entries (the leaf table takes every SD1.5 leaf)
OFF_BF16_STEP = ("flash_bwd_f32", "flash_bwd_dq", "flash_bwd_dkv", "lion_single", "lion_multi")


def _tree_bytes(path):
    total = 0
    for root, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:  # deleted between the walk and the stat (rotation)
                pass
    return total


def phase_trainer(state, seed=0):
    """The port's trainer at full width through ``trainer.main``: one chunk,
    then a resume from its ``train_state/``, with the artifacts checked."""
    import gc
    import shutil
    import threading

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
    run_dir = os.path.join(REPO, ".cache", "chip_smoke_trainer")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    free_before = shutil.disk_usage(run_dir).free
    base = os.path.join(run_dir, "ckpt", "run")
    cfg = dict(
        train_config().__dict__,
        model_path=f"{base}@0", test_save_path=os.path.join(run_dir, "probe"),
        loss_csv=os.path.join(run_dir, "loss.csv"), master_seed=seed, chunk_number=0,
        chunk_limit=1, chunk_steps=0, keep_trained_model_buffer=1, loss_logging_interval=1,
        DEBUG=False, numb_of_prefetched_batch=1, device_prefetch_depth=2,
    )
    config_path = os.path.join(run_dir, "model_properties.json")
    with open(config_path, "w") as f:
        json.dump(cfg, f)

    # instrumentation of this run only: the time and bytes of each save, and
    # the restored momentum held against the files it came from
    timings = {"save_model": [], "save_train_state": []}
    restored_ok = []

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            out_dir = kwargs.get("output_dir") or args[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            timings[name].append(dict(s=time.perf_counter() - t0, bytes=_tree_bytes(out_dir)))
            return out
        return wrapper

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

    save_model, save_state, restore = trainer.save_model, trainer.save_train_state, trainer.restore_train_state
    trainer.save_model = timed("save_model", save_model)
    trainer.save_train_state = timed("save_train_state", save_state)
    trainer.restore_train_state = checked_restore
    peak = [0]
    stop = threading.Event()

    def watch_disk():
        while not stop.is_set():
            peak[0] = max(peak[0], _tree_bytes(run_dir))
            stop.wait(0.2)

    watcher = threading.Thread(target=watch_disk, daemon=True)
    watcher.start()
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
        stop.set()
        watcher.join(timeout=10)
        trainer.save_model, trainer.save_train_state, trainer.restore_train_state = save_model, save_state, restore

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
        save_model_s=[t["s"] for t in timings["save_model"]],
        save_train_state_s=[t["s"] for t in timings["save_train_state"]],
        save_model_bytes=[t["bytes"] for t in timings["save_model"]],
        save_train_state_bytes=[t["bytes"] for t in timings["save_train_state"]],
        bytes_written=sum(t["bytes"] for ts in timings.values() for t in ts),
        peak_disk_bytes=peak[0], disk_free_before=free_before, launches=launches,
        restored_momentum_leaves=len(restored_ok), checks=checks, ok=all(checks.values()),
    )
    emit("trainer", **row)
    shutil.rmtree(run_dir, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"trainer failed its checks: {checks}")


# forward cases whose f32 shape a path runs: the f32 UNet call of the parity
# phase, the f32 train step
F32_FWD_PATHS = {
    "unet_l0": "parity", "unet_train": "train_f32", "vae_encode": "train_f32", "sdxl_unet_l1": "sdxl_parity",
}
SHORT = {"bfloat16": "bf16", "float32": "f32"}


def kernels_line(state):
    """The per-kernel record: each kernel at each shape its main paths give
    it, with its launches at that shape in the run of its path (the serving
    slice's, SDXL's and the refiner's, the timed train steps', the parity,
    sdxl_parity and train_parity calls) and its numbers from the kernels
    phase."""
    train = state.get("train_by_shape", {})
    train_f32 = state.get("train_f32_by_shape", {})
    paths = {
        "bfloat16": [state.get(f"{p}_by_shape", {}) for p in ("slice", "sdxl", "sdxl_refiner")]
        + [train.get("flash_fwd", {})],
        "float32": [state.get(f"{p}_by_shape", {}) for p in ("parity", "sdxl_parity")]
        + [train_f32.get("flash_fwd", {})],
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
    f32_paths = {  # the fused f32 kernel's launches by shape, and the run they come from
        "unet_train_f32": (state.get("train_parity_f32_by_shape", {}), "train_parity f32"),
        "unet_train_f32_b8": (train_f32.get("flash_bwd_f32", {}), "train_f32"),
    }
    for row in state.get("bwd_cases", []):
        bh, sq, d = row["shape_q"]
        shape = (bh, sq, row["shape_k"][1], d, row["dtype"])
        dims = "x".join(map(str, shape[:4]))
        common = dict(
            route="cuda", source=f"{CSRC}/flash_attention_bwd.cu", plain_ms=row["plain_ms"],
            library_ms=row["library_ms"],
        )
        if row["case"] == "unet_train":  # the train step runs the fused kernel at this shape
            entries.append(dict(
                common, name=f"flash_attention_bwd_fused[unet_train {dims} bf16; K2 and K3 in one kernel]",
                replaces=f"{JAX_OPS}/flash_attention.py:105,147",
                launches=train.get("flash_bwd_fused", {}).get(shape, 0),
                max_abs_err=max(row["max_abs_err"].values()), ms=row["call_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"],
            ))
        elif row["case"] in f32_paths:
            counts, path = f32_paths[row["case"]]
            entries.append(dict(
                common, name=f"flash_attention_bwd_f32_fused[{row['case']} {dims} f32; K2 and K3 in one kernel; "
                f"path: {path}]",
                replaces=f"{JAX_OPS}/flash_attention.py:105,147", launches=counts.get(shape, 0),
                max_abs_err=max(row["max_abs_err"].values()), ms=row["call_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"],
            ))
        elif row["route"] == "cuda_cores":
            # the CUDA-core pair, each kernel with its own time and work; the
            # plain and library times are the whole backward's. No model
            # path takes it (f32 and bf16 at D <= 64 have their fused
            # kernels): its path is its own case, two calls.
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
    train_paths = {"bfloat16": (train, "train"), "float32": (train_f32, "train_f32")}
    for row in state.get("lion_model_cases", []):
        if row["compander"] != "exact":
            continue  # the train step's setting
        counts, path = train_paths[row["dtype"]]
        entries.append(dict(
            name=(f"lion8bit_update_leaves[{row['model']} {row['leaves']} leaves {row['elements']} elements "
                  f"bs{row['bs']} {SHORT[row['dtype']]} exact, grads in torch layout, one launch; path: {path}]"),
            route="cuda", source=f"{CSRC}/lion8bit_update.cu",
            replaces=f"{JAX_OPS}/lion_kernel.py:56,274",
            launches=counts.get("lion_leaves", {}).get(tuple(row["launch_shape"]), 0),
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
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    open(RECORD, "w").close()

    state = {}
    phase_gpu(state)  # always: every number below stands beside this card
    if "build" in phases:
        phase_build(state)
    if "kernels" in phases:
        phase_kernels(state)
    if "parity" in phases:
        phase_parity(state)
    if "slice" in phases:
        phase_slice(state)
    if "sdxl_parity" in phases:
        phase_sdxl_parity(state)
    if "sdxl" in phases:
        phase_sdxl(state)
    if "sdxl_refiner" in phases:
        phase_sdxl_refiner(state)
    if "train_parity" in phases:
        phase_train_parity(state)
    if "train" in phases:
        phase_train(state)
    if "train_f32" in phases:
        phase_train(state, warmup=2, steps=3, dtype="float32")
    if "trainer" in phases:
        phase_trainer(state)

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
