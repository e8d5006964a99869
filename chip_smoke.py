#!/usr/bin/env python3
"""Drive the PyTorch port (``stable_diffusion_training_tpu_torch``) on one
NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases gpu,build,kernels

Phases, one JSON line each:

1. ``gpu``: the card's name and power limit (nvidia-smi), torch and CUDA.
2. ``build``: ``nvcc`` builds the flash-attention forward kernel from
   ``stable_diffusion_training_tpu_torch/csrc/`` for sm_90a; the compiler's
   register and spill report goes to ``chiprun_out/chip_smoke_build.log``.
3. ``kernels``: the kernel against its plain PyTorch version on the card at
   the serving path's shapes, (16, 4096, 40) and (1, 4096, 512), in bf16 and
   f32 (TF32 off), plus a ragged case; max abs error of O and lse against the
   stated tolerances, kernel / plain / library times (CUDA events) and the
   card's least time for the same work.
4. ``parity``: one full-width SD1.5 UNet call at 512x512 in f32 (TF32 off),
   seeded weights, attention_backend "auto" (kernel) against "xla" (plain).
5. ``slice``: the SD1.5 text-to-image pipeline at full width in bf16,
   seeded weights, 512x512, one prompt (CFG batch 2), a few DDIM steps after
   a warm-up run. Launch counts are zeroed just before one run and read
   just after it: the kernel must run 5 times per step (the 64x64 latent
   self-attentions) and once in the VAE decode. Then the pipeline and its
   stages (encode, denoise loop, decode) are timed five times each on the
   host clock (medians and every run), and one denoise step runs under
   torch.profiler (``profile`` line: kernel times by name, the device's
   idle share).

Any failed check raises, so the script exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "stable_diffusion_training_tpu_torch"
KERNEL_SOURCE = f"{PACKAGE}/csrc/flash_attention_fwd.cu"
KERNEL_REPLACES = "stable_diffusion_training_tpu/ops/flash_attention.py:47"
ALL_PHASES = ("gpu", "build", "kernels", "parity", "slice")

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
# full-width f32 UNet, kernel vs plain attention: max |diff| / max |ref|.
# Only the attention's summation order differs; 1e-4 relative is ~1000 f32
# ulps of headroom through 16 transformer blocks and 22 resnets.
PARITY_REL_TOL = 1e-4


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    from stable_diffusion_training_tpu_torch.ops import cuda_build

    start = time.perf_counter()
    path = cuda_build.build("flash_attention_fwd", ("flash_attention_fwd.cu",))
    seconds = time.perf_counter() - start
    log = cuda_build.BUILD_LOG.get("flash_attention_fwd", (0.0, "(already built)"))[1]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_build.log"), "w") as f:
        f.write(log)
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(seconds, 3), library=os.path.relpath(path, REPO), ptxas=ptxas)


def _bound(bh, sq, sk, d, dtype_name):
    import torch

    itemsize = torch.finfo(getattr(torch, dtype_name)).bits // 8
    flops = 4.0 * bh * sq * sk * d
    exps = float(bh) * sq * sk
    nbytes = itemsize * bh * d * (2 * sq + 2 * sk) + 4 * bh * sq
    times = {
        "operations": max(flops / PEAK_FLOPS[dtype_name], exps / PEAK_EXPS),
        "bytes": nbytes / PEAK_BYTES,
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by, flops


def phase_kernels(state):
    import torch
    import torch.nn.functional as F

    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = [
        ("unet_l0", 16, 4096, 4096, 40),
        ("vae_mid", 1, 4096, 4096, 512),
        ("ragged", 4, 3000, 2100, 64),
        ("ragged_d36", 2, 1000, 777, 36),  # bf16 off the tensor-core path
    ]
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        name_dt = str(dtype).replace("torch.", "")
        tol = TOLERANCE[name_dt]
        for name, bh, sq, sk, d in cases:
            q = torch.randn(bh, sq, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(bh, sk, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(bh, sk, d, generator=gen, device="cuda").to(dtype)
            scale = d**-0.5
            o, lse = fa.flash_attention_fwd(q, k, v, scale)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale)
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            ok = err_o <= tol["o"] and err_lse <= tol["lse"]
            reps = 20 if d <= 64 else 5
            kernel_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, scale), reps)
            plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_reference(q, k, v, scale), reps)
            try:  # as (1, B*H, S, D), the 4-D layout its fused backends take
                library_ms = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale),
                    reps,
                )
            except RuntimeError:  # no SDPA backend takes this shape/dtype
                library_ms = None
            bound_ms, bound_by, flops = _bound(bh, sq, sk, d, name_dt)
            row = dict(
                case=name, shape_q=[bh, sq, d], shape_k=[bh, sk, d], dtype=name_dt,
                max_abs_err_o=err_o, max_abs_err_lse=err_lse, tol_o=tol["o"],
                tol_lse=tol["lse"], ok=ok, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                kernel_tflops=flops / kernel_ms / 1e9,
            )
            results.append(row)
            emit("kernels", **row)
            del q, k, v, o, lse, o_ref, lse_ref
            torch.cuda.empty_cache()
    state["kernel_cases"] = results
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


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
        out_p = plain(sample, t, ctx)
        plain_launches = fa.flash_attention_fwd.launches - launches
    diff = (out_k - out_p).abs().max().item()
    ref_max = out_p.abs().max().item()
    rel = diff / ref_max
    ok = bool(torch.isfinite(out_k).all()) and rel <= PARITY_REL_TOL
    emit(
        "parity", shape=list(out_k.shape), max_abs_diff=diff, max_abs_ref=ref_max,
        max_rel_diff=rel, rel_tol=PARITY_REL_TOL, kernel_launches=launches,
        plain_launches=plain_launches, ok=ok,
    )
    del unet, plain
    torch.cuda.empty_cache()
    if not ok or launches != 5 or plain_launches != 0:
        raise AssertionError("full-width UNet: kernel and plain attention disagree")


def phase_slice(state, steps=4, seed=0, repeats=5):
    import torch

    from stable_diffusion_training_tpu_torch.diffusion import DDIMScheduler
    from stable_diffusion_training_tpu_torch.models import (
        AutoencoderKL, CLIPTextModel, UNet2DConditionModel, configs, random_init_,
    )
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.pipeline import StableDiffusionPipeline

    set_tf32(False)
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    unet = UNet2DConditionModel(**configs.SD15_UNET, device="cuda", dtype=dtype)
    vae = AutoencoderKL(**configs.SD_VAE, device="cuda", dtype=dtype)
    text_encoder = CLIPTextModel(**configs.CLIP_VIT_L, device="cuda", dtype=dtype)
    for model in (unet, vae, text_encoder):
        random_init_(model, gen)
    # SD1.5's own scheduler settings (epsilon, steps_offset 1)
    scheduler = DDIMScheduler(
        beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
        set_alpha_to_one=False, steps_offset=1, prediction_type="epsilon",
        device="cuda",
    )
    pipe = StableDiffusionPipeline(text_encoder, vae, unet, scheduler)
    ids_gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    vocab = configs.CLIP_VIT_L["vocab_size"]
    prompt_ids = torch.randint(0, vocab, (1, 77), generator=ids_gen, device="cuda")
    neg_ids = torch.randint(0, vocab, (1, 77), generator=ids_gen, device="cuda")
    kw = dict(
        num_inference_steps=steps, height=512, width=512, guidance_scale=7.5,
        neg_prompt_ids=neg_ids,
    )
    with torch.no_grad():
        pipe(prompt_ids, generator=torch.Generator("cuda").manual_seed(seed), **kw)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        images = pipe(prompt_ids, generator=torch.Generator("cuda").manual_seed(seed), **kw)["images"]
        torch.cuda.synchronize()
        launches = fa.flash_attention_fwd.launches
        by_shape = dict(fa.flash_attention_fwd.launches_by_shape)
        peak = torch.cuda.max_memory_allocated()
        # host clock, repeated: the loop is eager and its host time varies
        runs = {"total": [], "encode": [], "denoise_per_step": [], "decode": []}
        noise = torch.randn(1, 4, 64, 64, generator=gen, device="cuda")
        for _ in range(repeats):
            ms, _ = host_ms(
                lambda: pipe(prompt_ids, generator=torch.Generator("cuda").manual_seed(seed), **kw)
            )
            runs["total"].append(ms)
            ms, context = host_ms(lambda: pipe.encode_prompt(prompt_ids, neg_ids))
            runs["encode"].append(ms)
            ms, latents = host_ms(lambda: pipe.denoise(noise, context, steps, 7.5))
            runs["denoise_per_step"].append(ms / steps)
            ms, _ = host_ms(lambda: pipe.decode_latents(latents))
            runs["decode"].append(ms)
    median = {name: statistics.median(v) for name, v in runs.items()}
    shape_ok = tuple(images.shape) == (1, 512, 512, 3)
    finite = bool(torch.isfinite(images).all())
    in_range = finite and float(images.min()) >= 0.0 and float(images.max()) <= 1.0
    expected = 5 * steps + 1
    emit(
        "slice", steps=steps, image_shape=list(images.shape), finite=finite,
        in_range=in_range, image_mean=float(images.float().mean()),
        image_std=float(images.float().std()), flash_launches=launches,
        expected_launches=expected,
        launches_by_shape={"x".join(map(str, k)): n for k, n in by_shape.items()},
        total_ms=median["total"], images_per_s=1e3 / median["total"],
        encode_ms=median["encode"], denoise_ms_per_step=median["denoise_per_step"],
        decode_ms=median["decode"], runs_ms=runs, max_memory_allocated=peak,
    )
    state["slice_by_shape"] = by_shape
    if not (shape_ok and in_range and launches == expected):
        raise AssertionError("text-to-image slice failed its checks")
    with torch.no_grad():
        profile_denoise_step(pipe, latents, context)


def profile_denoise_step(pipe, latents, context, top=15):
    """Where one denoise step's device time goes: torch.profiler's kernel
    table for one CFG step, and the device's busy share of the step's wall
    time (one stream, so the kernels' sum is the busy time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = host_ms(lambda: pipe.denoise(latents, context, 1, 7.5))
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    emit(
        "profile", what="one CFG denoise step (UNet batch 2 + DDIM step)",
        wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
        flash_ms=sum(ms for ms, _, name in kernels if "flash_fwd" in name),
        n_kernel_names=len(kernels), n_launches=sum(n for _, n, _ in kernels),
        top=[dict(ms=ms, count=n, name=name[:120]) for ms, n, name in kernels[:top]],
    )


def kernels_line(state):
    """The per-kernel record: each main-path shape of the kernel, its launches
    in the slice run and its numbers from the kernels phase."""
    by_shape = state.get("slice_by_shape", {})
    entries = []
    for row in state.get("kernel_cases", []):
        if row["dtype"] != "bfloat16" or row["case"] not in ("unet_l0", "vae_mid"):
            continue  # the slice runs the kernel in bf16 at these two shapes
        bh, sq, d = row["shape_q"]
        sk = row["shape_k"][1]
        entries.append(dict(
            name=f"flash_attention_fwd[{row['case']} {bh}x{sq}x{sk}x{d} bf16]",
            route="cuda", source=KERNEL_SOURCE, replaces=KERNEL_REPLACES,
            launches=by_shape.get((bh, sq, sk, d, "bfloat16"), 0),
            max_abs_err=row["max_abs_err_o"], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
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

    print(json.dumps(kernels_line(state)))
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
