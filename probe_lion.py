#!/usr/bin/env python3
"""Time the 8-bit Lion kernels with parts of their work taken out.

    python3 probe_lion.py              # SD1.5's quantized leaves, bf16 grads, bs 16, one card
    python3 probe_lion.py --shapes k6  # the largest UNet leaf alone: bs 16 and 128 bf16, bs 16 f32

Each variant is ``csrc/lion8bit_update.cu`` with statements replaced (the
edits below; each must match the source exactly once, so a changed kernel
stops the probe instead of timing something else). All variants are built at
once, one ``nvcc`` each, into ``stable_diffusion_training_tpu_torch/_build/
probe_lion/``, and driven through the port's own wrappers with the library
swapped, exact compander, over the whole UNet's and CLIP's quantized leaves
at their real shapes (``chip_smoke.sd15_quantized_leaves``) or, with
``--shapes k6``, over the largest UNet leaf alone (29,491,200 elements, the
K6 rows of ``chip_smoke.py``'s kernels phase; the leaf table takes it as a
one-leaf table of the same bytes):

- the stream kernel (``lion_stream_kernel``) over grads already in JAX
  order, one ``lion8bit_update`` launch per leaf: ``old_*`` variants, timed
  on the ``old`` entry (its arithmetic, its tile, stages and CTAs an SM);
- the leaf-table kernel (``lion_leaves_kernel``) over grads in torch layout,
  one launch per model: ``new_*`` variants, timed on the ``new`` entry.

Per variant and case it prints one JSON line: device ms per call (CUDA
events around calls queued behind a spin kernel, as ``chip_smoke.py`` times
them), the share of the update signs that still equal the plain version's
(what the edit breaks), and the kernels' registers. The time a variant saves
against its base is what the removed part adds to the kernel's time with the
rest left in. Lines also go to ``chiprun_out/probe_lion.jsonl``; the last
line carries the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import chip_smoke

# Both kernels share their arithmetic (csrc/lion8bit_update.cu's device
# functions), so an edit of it reaches both; each variant is timed on one
# entry. The requantization: powf on every element instead of the
# approximation, or the approximation alone (no powf near a half-integer);
# the two divides (by the block's scale, and the new scale) as __fdividef.
REQUANT = (
    "const float y = ex2_approx(__fmaf_rn(lg2_approx(a), 0.2f, kLog2Of127));\n"
    "  float code = rintf(y);\n"
    "  if (fabsf(__fsub_rn(y, code)) > 0.5f - kRoundMargin) code = rintf(__fmul_rn(powf(a, 0.2f), 127.0f));",
)
NO_POWF = (REQUANT[0], "float code = rintf(__fmul_rn(__powf(a, 0.2f), 127.0f));")
POWF_ALWAYS = (REQUANT[0], "float code = rintf(__fmul_rn(powf(a, 0.2f), 127.0f));")
DIVS = [
    ("const float m = FAST ? __fmul_rn(entry, inv) : __fdiv_rn(entry, s);",
     "const float m = FAST ? __fmul_rn(entry, inv) : __fdividef(entry, s);"),
    ("return __fdiv_rn(1.0f, amax <= 0.f ? 1.0f : amax);", "return __fdividef(1.0f, amax <= 0.f ? 1.0f : amax);"),
]
# the stream kernel (the ``old`` entry: ``lion8bit_update``, one launch per
# leaf, grads in JAX order): no math (the tiles streamed in and out, the
# grads going back as signs), and its tile, stages and CTAs an SM
STREAM_NO_MATH = ("    update_tile<T, BS, FAST>(stage, deq, d.blocks, k);",
                  "    if (d.blocks < 0) update_tile<T, BS, FAST>(stage, deq, d.blocks, k);")
STAGE_BYTES, STAGES = "constexpr int kStageBytes = 16384;", "constexpr int kStages = 4;"
CTAS_BF16, CTAS_F32 = "constexpr int kCtasPerSmBf16 = 4;", "constexpr int kCtasPerSmF32 = 2;"
# the leaf-table kernel (the ``new`` entry: ``lion8bit_update_leaves``, one
# launch per model, grads in torch layout): contiguous reads (every leaf
# walked as if its layouts agreed: the same tiles and bytes, no
# transposition; exact only where tiles fill the leaf), and no math (the
# loads and the signs' stores alone)
NEW_CONTIGUOUS = [
    ("v.transposed = lf.kind == 0;", "v.transposed = false;"),
    ("v.valid = v.blk < lf.rows;", "v.valid = true;"),
    ("v.cols_valid = int(min64(L::kThreads, lf.rows - blk0)) * BS;", "v.cols_valid = L::kThreads * BS;"),
]
NEW_NO_MATH = ("if (v.valid) update_block", "if (v.valid && v.blk < 0) update_block")
VARIANTS = {
    "old_base": ("old", []),
    "old_no_powf": ("old", [NO_POWF]),
    "old_no_divides": ("old", DIVS),
    "old_no_powf_no_divides": ("old", [NO_POWF, *DIVS]),
    "old_no_math": ("old", [STREAM_NO_MATH]),
    "old_stage_8k": ("old", [(STAGE_BYTES, "constexpr int kStageBytes = 8192;")]),
    "old_stage_32k": ("old", [(STAGE_BYTES, "constexpr int kStageBytes = 32768;")]),
    "old_stages_3": ("old", [(STAGES, "constexpr int kStages = 3;")]),
    "old_stages_6": ("old", [(STAGES, "constexpr int kStages = 6;")]),
    "old_bf16_ctas_2": ("old", [(CTAS_BF16, "constexpr int kCtasPerSmBf16 = 2;")]),
    "old_bf16_ctas_3": ("old", [(CTAS_BF16, "constexpr int kCtasPerSmBf16 = 3;")]),
    "old_bf16_ctas_5_stage_8k": ("old", [(CTAS_BF16, "constexpr int kCtasPerSmBf16 = 5;"),
                                         (STAGE_BYTES, "constexpr int kStageBytes = 8192;")]),
    "old_bf16_ctas_6_stage_8k": ("old", [(CTAS_BF16, "constexpr int kCtasPerSmBf16 = 6;"),
                                         (STAGE_BYTES, "constexpr int kStageBytes = 8192;")]),
    "old_bf16_ctas_6_stages_3_stage_8k": ("old", [(CTAS_BF16, "constexpr int kCtasPerSmBf16 = 6;"),
                                                  (STAGES, "constexpr int kStages = 3;"),
                                                  (STAGE_BYTES, "constexpr int kStageBytes = 8192;")]),
    "old_f32_ctas_1": ("old", [(CTAS_F32, "constexpr int kCtasPerSmF32 = 1;")]),
    "old_f32_ctas_4": ("old", [(CTAS_F32, "constexpr int kCtasPerSmF32 = 4;")]),
    "new_base": ("new", []),
    "new_powf_always": ("new", [POWF_ALWAYS]),
    "new_no_powf": ("new", [NO_POWF]),  # the approximation alone, no powf near half-integers
    "new_no_divides": ("new", DIVS),
    "new_contiguous_reads": ("new", NEW_CONTIGUOUS),
    "new_no_math": ("new", [NEW_NO_MATH]),  # grads, codes and scales in, the staged grads out
}


def variant_source(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"the edit's statement occurs {src.count(old)} times in the source: {old!r}")
        src = src.replace(old, new)
    return src


def start_builds(names=None):
    """One ``nvcc`` per variant (``names``, or all), all started at once;
    ``finish_builds`` waits for them."""
    from stable_diffusion_training_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, "lion8bit_update.cu")) as f:
        src = f.read()
    running = {}
    for name, (_, edits) in VARIANTS.items():
        if names is not None and name not in names:
            continue
        out_dir = os.path.join(cuda_build.BUILD_DIR, "probe_lion", name)
        os.makedirs(out_dir, exist_ok=True)
        cu, lib = os.path.join(out_dir, "lion8bit_update.cu"), os.path.join(out_dir, "libprobe.so")
        with open(cu, "w") as f:
            f.write(variant_source(src, edits))
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR, "-o", lib, cu]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return running


def finish_builds(running):
    """Every variant's library path and the ptxas facts (registers, spill
    bytes) of its bf16 bs-16 exact kernels, once its build has ended."""
    built = {}
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building variant {name}:\n{log}")
        facts = {}
        for fn, props in chip_smoke.ptxas_functions(log).items():
            # bf16, bs 16, exact: the train step's instance
            for kernel in ("lion_stream_kernel", "lion_leaves_kernel"):
                if "13__nv_bfloat16Li16ELb0E" in fn and kernel in fn:
                    facts[kernel] = props
        built[name] = (lib, facts)
    return built


def build_variants(names=None):
    return finish_builds(start_builds(names))


def sd15_cases():
    """Each SD1.5 model's quantized leaves at their real shapes, bf16 grads,
    bs 16: ``(name, shapes, perms, grads (torch layout), grads in JAX order,
    codes, scales, expected update signs (torch layout))``."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk

    for model_name, leaves in chip_smoke.sd15_quantized_leaves().items():
        grads, codes, scales = chip_smoke.lion_model_inputs(leaves, torch.bfloat16, chip_smoke.LION_BS, seed=5)
        perms = [perm for _, _, perm in leaves]
        expected, _, _ = lk.lion8bit_update_leaves_reference(grads, codes, scales, perms)
        yield (model_name, [shape for _, shape, _ in leaves], perms, grads, chip_smoke.permute_grads(leaves, grads),
               codes, scales, expected)


# the K6 shapes: the largest SD1.5 UNet leaf (29,491,200 elements) as one
# leaf at these block sizes and grad dtypes
K6_CASES = ((16, "bfloat16"), (128, "bfloat16"), (16, "float32"))


def k6_cases():
    """The largest SD1.5 UNet leaf alone, as ``fused_lion8bit_update``
    (K6) takes it, in the same tuple as ``sd15_cases``; the leaf-table
    kernel takes it as a one-leaf table of the same bytes."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk

    n = max(chip_smoke.sd15_lion_leaves()["unet"]["single_sizes"])
    gen = torch.Generator(device="cuda").manual_seed(77)
    for bs, dtype_name in K6_CASES:
        grad = (torch.randn(n, generator=gen, device="cuda") * 1e-3).to(getattr(torch, dtype_name))
        codes, scales = lk.block_quantize(torch.randn(n, generator=gen, device="cuda") * 1e-4, bs)
        expected = lk.lion8bit_update_reference(grad, codes, scales)[0]
        yield f"k6_bs{bs}_{dtype_name}", [(n,)], [None], [grad], [grad], [codes], [scales], [expected]


def measure(reps=10, report=None, built=None, shapes="sd15"):
    """Build every variant (unless ``built`` holds them) and time it over
    both models' leaves (``shapes="sd15"``) or the K6 shapes (``"k6"``);
    each row goes to ``report`` as it is measured. Returns ``(rows,
    summary)``; a row is ``ok`` unless it is a base variant whose signs
    differ from the plain version's."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk

    built = build_variants() if built is None else built
    load_library = lk.load_library
    rows = []
    try:
        for model_name, shapes_, perms, grads, jax_grads, codes, scales, expected in (
                sd15_cases() if shapes == "sd15" else k6_cases()):
            n = sum(g.numel() for g in grads)
            for name, (lib, facts) in built.items():
                entry = VARIANTS[name][0]
                cdll = ctypes.CDLL(lib)
                lk.load_library = lambda *_: cdll  # the wrappers' calls go to this variant
                work_c, work_s = [c.clone() for c in codes], [s.clone() for s in scales]
                if entry == "new":
                    table = lk.LeafTable(work_c, work_s, shapes_, perms)
                    call = lambda: lk.lion8bit_update_leaves_(grads, table)
                    upds = call()
                else:
                    call = lambda: [lk.lion8bit_update_(g, c, s) for g, c, s in zip(jax_grads, work_c, work_s)]
                    upds = [u.permute(*lk.inverse_permutation(p)) if p else u for u, p in zip(call(), perms)]
                torch.cuda.synchronize()
                equal = sum(int((u == e).sum()) for u, e in zip(upds, expected)) / n
                del upds
                row = dict(variant=name, model=model_name, entry=entry, edits=len(VARIANTS[name][1]),
                           leaves=len(grads), elements=n, grad_dtype=str(grads[0].dtype).replace("torch.", ""),
                           bs=codes[0].shape[1], ms=chip_smoke.cuda_ms(call, reps),
                           update_signs_equal_share=equal, ok=bool(VARIANTS[name][1]) or equal == 1.0, **facts)
                rows.append(row)
                if report:
                    report(row)
                del work_c, work_s
            del grads, codes, scales, expected, jax_grads
            torch.cuda.empty_cache()
    finally:
        lk.load_library = load_library
    base = {(r["model"], r["entry"]): r["ms"] for r in rows if r["variant"].endswith("_base")}
    summary = dict(
        saved_ms={f"{r['model']}:{r['variant']}": base[(r["model"], r["entry"])] - r["ms"]
                  for r in rows if not r["variant"].endswith("_base") and (r["model"], r["entry"]) in base},
        nvidia_smi=chip_smoke.nvidia_smi_line(),
    )
    return rows, summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--shapes", choices=("sd15", "k6"), default="sd15",
                        help="both SD1.5 models' leaves, or the largest UNet leaf alone at the K6 cases")
    parser.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated variants to build and time")
    args = parser.parse_args(argv)
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}")
    import torch

    if not torch.cuda.is_available():
        print("probe_lion.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    record = os.path.join(chip_smoke.REPO, "chiprun_out", "probe_lion.jsonl")
    os.makedirs(os.path.dirname(record), exist_ok=True)
    rows, summary = measure(args.reps, report=lambda row: print(json.dumps(row), flush=True),
                            built=build_variants(names), shapes=args.shapes)
    with open(record, "a") as f:
        for row in rows + [summary]:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(summary))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
