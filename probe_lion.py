#!/usr/bin/env python3
"""Time the 8-bit Lion kernels with parts of their work taken out.

    python3 probe_lion.py          # SD1.5's quantized leaves, bf16 grads, bs 16, one card

Each variant is ``csrc/lion8bit_update.cu`` with statements replaced (the
edits below; each must match the source exactly once, so a changed kernel
stops the probe instead of timing something else). All variants are built at
once, one ``nvcc`` each, into ``stable_diffusion_training_tpu_torch/_build/
probe_lion/``, and driven through the port's own wrappers with the library
swapped, over the whole UNet's and CLIP's quantized leaves at their real
shapes (``chip_smoke.sd15_quantized_leaves``), exact compander:

- the earlier kernel (``lion_part``) over grads already in JAX order, one
  ``lion8bit_update`` launch per leaf: ``old_*`` variants, timed on the
  ``old`` entry;
- the leaf-table kernel (``lion_leaves_kernel``) over grads in torch layout,
  one launch per model: ``new_*`` variants, timed on the ``new`` entry.

``chip_smoke.py``'s kernels phase runs the same measurement
(``measure``). Per variant and model it prints one JSON line: device ms per call (CUDA
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

# the earlier kernel: powf, and its three divides, each replaced by its
# fast approximation (__powf, __fdividef, a product) so that the timed
# updates, fed back, stay in range
OLD_POWF = ("const float p = powf(fabsf(shifted), 0.2f);", "const float p = __powf(fabsf(shifted), 0.2f);")
OLD_DIVS = [
    ("const float x = __fdiv_rn(q, 127.0f);", "const float x = __fmul_rn(q, 0.007874016f);"),
    ("m = __fdiv_rn(__fsub_rn(x5, kOffset), s);", "m = __fdividef(__fsub_rn(x5, kOffset), s);"),
    ("const float s_new = __fdiv_rn(1.0f, amax <= 0.f ? 1.0f : amax);",
     "const float s_new = __fdividef(1.0f, amax <= 0.f ? 1.0f : amax);"),
]
# the leaf-table kernel: powf on every element instead of the approximation
# (its requantization), the approximation alone (no powf near a
# half-integer), its two divides as __fdividef, contiguous reads (every
# leaf walked as if its layouts agreed: the same tiles and bytes, no
# transposition; exact only where tiles fill the leaf), and no math (the
# loads and the signs' stores alone)
NEW_REQUANT = (
    "const float y = ex2_approx(__fmaf_rn(lg2_approx(a), 0.2f, kLog2Of127));\n"
    "  float code = rintf(y);\n"
    "  if (fabsf(__fsub_rn(y, code)) > 0.5f - kRoundMargin) code = rintf(__fmul_rn(powf(a, 0.2f), 127.0f));",
)
NEW_NO_POWF = (NEW_REQUANT[0], "float code = rintf(__fmul_rn(__powf(a, 0.2f), 127.0f));")
NEW_POWF_ALWAYS = (NEW_REQUANT[0], "float code = rintf(__fmul_rn(powf(a, 0.2f), 127.0f));")
NEW_DIVS = [
    ("const float m = FAST ? __fmul_rn(entry, inv) : __fdiv_rn(entry, s);",
     "const float m = FAST ? __fmul_rn(entry, inv) : __fdividef(entry, s);"),
    ("const float new_scale = __fdiv_rn(1.0f, amax <= 0.f ? 1.0f : amax);",
     "const float new_scale = __fdividef(1.0f, amax <= 0.f ? 1.0f : amax);"),
]
NEW_CONTIGUOUS = [
    ("v.transposed = lf.kind == 0;", "v.transposed = false;"),
    ("v.valid = v.blk < lf.rows;", "v.valid = true;"),
    ("v.cols_valid = int(min64(L::kThreads, lf.rows - blk0)) * BS;", "v.cols_valid = L::kThreads * BS;"),
]
NEW_NO_MATH = ("if (v.valid) update_block", "if (v.valid && v.blk < 0) update_block")
VARIANTS = {
    "old_base": ("old", []),
    "old_no_powf": ("old", [OLD_POWF]),
    "old_no_divides": ("old", OLD_DIVS),
    "old_no_powf_no_divides": ("old", [OLD_POWF, *OLD_DIVS]),
    "new_base": ("new", []),
    "new_powf_always": ("new", [NEW_POWF_ALWAYS]),
    "new_no_powf": ("new", [NEW_NO_POWF]),  # the approximation alone, no powf near half-integers
    "new_no_divides": ("new", NEW_DIVS),
    "new_contiguous_reads": ("new", NEW_CONTIGUOUS),
    "new_no_math": ("new", [NEW_NO_MATH]),  # grads, codes and scales in, the staged grads out
}


def variant_source(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"the edit's statement occurs {src.count(old)} times in the source: {old!r}")
        src = src.replace(old, new)
    return src


def start_builds():
    """One ``nvcc`` per variant, all started at once; ``finish_builds``
    waits for them."""
    from stable_diffusion_training_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, "lion8bit_update.cu")) as f:
        src = f.read()
    running = {}
    for name, (_, edits) in VARIANTS.items():
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
            if "13__nv_bfloat16Li16ELb0E" in fn and ("lion_single_kernel" in fn or "lion_leaves_kernel" in fn):
                facts["lion_single_kernel" if "single" in fn else "lion_leaves_kernel"] = props
        built[name] = (lib, facts)
    return built


def build_variants():
    return finish_builds(start_builds())


def measure(reps=10, report=None, built=None):
    """Build every variant (unless ``built`` holds them) and time it over
    both models' leaves; each row goes to ``report`` as it is measured.
    Returns ``(rows, summary)``; a row is ``ok`` unless it is a base variant
    whose signs differ from the plain version's."""
    import torch

    from stable_diffusion_training_tpu_torch.ops import lion_kernel as lk

    built = build_variants() if built is None else built
    load_library = lk.load_library
    rows = []
    try:
        for model_name, leaves in chip_smoke.sd15_quantized_leaves().items():
            grads, codes, scales = chip_smoke.lion_model_inputs(leaves, torch.bfloat16, chip_smoke.LION_BS, seed=5)
            perms = [perm for _, _, perm in leaves]
            shapes = [shape for _, shape, _ in leaves]
            expected, _, _ = lk.lion8bit_update_leaves_reference(grads, codes, scales, perms)
            jax_grads = chip_smoke.permute_grads(leaves, grads)
            n = sum(g.numel() for g in grads)
            for name, (lib, facts) in built.items():
                entry = VARIANTS[name][0]
                cdll = ctypes.CDLL(lib)
                lk.load_library = lambda *_: cdll  # the wrappers' calls go to this variant
                work_c, work_s = [c.clone() for c in codes], [s.clone() for s in scales]
                if entry == "new":
                    table = lk.LeafTable(work_c, work_s, shapes, perms)
                    call = lambda: lk.lion8bit_update_leaves_(grads, table)
                    upds = call()
                else:
                    call = lambda: [lk.lion8bit_update_(g, c, s) for g, c, s in zip(jax_grads, work_c, work_s)]
                    upds = [u.permute(*lk.inverse_permutation(p)) if p else u for u, p in zip(call(), perms)]
                torch.cuda.synchronize()
                equal = sum(int((u == e).sum()) for u, e in zip(upds, expected)) / n
                del upds
                row = dict(variant=name, model=model_name, entry=entry, edits=len(VARIANTS[name][1]),
                           leaves=len(leaves), elements=n, ms=chip_smoke.cuda_ms(call, reps),
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
                  for r in rows if not r["variant"].endswith("_base")},
        nvidia_smi=chip_smoke.nvidia_smi_line(),
    )
    return rows, summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_lion.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    record = os.path.join(chip_smoke.REPO, "chiprun_out", "probe_lion.jsonl")
    os.makedirs(os.path.dirname(record), exist_ok=True)
    rows, summary = measure(args.reps, report=lambda row: print(json.dumps(row), flush=True))
    with open(record, "a") as f:
        for row in rows + [summary]:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(summary))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
