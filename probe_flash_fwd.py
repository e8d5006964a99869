#!/usr/bin/env python3
"""Time the forward's routes for 64 < D <= 128 built several ways: bf16
``tma_mid`` with two, three and four consumer warpgroups a block, or f32
``f32_mid`` with 6, 7 and 8 query rows a thread at D = 80.

    python3 probe_flash_fwd.py                    # tma_mid at (64, 2704, 80) and (64, 4624, 80), one card
    python3 probe_flash_fwd.py --shapes 3,1000,1100,96
    python3 probe_flash_fwd.py --route f32_mid    # the f32 kernel's variants at the same shapes

Each variant is ``csrc/flash_attention_fwd.cu`` with the mid tile's count of
consumer warpgroups (``TmaTile::kConsumers``) edited (the edit must match the
source exactly once, so a changed kernel stops the probe instead of timing
something else): 2 (128 query rows a block, 232 registers a consumer
thread), 3 (the source's: 192 rows, 160 registers) or 4 (256 rows, 112
registers). Route ``f32_mid``: ``csrc/flash_attention_fwd.cu`` with the mid
f32 tile's rows a thread at DP = 80 (``F32MidTile::RT``) edited: 6 (the
source's: 192 query rows a block, 183,296 bytes of shared memory), 7 (224)
or 8 (256, 223,232 bytes). All variants are built at once, one ``nvcc``
each, into
``stable_diffusion_training_tpu_torch/_build/probe_fwd/``, and their
``flash_attention_fwd`` entry is called as the port's wrapper calls it. Per
variant and shape it prints one JSON line: device ms per call (CUDA events
around calls queued behind a spin kernel, as ``chip_smoke.py`` times them),
the max error of O and lse against ``flash_attention_fwd_reference``, and
the mid kernel's registers, spill bytes and any ptxas note that it
serialised the wgmmas (C7514). The wide kernel that the mid route replaced
(``flash_attention_fwd_tma_wide`` or ``flash_attention_fwd_f32_wide``, from
the source as it stands) and SDPA are timed on
the same inputs. Lines also go to ``chiprun_out/probe_flash_fwd.jsonl``;
the last line carries the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import chip_smoke

CONSUMERS = "static constexpr int kConsumers = kWide ? 2 : kMid ? 3 : 4;"
VARIANTS = {
    "consumers_3": [],
    "consumers_2": [(CONSUMERS, "static constexpr int kConsumers = kWide ? 2 : kMid ? 2 : 4;")],
    "consumers_4": [(CONSUMERS, "static constexpr int kConsumers = kWide ? 2 : kMid ? 4 : 4;")],
}
KERNEL = "flash_fwd_tma_kernel"
F32_ROWS = "static constexpr int RT = DP <= 80 ? 6 : DP <= 96 ? 7 : DP <= 112 ? 6 : 5;"
F32_VARIANTS = {
    "rows_6": [],
    "rows_7": [(F32_ROWS, "static constexpr int RT = DP <= 80 ? 7 : DP <= 96 ? 7 : DP <= 112 ? 6 : 5;")],
    "rows_8": [(F32_ROWS, "static constexpr int RT = DP <= 80 ? 8 : DP <= 96 ? 7 : DP <= 112 ? 6 : 5;")],
}
F32_KERNEL = "flash_fwd_f32_mid_kernel"
# route: (variants, kernel, its mangled template arguments at DP, dtype, dtype code, wide wrapper)
ROUTES = {
    "tma_mid": (VARIANTS, KERNEL, "ILi{}ELb0E", "bfloat16", 1, "flash_attention_fwd_tma_wide"),
    "f32_mid": (F32_VARIANTS, F32_KERNEL, "ILi{}EE", "float32", 0, "flash_attention_fwd_f32_wide"),
}


def variant_source(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"the edit's statement occurs {src.count(old)} times in the source: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(dps, route="tma_mid"):
    """Every variant of ``route`` (its library path) and, per DP in
    ``dps``, its mid kernel's ptxas facts (registers, spill bytes, C7514
    notes)."""
    from stable_diffusion_training_tpu_torch.ops import cuda_build

    variants, kernel, mangled = ROUTES[route][:3]
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_attention_fwd.cu")) as f:
        src = f.read()
    running = {}
    for name, edits in variants.items():
        out_dir = os.path.join(cuda_build.BUILD_DIR, "probe_fwd", name)
        os.makedirs(out_dir, exist_ok=True)
        cu, lib = os.path.join(out_dir, "flash_attention_fwd.cu"), os.path.join(out_dir, "libprobe.so")
        with open(cu, "w") as f:
            f.write(variant_source(src, edits))
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR, "-o", lib, cu]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building variant {name}:\n{log}")
        facts = {}
        for fn, props in chip_smoke.ptxas_functions(log).items():
            for dp in dps:  # flash_fwd_tma_kernel<DP, false> or flash_fwd_f32_mid_kernel<DP>
                if kernel in fn and mangled.format(dp) in fn:
                    facts[dp] = props
        facts["serialised"] = [ln.strip() for ln in log.splitlines() if "C7514" in ln or "serializ" in ln]
        built[name] = (lib, facts)
    return built


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", default="64,2704,2704,80;64,4624,4624,80", help="B*H,Sq,Sk,D;...")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--route", choices=sorted(ROUTES), default="tma_mid")
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_flash_fwd.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa
    from stable_diffusion_training_tpu_torch.utils import roofline

    shapes = [tuple(map(int, s.split(","))) for s in args.shapes.split(";")]
    dps = sorted({-(-d // 16) * 16 for *_, d in shapes})
    built = build_variants(dps, args.route)
    *_, dtype_name, dtype_code, wide_name = ROUTES[args.route]
    wide = getattr(fa, wide_name)
    record = os.path.join(chip_smoke.REPO, "chiprun_out", "probe_flash_fwd.jsonl")
    os.makedirs(os.path.dirname(record), exist_ok=True)
    chip_smoke.set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    tol = chip_smoke.TOLERANCE[dtype_name]
    rows, ok = [], True
    for bh, sq, sk, d in shapes:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(getattr(torch, dtype_name))
                   for s in (sq, sk, sk))
        if fa.forward_route(q, k, v) != args.route:
            raise ValueError(f"shape {(bh, sq, sk, d)} does not take route {args.route}")
        scale = d**-0.5
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale)
        wide_ms = chip_smoke.cuda_ms(lambda: wide(q, k, v, scale), args.reps)
        sdpa_ms = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale),
                                     args.reps)
        bound_ms, bound_by, _ = roofline.attention_bound(bh, sq, sk, d, dtype_name, reads_q=1, writes_q=1)
        o = torch.empty_like(q)
        lse = torch.empty(bh, sq, dtype=torch.float32, device="cuda")
        route = ctypes.c_int(-1)
        stream = torch.cuda.current_stream().cuda_stream
        for name, (lib, facts) in built.items():
            entry = ctypes.CDLL(lib).flash_attention_fwd
            entry.argtypes, entry.restype = fa._FUNCTIONS["flash_attention_fwd"][1], ctypes.c_int

            def call():
                rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
                           scale, dtype_code, ctypes.byref(route), stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            first = (o.clone(), lse.clone())
            call()
            torch.cuda.synchronize()
            repeats = bool(torch.equal(first[0], o) and torch.equal(first[1], lse))
            ok = ok and err_o <= tol["o"] and err_lse <= tol["lse"] and fa.FWD_ROUTES[route.value] == args.route
            ok = ok and (repeats or dtype_name != "float32")  # the f32 kernels sum in fixed orders
            row = dict(variant=name, route=args.route, shape=[bh, sq, sk, d], ms=chip_smoke.cuda_ms(call, args.reps),
                       wide_ms=wide_ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
                       max_abs_err_o=err_o, max_abs_err_lse=err_lse, repeats_bitwise=repeats,
                       ptxas=facts.get(-(-d // 16) * 16, {}), serialised=facts["serialised"])
            rows.append(row)
            print(json.dumps(row), flush=True)
        del q, k, v, o_ref, lse_ref
        torch.cuda.empty_cache()
    summary = dict(ms={f"{r['variant']} {'x'.join(map(str, r['shape']))}": r["ms"] for r in rows},
                   nvidia_smi=chip_smoke.nvidia_smi_line())
    with open(record, "a") as f:
        for row in rows + [summary]:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
