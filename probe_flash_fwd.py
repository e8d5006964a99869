#!/usr/bin/env python3
"""Time the bf16 forward's route ``tma_mid`` (64 < D <= 128) with two, three
and four consumer warpgroups a block.

    python3 probe_flash_fwd.py                    # (64, 2704, 80) and (64, 4624, 80), one card
    python3 probe_flash_fwd.py --shapes 3,1000,1100,96

Each variant is ``csrc/flash_attention_fwd.cu`` with the mid tile's count of
consumer warpgroups (``TmaTile::kConsumers``) edited (the edit must match the
source exactly once, so a changed kernel stops the probe instead of timing
something else): 2 (128 query rows a block, 232 registers a consumer
thread), 3 (the source's: 192 rows, 160 registers) or 4 (256 rows, 112
registers). All variants are built at once, one ``nvcc`` each, into
``stable_diffusion_training_tpu_torch/_build/probe_fwd/``, and their
``flash_attention_fwd`` entry is called as the port's wrapper calls it. Per
variant and shape it prints one JSON line: device ms per call (CUDA events
around calls queued behind a spin kernel, as ``chip_smoke.py`` times them),
the max error of O and lse against ``flash_attention_fwd_reference``, and
the mid kernel's registers, spill bytes and any ptxas note that it
serialised the wgmmas (C7514). The wide kernel that the mid route replaced
(``flash_attention_fwd_tma_wide``, from the source as it stands) is timed on
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


def variant_source(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"the edit's statement occurs {src.count(old)} times in the source: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(dps):
    """Every variant's library path and, per DP in ``dps``, its mid
    kernel's ptxas facts (registers, spill bytes, C7514 notes)."""
    from stable_diffusion_training_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, "flash_attention_fwd.cu")) as f:
        src = f.read()
    running = {}
    for name, edits in VARIANTS.items():
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
            for dp in dps:  # flash_fwd_tma_kernel<DP, false>
                if KERNEL in fn and f"ILi{dp}ELb0E" in fn:
                    facts[dp] = props
        facts["serialised"] = [ln.strip() for ln in log.splitlines() if "C7514" in ln or "serializ" in ln]
        built[name] = (lib, facts)
    return built


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", default="64,2704,2704,80;64,4624,4624,80", help="B*H,Sq,Sk,D;...")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_fwd.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    shapes = [tuple(map(int, s.split(","))) for s in args.shapes.split(";")]
    dps = sorted({-(-d // 16) * 16 for *_, d in shapes})
    built = build_variants(dps)
    record = os.path.join(chip_smoke.REPO, "chiprun_out", "probe_flash_fwd.jsonl")
    os.makedirs(os.path.dirname(record), exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    tol = chip_smoke.TOLERANCE["bfloat16"]
    rows, ok = [], True
    for bh, sq, sk, d in shapes:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(torch.bfloat16) for s in (sq, sk, sk))
        if fa.forward_route(q, k, v) != "tma_mid":
            raise ValueError(f"shape {(bh, sq, sk, d)} does not take route tma_mid")
        scale = d**-0.5
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale)
        wide_ms = chip_smoke.cuda_ms(lambda: fa.flash_attention_fwd_tma_wide(q, k, v, scale), args.reps)
        o = torch.empty_like(q)
        lse = torch.empty(bh, sq, dtype=torch.float32, device="cuda")
        route = ctypes.c_int(-1)
        stream = torch.cuda.current_stream().cuda_stream
        for name, (lib, facts) in built.items():
            entry = ctypes.CDLL(lib).flash_attention_fwd
            entry.argtypes, entry.restype = fa._FUNCTIONS["flash_attention_fwd"][1], ctypes.c_int

            def call():
                rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, sq, sk, d,
                           scale, 1, ctypes.byref(route), stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            ok = ok and err_o <= tol["o"] and err_lse <= tol["lse"] and fa.FWD_ROUTES[route.value] == "tma_mid"
            row = dict(variant=name, shape=[bh, sq, sk, d], ms=chip_smoke.cuda_ms(call, args.reps),
                       tma_wide_ms=wide_ms, max_abs_err_o=err_o, max_abs_err_lse=err_lse,
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
