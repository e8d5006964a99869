#!/usr/bin/env python3
"""Time the fused flash-attention backward with parts of its work taken out.

    python3 probe_flash_bwd.py                    # (64, 4096, 40) bf16, one card
    python3 probe_flash_bwd.py --shape 3,4000,3900,40

Each variant is ``csrc/flash_attention_bwd.cu`` with one or more statements
of ``flash_bwd_fused_kernel`` replaced (the edits below; each must match the
source exactly once, so a changed kernel stops the probe instead of timing
something else). All variants are built at once, one ``nvcc`` each, into
``stable_diffusion_training_tpu_torch/_build/probe/``, and their
``flash_attention_bwd_fused`` entry is called as the port's wrapper calls it:
the f32 dQ buffer zeroed, the fused kernel, the dQ conversion. Per variant
it prints one JSON line: device ms per call (CUDA events around calls queued
behind a spin kernel, as ``chip_smoke.py`` times them), the relative
Frobenius error of dQ, dK and dV against ``flash_attention_bwd_reference``
(what the edit breaks), the fused kernel's registers and any ptxas note that
it serialised the wgmmas (C7514; a serialised variant's time says nothing
about the part it removed). The time a variant saves against ``base`` is
what that part adds to the kernel's critical path, with the others left in.
Lines also go to ``chiprun_out/probe_flash_bwd.jsonl``; the last line
carries the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import chip_smoke

# what each variant removes: (statement in the source, what replaces it)
EXP = (
    "s[4 * i + e] = fast_exp2(fmaf(s[4 * i + e], c, -((e & 1) ? l.y : l.x)));",
    "s[4 * i + e] = fmaf(s[4 * i + e], c, -((e & 1) ? l.y : l.x));",
)
DV = ("Wgmma<DP>::rs(dv_acc, pa[kk], wgmma_desc_advance(do_mn, stage + kk * 16 * 128), 1);", "(void)kk;")
DK = ("Wgmma<DP>::rs(dk_acc, da[kk], wgmma_desc_advance(q_mn, stage + kk * 16 * 128), 1);", "(void)kk;")
DQ = (
    "Wgmma<DP>::template ss<1, 1>(dq, wgmma_desc_advance(ds_mn, buf + kk * 16 * 128),\n"
    "                                     wgmma_desc_advance(k_mn, kk * 16 * 128), kk > 0);",
    "(void)kk;",
)
REDUCE = (
    "if (rows > 0) bulk_reduce_add_f32(dq_acc + (size_t(bh) * sq + q0) * d, stg, uint32_t(rows) * d * 4);",
    "(void)rows;",
)
BARRIER = ("named_barrier_sync(1, 128 * C::kConsumers);", "")
VARIANTS = {
    "base": [],
    "no_exp": [EXP],  # P^T is its exponent: the SFU work goes, the FMA stays
    "no_dkv": [DV, DK],  # the dV and dK products
    "no_dq": [DQ, REDUCE],  # the dQ product and its reduce-add
    "no_reduce": [REDUCE],  # the reduce-add of dQ into L2
    "no_barrier": [BARRIER],  # the barrier of both consumers before dQ
    "products_only": [EXP, REDUCE, BARRIER],
}
FUSED = "flash_bwd_fused_kernel"


def variant_source(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"the edit's statement occurs {src.count(old)} times in the source: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(d):
    """Every variant's library path and its fused kernel's ptxas facts at
    head dim ``d`` (registers, spill bytes, C7514 notes)."""
    from stable_diffusion_training_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, "flash_attention_bwd.cu")) as f:
        src = f.read()
    running = {}
    for name, edits in VARIANTS.items():
        out_dir = os.path.join(cuda_build.BUILD_DIR, "probe", name)
        os.makedirs(out_dir, exist_ok=True)
        cu, lib = os.path.join(out_dir, "flash_attention_bwd.cu"), os.path.join(out_dir, "libprobe.so")
        with open(cu, "w") as f:
            f.write(variant_source(src, edits))
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR, "-o", lib, cu]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    dp = next(p for p in (16, 32, 40, 48, 64) if d <= p)
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building variant {name}:\n{log}")
        facts = {}
        for fn, props in chip_smoke.ptxas_functions(log).items():
            if FUSED in fn and f"ILi{dp}E" in fn:
                facts = props
        facts["serialised"] = [ln.strip() for ln in log.splitlines() if "C7514" in ln or "serializ" in ln]
        built[name] = (lib, facts)
    return built


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", default="64,4096,4096,40", help="B*H,Sq,Sk,D")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_bwd.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from stable_diffusion_training_tpu_torch.ops import flash_attention as fa

    bh, sq, sk, d = map(int, args.shape.split(","))
    gen = torch.Generator(device="cuda").manual_seed(4321)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(torch.bfloat16) for s in (sq, sk, sk))
    do = torch.randn(bh, sq, d, generator=gen, device="cuda").to(torch.bfloat16)
    scale = d**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    delta = (do.float() * o.float()).sum(-1)
    if not fa.takes_fused_backward(q, k, v, do):
        raise ValueError(f"shape {args.shape} does not take the fused kernel")
    expected = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    dq_acc = torch.zeros(bh, sq, d, dtype=torch.float32, device="cuda")
    grads = [torch.empty_like(t) for t in (q, k, v)]
    stream = torch.cuda.current_stream().cuda_stream
    record = os.path.join(chip_smoke.REPO, "chiprun_out", "probe_flash_bwd.jsonl")
    os.makedirs(os.path.dirname(record), exist_ok=True)
    rows = []
    for name, (lib, facts) in build_variants(d).items():
        entry = ctypes.CDLL(lib).flash_attention_bwd_fused
        entry.argtypes, entry.restype = fa._FUNCTIONS["flash_attention_bwd_fused"][1], ctypes.c_int

        def call():
            dq_acc.zero_()
            rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       dq_acc.data_ptr(), *(g.data_ptr() for g in grads), bh, sq, sk, d, scale, stream)
            if rc != 0:
                raise RuntimeError(f"variant {name}: cudaError {rc}")

        call()
        torch.cuda.synchronize()
        fro = [((g.float() - w.float()).norm() / w.float().norm()).item() for g, w in zip(grads, expected)]
        row = dict(variant=name, edits=len(VARIANTS[name]), shape=[bh, sq, sk, d],
                   ms=chip_smoke.cuda_ms(call, args.reps), rel_fro_err=dict(zip(("dq", "dk", "dv"), fro)), **facts)
        rows.append(row)
        print(json.dumps(row), flush=True)
    base = rows[0]["ms"]
    summary = dict(saved_ms={r["variant"]: base - r["ms"] for r in rows[1:]}, nvidia_smi=chip_smoke.nvidia_smi_line())
    with open(record, "a") as f:
        for row in rows + [summary]:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(summary))
    ok = max(rows[0]["rel_fro_err"].values()) <= chip_smoke.BWD_FRO_TOLERANCE["bfloat16"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
