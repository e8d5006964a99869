"""One run of one benchmark cell of the port's training step.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from this file's first line to the window's first
step): the port's states through its normal entry, the seeded weights and
EMA loaded into them, the cell's inputs made on the device, and the checked
steps: the window's own call on the first distinct batches, which also
build and warm every kernel the window runs (and one step on each further
image size of a bucket mix). The window enqueues steps back
to back for ``--seconds`` and then synchronises. ``--trace 1`` then
profiles a few more steps and reads the per-layer metrics from that trace
(``portbench/metrics/<name>.py``). Last, with the program's state freed,
the plain reference (``portbench/reference``) repeats the checked steps on
the same weights and inputs, and the numbers of ``portbench/compare.py``
decide ``correct``.

The last line of standard output is the result (JSON); the last lines of
standard error give each compared number beside its limit. A run without a
CUDA card, or with fewer cards than the cell asks for, prints no result and
exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel caches stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".cache", "portbench", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".cache", "portbench", "torch_extensions"))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import compare, flops, spans  # noqa: E402
from portbench.trace.view import TraceView  # noqa: E402
from portbench.trace.work import PEAK_FLOPS  # noqa: E402
from portbench.program import Program, change_norms, clone_all  # noqa: E402
from portbench.reference.models import CLIPText, UNet, VAEEncoder, set_numerics  # noqa: E402
from portbench.reference.numerics import Numerics  # noqa: E402
from portbench.reference.train import ReferenceTrainer  # noqa: E402
from portbench.traffic import DTYPES, batch_resolution, make_inputs  # noqa: E402
from portbench.weights import module_specs, seeded_weights  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stable_diffusion_training_tpu")
MIX = 0x9E3779B97F4A7C15


class NoDevice(RuntimeError):
    pass


def derived_seed(seed: int, stream: int) -> int:
    """An independent seed for each use of ``--seed`` (weights of each
    model, inputs)."""
    return (seed * MIX + stream * 0xBF58476D1CE4E5B9) % (1 << 63)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration,
    traffic and limits, and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}

    def read(path):
        with open(os.path.join(root, path)) as f:
            return json.load(f)

    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return {
        "name": name, "chips": cell["chips"], "run_seconds": bench["run_seconds"],
        "config": read(configs[cell["config"]]["file"]),
        "traffic": read(os.path.join("portbench", "traffic", cell["traffic"] + ".json")),
        "check": read(os.path.join("portbench", "workloads", name + ".json")),
        "end_to_end": bench["end_to_end"], "per_layer": per_layer,
    }


def model_keys(config: dict, traffic: dict):
    """The modules the step runs: the UNet; the VAE encoder and the text
    tower on the image path."""
    return ("unet", "text", "vae") if traffic["inputs"] == "images" else ("unet",)


def ema_models(config: dict) -> dict:
    """``{trained model: module key}`` of the models that keep an EMA."""
    recipe = config["recipe"]
    out = {"unet": "unet"} if recipe["accumulate_unet_ema"] else {}
    if recipe["accumulate_text_encoder_ema"] and recipe["train_text_encoder"]:
        out["text_encoder"] = "text"
    return out


def reference_module(key: str, config: dict):
    return {"unet": lambda: UNet(config["unet"]), "text": lambda: CLIPText(config["text_encoder"]),
            "vae": lambda: VAEEncoder(config["vae"])}[key]()


def seeded_module_weights(config: dict, traffic: dict, seed: int, device) -> dict:
    """``{module: {name: tensor}}`` from the seed, by the reference's names."""
    dtype = DTYPES[traffic["mixed_precision"]]
    out = {}
    for i, key in enumerate(model_keys(config, traffic)):
        with torch.device("meta"):
            shapes = module_specs(reference_module(key, config))
        out[key] = seeded_weights(shapes, derived_seed(seed, 11 + i), device, dtype)
    return out


def seeded_ema_weights(config: dict, traffic: dict, seed: int, device) -> dict:
    """``{model: {name: tensor}}``: each EMA's starting weights, every leaf
    drawn from the seed apart from the parameters' (so that each moves)."""
    dtype = DTYPES[traffic["mixed_precision"]]
    out = {}
    for i, (model, key) in enumerate(ema_models(config).items()):
        with torch.device("meta"):
            shapes = module_specs(reference_module(key, config))
        out[model] = seeded_weights(shapes, derived_seed(seed, 21 + i), device, dtype, every_leaf=True)
    return out


def load_program(program: Program, config: dict, traffic: dict, seed: int, device) -> None:
    """The seeded weights and EMA into the program's states."""
    program.load_weights(seeded_module_weights(config, traffic, seed, device),
                         seeded_ema_weights(config, traffic, seed, device))


def reference_models(config: dict, traffic: dict, seed: int, device, num: Numerics) -> dict:
    models = {}
    weights = seeded_module_weights(config, traffic, seed, device)
    for key, named in weights.items():
        with torch.device("meta"):
            module = reference_module(key, config)
        module.load_state_dict(named, strict=True, assign=True)
        set_numerics(module, num)
        if key == "vae":
            module.requires_grad_(False)
        models[key] = module
    return models


def program_readings(program: Program, inputs, checked: int, fault: str = None) -> dict:
    """The checked steps through the window's own call: each step's loss,
    the first gradient's norms from the optimizer state after step 1, the
    parameters' and the EMA's change over the checked steps."""
    before = {m: clone_all(p) for m, p in program.trained().items()}
    ema_before = {m: clone_all(e) for m, e in program.ema().items()}
    losses, grad_norms = [], None
    for i in range(checked):
        batch, draws = inputs[i]
        losses.append(float(faulty_step(program, batch, draws, fault)))
        if i == 0:
            grad_norms = program.momentum_norms()
    now, ema = program.trained(), program.ema()
    change = {m: change_norms(now[m], before[m]) for m in now}
    ema_change = {m: change_norms(ema[m], ema_before[m]) for m in ema}
    del before, ema_before
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "ema_change_norms": ema_change}


def faulty_step(program: Program, batch, draws, fault: str = None):
    """``program.step``, or the step with a planted fault (the tests' and
    the calibration's): ``half_batch`` steps on the first half of the rows
    taken twice (the mean over half the batch); ``unchanged_state`` puts the parameters back
    after the step; ``skipped_ema`` puts the EMA back after the step."""
    if fault is None:
        return program.step(batch, draws)
    if fault == "half_batch":  # the first half's rows twice: the mean over the first half
        def half(t):
            first = t[: t.shape[0] // 2]
            return torch.cat([first, first])
        return program.step({k: half(v) for k, v in batch.items()}, {k: half(v) for k, v in draws.items()})
    if fault in ("unchanged_state", "skipped_ema"):
        state = program.trained() if fault == "unchanged_state" else program.ema()
        saved = {m: clone_all(p) for m, p in state.items()}
        loss = program.step(batch, draws)
        with torch.no_grad():
            for m, params in state.items():
                for n, p in params.items():
                    p.copy_(saved[m][n])
        return loss
    raise ValueError(f"unknown fault {fault!r}")


def reference_readings(config: dict, traffic: dict, seed: int, inputs, checked: int, block_rows: int, device,
                       num: Numerics = None) -> dict:
    num = num or Numerics()
    models = reference_models(config, traffic, seed, device, num)
    trainer = ReferenceTrainer(models, config["recipe"], seeded_ema_weights(config, traffic, seed, device), num)
    before = {m: clone_all(p) for m, p in trainer.trained.items()}
    ema_before = {m: clone_all(e) for m, e in trainer.ema.items()}
    losses, grad_norms = [], None
    for i in range(checked):
        batch, draws = inputs[i]
        losses.append(trainer.step(batch, draws, block_rows))
        if i == 0:
            grad_norms = {m: {n: float(torch.linalg.vector_norm(opt.momentum(n))) for n in opt.params}
                          for m, opt in trainer.opt.items()}
    change = {m: change_norms(trainer.trained[m], before[m]) for m in trainer.trained}
    ema_change = {m: change_norms(trainer.ema[m], ema_before[m]) for m in trainer.ema}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "ema_change_norms": ema_change}


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def device_of(cell: dict, device=None):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < cell["chips"]:
        raise NoDevice(f"the cell asks for {cell['chips']} cards, {torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device=None, fault: str = None) -> dict:
    """One run; returns the result's dict (``checks`` last)."""
    device = device_of(cell, device)
    config, traffic, check = cell["config"], cell["traffic"], cell["check"]
    tf32 = bool(traffic.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    checked = check["checked_steps"]
    batch_size = traffic["batch_size"]

    # --- set-up: states, weights, inputs, the checked steps ----------------
    marks = [("imports", time.perf_counter())]
    program = Program(config, traffic, device)
    marks.append(("states", time.perf_counter()))
    load_program(program, config, traffic, seed, device)
    inputs = make_inputs(traffic, config, derived_seed(seed, 2), device)
    marks.append(("weights and inputs", time.perf_counter()))
    readings = program_readings(program, inputs, checked, fault)
    marks.append(("checked steps", time.perf_counter()))
    losses = readings["losses"] + warm_further_sizes(program, inputs, checked, config, fault)
    if len(losses) > checked:
        marks.append(("further sizes", time.perf_counter()))
    failed = sum(1 for x in losses if x != x or abs(x) == float("inf"))
    attempted = len(losses)
    gc.collect()
    synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0
    print("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b) in zip([("", T0)] + marks, marks)),
          file=sys.stderr)

    # --- the window ----------------------------------------------------------
    losses, error = [], None
    start = time.perf_counter()
    i = 0
    while True:
        batch, draws = inputs[(checked + i) % len(inputs)]
        try:
            losses.append(faulty_step(program, batch, draws, fault))
        except Exception as exc:  # a step that raised counts as failed; the run goes on to report it
            error = exc
            break
        finally:
            i += 1
        if time.perf_counter() - start >= seconds:
            break
    synchronize(device)
    window_s = time.perf_counter() - start
    attempted += i
    failed += int(error is not None)
    if losses:
        failed += int((~torch.isfinite(torch.stack([x.float() for x in losses]))).sum())
    images = len(losses) * batch_size
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if error is not None:
        print(f"a window step raised: {error!r}", file=sys.stderr)

    metrics = {}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    values = {"images_per_s": images / window_s, "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    breakdown = None
    if not trace:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    elif error is None:
        view = traced_steps(program, inputs, checked + i, check["trace_steps"], device)
        sizes = [batch_resolution(inputs[(checked + k) % len(inputs)][0], config) for k in range(len(losses))]
        per_image = {size: flops.step_flops_per_image(config, traffic, size) for size in set(sizes)}
        window_flops = sum(batch_size * per_image[size] for size in sizes)
        view.window = {"images": images, "seconds": window_s, "steps": len(losses), "flops": window_flops}
        view.peak_flops = PEAK_FLOPS[traffic["mixed_precision"]]
        for m in cell["per_layer"]:
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            value = reader.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        device_info["busy_s"] = view.busy_s()
        device_info["window_s"] = view.window_s()
        breakdown = view.breakdown()
        view.close()

    # --- the reference, with the program's state freed -----------------------
    program.free()
    del program, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(config, traffic, seed, inputs, checked, check["reference_block_rows"], device)
    print(f"reference: {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    nums = compare.numbers(readings, ref)
    within, rows = compare.verdict(nums, check["limits"])
    found = forbidden_modules()
    result = {"correct": bool(within and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    result["checks"]["failed_steps"] = {"value": failed, "limit": 0}
    result["_detail"] = {k: nums[k] for k in ("grad_leaf", "change_leaf", "ema_leaf", "leaves_kept", "leaves",
                                              "ema_leaves")}
    result["_forbidden"] = found
    return result


def warm_further_sizes(program: Program, inputs, checked: int, config: dict, fault: str = None) -> list:
    """One step on each image size of the inputs that the checked steps did
    not run (a bucket mix), so that the window compiles nothing; their
    losses."""
    seen = {batch_resolution(batch, config) for batch, _ in inputs[:checked]}
    losses = []
    for batch, draws in inputs[checked:]:
        size = batch_resolution(batch, config)
        if size not in seen:
            seen.add(size)
            losses.append(float(faulty_step(program, batch, draws, fault)))
    return losses


def traced_steps(program, inputs, first: int, steps: int, device) -> TraceView:
    """``steps`` more steps under ``torch.profiler`` with the benchmark's
    spans installed; the Chrome trace goes to a fresh directory under the
    run's temporary directory and is read back."""
    from torch.profiler import ProfilerActivity, profile

    directory = tempfile.mkdtemp(prefix="portbench-trace-")
    path = os.path.join(directory, "trace.json")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with spans.installed():
        synchronize(device)
        with profile(activities=activities, record_shapes=True) as prof:
            for k in range(steps):
                batch, draws = inputs[(first + k) % len(inputs)]
                program.step(batch, draws)
            synchronize(device)
    prof.export_chrome_trace(path)
    del prof
    view = TraceView(path, steps)
    shutil.rmtree(directory, ignore_errors=True)
    return view


def emit(result: dict) -> int:
    found = result.pop("_forbidden")
    detail = result.pop("_detail")
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(f"checked leaves: worst grad {detail['grad_leaf']}, worst change {detail['change_leaf']}, "
          f"worst EMA {detail['ema_leaf']}, {detail['leaves_kept']} of {detail['leaves']} leaves kept for the "
          f"change, {detail['ema_leaves']} EMA leaves", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except NoDevice as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
