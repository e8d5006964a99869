"""The port stands alone: no module of ``stable_diffusion_training_tpu_torch``
and none of the root scripts ``chip_smoke.py``, ``probe_flash_bwd.py``,
``probe_flash_fwd.py`` and ``probe_lion.py`` imports JAX, flax or the JAX package; the package
imports on a CPU-only torch with no nvcc and no triton, the train and
trainer slices' modules included, and none of its modules imports tqdm,
transformers, safetensors, orbax or tensorboard when it is imported (the
card machine has none of them; the trainer imports transformers inside
``main``, only for a checkpoint's tokenizer); ``chip_smoke.py`` refuses to
run without a GPU or outside the repository."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
from torch_threads import _one_thread  # noqa: F401 (the fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "stable_diffusion_training_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "stable_diffusion_training_tpu")
# packages the card machine lacks: never imported when a module is imported
NOT_AT_IMPORT = ("tqdm", "transformers", "safetensors", "orbax", "tensorboard")
# the modules and kernel sources each slice adds; all are walked below
SLICE_MODULES = (
    "diffusion/ddim.py", "pipeline/stable_diffusion.py", "ops/flash_attention.py",  # serving
    "diffusion/ddpm.py", "utils/context.py", "ops/lion_kernel.py", "optim/masks.py",
    "optim/lion8bit.py", "optim/transforms.py", "train/config.py", "train/states.py",
    "train/train_step.py",  # training
    "utils/json_io.py", "data/buckets.py", "data/memory.py", "train/checkpoint.py",
    "train/aot.py", "utils/tb_events.py", "utils/metrics.py", "train/trainer.py",
    "training.py",  # the trainer
    "pipeline/sdxl.py", "pipeline/sdxl_refiner.py",  # SDXL serving
    "data/latent_cache.py",  # SDXL training
    "data/dataloader.py", "train/eval_sampler.py", "utils/timing.py",
    "utils/profiling.py",  # the streaming loader, eval sampling, the profiler trace
    "core/mesh.py", "core/distributed.py", "parallel/sharding.py",  # data parallelism
    "utils/hostcache.py", "utils/kernel_trace.py", "utils/roofline.py",  # the profiling tools
)
KERNEL_SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "lion8bit_update.cu")
SCRIPTS = ("chip_smoke.py", "probe_flash_bwd.py", "probe_flash_fwd.py", "probe_lion.py")  # run from the root on the card


def _port_files():
    """The root scripts, then every module of the package."""
    files = [os.path.join(REPO, name) for name in SCRIPTS]
    for root, _, names in os.walk(os.path.join(REPO, PACKAGE)):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            yield from (a.value for a in node.args[:1] if isinstance(a, ast.Constant))


def test_port_imports_no_jax_and_not_the_jax_package():
    files = _port_files()
    rel = {os.path.relpath(p, os.path.join(REPO, PACKAGE)) for p in files[len(SCRIPTS):]}
    assert set(SLICE_MODULES) <= rel
    for src in KERNEL_SOURCES:
        assert os.path.exists(os.path.join(REPO, PACKAGE, "csrc", src)), src
    offenders = [
        (os.path.relpath(path, REPO), module)
        for path in files
        for module in _imported_modules(path)
        if module.split(".")[0] in FORBIDDEN
    ]
    assert offenders == []


@pytest.mark.parametrize("module", ["utils/hostcache.py", "utils/kernel_trace.py", "utils/roofline.py"])
def test_profiling_tools_keep_their_own_copy(module):
    """The profiling tools port JAX modules that import no JAX themselves
    (``utils/hostcache.py``, ``xplane.py``, ``hloaudit.py``); the port's
    keep their own code and import neither JAX nor the JAX package, not
    even inside a function."""
    imported = list(_imported_modules(os.path.join(REPO, PACKAGE, module)))
    assert imported and not [m for m in imported if m.split(".")[0] in FORBIDDEN]


def _module_level_imports(path):
    """Modules imported by the statements that run when ``path`` is
    imported: the top level, not function bodies."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    pending = list(tree.body)
    while pending:
        node = pending.pop()
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, (ast.If, ast.Try, ast.With, ast.ClassDef)):
            pending += [child for child in ast.iter_child_nodes(node) if isinstance(child, ast.stmt)]


def test_port_imports_no_host_only_package_at_import():
    offenders = [
        (os.path.relpath(path, REPO), module)
        for path in _port_files()
        for module in _module_level_imports(path)
        if module.split(".")[0] in NOT_AT_IMPORT
    ]
    assert offenders == []


def test_package_imports_on_cpu_torch_without_jax():
    """Every module imports in a fresh interpreter, and none of them pulls
    JAX in (the build, nvcc and triton are only touched on first launch)."""
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_files()[len(SCRIPTS):]
    )
    code = (
        "import importlib, sys\n"
        "import torch\n"
        "before = set(sys.modules)  # torch may bring some of NOT_AT_IMPORT itself\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'triton')]\n"
        f"bad += [m for m in set(sys.modules) - before if m.split('.')[0] in {NOT_AT_IMPORT!r}]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def _run_chip_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=120
    )


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = _run_chip_smoke(REPO)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_probe_edits_match_the_fused_kernel_once():
    """Each variant of ``probe_flash_bwd.py`` replaces statements that occur
    exactly once in the fused backward's source, so the probe times the
    kernel as it stands and not a stale copy of it."""
    sys.path.insert(0, REPO)
    try:
        import probe_flash_bwd as probe
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, PACKAGE, "csrc", "flash_attention_bwd.cu")) as f:
        src = f.read()
    assert set(probe.VARIANTS) >= {"base", "no_exp", "no_dkv", "no_dq", "no_reduce", "no_barrier"}
    for name, edits in probe.VARIANTS.items():
        out = probe.variant_source(src, edits)
        assert (out == src) == (name == "base"), name
        assert probe.FUSED in out, name


def test_forward_probe_edits_match_the_mid_tile_once():
    """Each variant of ``probe_flash_fwd.py`` replaces the mid tile's count
    of consumer warpgroups, a statement that occurs exactly once in the
    forward's source, and the base variant is the source as it stands."""
    sys.path.insert(0, REPO)
    try:
        import probe_flash_fwd as probe
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, PACKAGE, "csrc", "flash_attention_fwd.cu")) as f:
        src = f.read()
    assert set(probe.VARIANTS) == {"consumers_2", "consumers_3", "consumers_4"}
    for name, edits in probe.VARIANTS.items():
        out = probe.variant_source(src, edits)
        assert (out == src) == (name == "consumers_3"), name
        assert probe.KERNEL in out, name


def test_forward_probe_f32_edits_match_the_mid_f32_tile_once():
    """Each ``f32_mid`` variant of ``probe_flash_fwd.py`` replaces the mid
    f32 tile's rows a thread, a statement that occurs exactly once in the
    forward's source, and the base variant is the source as it stands."""
    sys.path.insert(0, REPO)
    try:
        import probe_flash_fwd as probe
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, PACKAGE, "csrc", "flash_attention_fwd.cu")) as f:
        src = f.read()
    assert set(probe.F32_VARIANTS) == {"rows_8", "rows_7", "rows_6"}
    for name, edits in probe.F32_VARIANTS.items():
        out = probe.variant_source(src, edits)
        assert (out == src) == (name == "rows_6"), name
        assert probe.F32_KERNEL in out, name


def test_lion_probe_edits_match_the_kernels_once():
    """Each variant of ``probe_lion.py`` replaces statements that occur
    exactly once in the Lion kernels' source: the earlier kernel's powf and
    divides, the leaf-table kernel's requantization, divides, reads and
    math."""
    sys.path.insert(0, REPO)
    try:
        import probe_lion as probe
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, PACKAGE, "csrc", "lion8bit_update.cu")) as f:
        src = f.read()
    assert {"old_base", "old_no_powf", "old_no_divides", "new_base", "new_powf_always", "new_no_divides",
            "new_contiguous_reads"} <= set(probe.VARIANTS)
    for name, (entry, edits) in probe.VARIANTS.items():
        assert entry in ("old", "new"), name
        out = probe.variant_source(src, edits)
        assert (out == src) == name.endswith("_base"), name
