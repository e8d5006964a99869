"""One rank of the worlds of ``tests/test_torch_port_distributed.py``,
``tests/test_torch_port_fsdp*.py``, ``tests/test_torch_port_tp*.py`` and
``tests/test_torch_port_tp_fsdp*.py``.

Started with the ``spawn`` method; imports torch and the port only (no JAX,
no conftest). ``run_rank`` joins the gloo group through
``core.initialize_distributed`` (a file store in the work directory), runs
each case of ``payload.pt`` in order on the case's mesh (``mesh``: a shape,
by default ``(world, 1)``) and writes ``<case>_<rank>.pt`` (or
``<case>_<rank>.err`` with the traceback: the other rank then fails at the
next collective instead of hanging, the group having a timeout). Under FSDP
or TP a step's dump holds whole tensors, gathered from the shards or slices.
"""

import datetime
import hashlib
import json
import os
import traceback

import numpy as np
import torch


def whole_params(state, tensors: dict) -> dict:
    """``{name: tensor}`` of ``state``'s model, each shard of an FSDP or TP
    plan gathered into its whole leaf (every rank calls it)."""
    plan = state.plan
    return {k: (plan.rows[k].gather(v) if plan is not None and k in plan.rows else v).detach().clone()
            for k, v in tensors.items()}


def step_dump(out, before) -> dict:
    """What the tests compare of a step's output: the loss, each model's
    params (and ``before``, its params before the step) and EMA, and its
    Lion momentum (codes and scales, or the dense tensor), whole. Under
    FSDP or TP also, per model, the split quantized leaves whose momentum
    stays whole (``whole``) and whether every rank's local codes and scales
    are its slice of the gathered ones (``local_slices``)."""
    dump = {"loss": float(out[4]["loss"]), "params": {}, "ema": {}, "mu": {}, "before": before,
            "whole": {}, "local_slices": {}}
    for key, idx in (("unet", 0), ("text_encoder", 1)):
        state = out[idx]
        plan = state.plan
        dump["params"][key] = whole_params(state, state.params)
        dump["ema"][key] = whole_params(state, out[idx + 2] or {})
        mu, whole, slices = {}, [], {}
        if state.opt_state:
            for name, m in state.opt_state[1][0].mu_quant.items():
                if not hasattr(m, "codes"):
                    mu[name] = whole_params(state, {name: m})[name]
                    continue
                split = plan is not None and name in plan.rows
                shard = plan.momentum(name, m.codes.shape[1]) if split else None
                if shard is None:
                    mu[name] = (m.codes.clone(), m.scales.clone())
                    whole += [name] if split else []
                    continue
                codes, scales = shard.gather(m.codes, m.scales)
                local = shard.take(codes, scales)
                slices[name] = torch.equal(local[0], m.codes) and torch.equal(local[1], m.scales)
                mu[name] = (codes, scales)
        dump["mu"][key], dump["whole"][key], dump["local_slices"][key] = mu, whole, slices
    return dump


def step_config(overrides: dict):
    from stable_diffusion_training_tpu_torch.train import TrainingConfig

    base = dict(
        model_path="tiny", batch_size=2, learning_rate=1e-4, unet_learning_rate=1e-4,
        text_encoder_learning_rate=1e-4, lr_scheduler="constant", adam_to_lion_scale_factor=7.0,
        compilation_cache_path="unused", keep_compiled_fn_in_cache=False, text_encoder_context_window=77,
        context_window_concatenation_count=3, aot_compile=False, strip_bos_eos_token=True,
        image_area_root=[64], minimum_axis_length=[64],
        excluded_layer_pattern_from_weight_decay=["bias", "scale", "embedding"],
        excluded_layer_from_quantization=["bias", "scale", "embedding"], quant_block_size=16,
        quantize_unet_state=True, quantize_text_encoder_state=True, accumulate_unet_ema=True,
        accumulate_text_encoder_ema=True, ema_rate=0.999, mixed_precision="float32", model_family="tiny",
        beta_scheduler="zero_snr_scaled_linear", prediction_type="v_prediction", offset_noise_magnitude=0.0,
        min_snr_gamma_magnitude=0.0, perturbation_noise_magnitude=0.0,
    )
    return TrainingConfig(**{**base, **overrides})


def run_step(case: dict, mesh=None, draws_key: str = "draws") -> dict:
    """One train step of ``case`` (config overrides, the global batch and
    its draws ``case[draws_key]``, optionally a saved starting state): this
    rank's rows with ``mesh``, the whole batch without. ``card_exchange``:
    FSDP2's collectives and the gathers take the route of gloo ranks on one
    card (``parallel.sharding._CardExchange``, here over shared memory)."""
    from stable_diffusion_training_tpu_torch.parallel import sharding

    shares_card = sharding._shares_card
    if case.get("card_exchange"):  # the comms of gloo ranks on one card, here on CPU tensors
        sharding._shares_card = lambda group, device: True
    try:
        return _run_step(case, mesh, draws_key, cfg=step_config(case["config"]))
    finally:
        sharding._shares_card = shares_card


def _run_step(case, mesh, draws_key, cfg):
    from stable_diffusion_training_tpu_torch.core import slice_batch_for_process
    from stable_diffusion_training_tpu_torch.parallel import sharding
    from stable_diffusion_training_tpu_torch.train import on_device_model_training_state, restore_train_state
    from stable_diffusion_training_tpu_torch.train import save_train_state, train_step

    states = on_device_model_training_state(cfg, device="cpu", mesh=mesh)
    gathers = _count_all_gathers()
    if case.get("state_dir"):
        template = {
            "unet_state": states[0], "text_encoder_state": states[1], "unet_ema_params": states[2],
            "text_encoder_ema_params": states[3], "train_rng": torch.Generator(),
        }
        restore_train_state(case["state_dir"], template)
        states[4].call.load_state_dict(torch.load(os.path.join(case["state_dir"], "vae.pt")), strict=True)
        if case.get("resave_dir"):  # the restored state written again, before the step
            save_train_state(case["resave_dir"], *states[:4], torch.Generator())
    before = {key: whole_params(state, state.params) for key, state in (("unet", states[0]), ("text_encoder", states[1]))}
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    if mesh is not None:
        batch = slice_batch_for_process(batch, mesh)
    gathers.clear()
    tp_before = dict(sharding.TP_ALL_REDUCES)
    if case.get("rounding_rank") == (None if mesh is None else mesh.get_rank()):
        _round_whole_grads(states)
    out = train_step(
        *states[:4], batch, None, states[4], states[5], draws=case[draws_key], mesh=mesh,
        strip_bos_eos_token=True, ema_rate=cfg.ema_rate, offset_noise_magnitude=cfg.offset_noise_magnitude,
        min_snr_gamma_magnitude=cfg.min_snr_gamma_magnitude,
        perturbation_noise_magnitude=cfg.perturbation_noise_magnitude,
        grad_accumulation_steps=cfg.grad_accumulation_steps, train_text_encoder=cfg.train_text_encoder,
    )
    _round_whole_grads(None)
    dump = step_dump(out, before)
    dump["all_gathers"] = len(gathers)  # FSDP2's, in the step
    dump["tp_all_reduces"] = {k: v - tp_before[k] for k, v in sharding.TP_ALL_REDUCES.items()}
    _count_all_gathers(stop=True)
    return dump


def _round_whole_grads(states) -> None:
    """This rank's grads of the leaves no plan splits, off by a rounding
    step (as cuDNN's weight-grad sums or the flash backward's dQ sum may
    leave them on a card), for the train steps until called with None."""
    import importlib

    ts = importlib.import_module("stable_diffusion_training_tpu_torch.train.train_step")
    inner = getattr(ts._grads, "unrounded", ts._grads)
    if states is None:
        ts._grads = inner
        return
    split = ts._split_names(states[0], "") | ts._split_names(states[1], "text_encoder/")

    def rounded(loss, params, sharded=False):
        grads = inner(loss, params, sharded)
        return [g if name in split else g * (1 + 2.0**-12) for name, g in zip(params, grads)]

    rounded.unrounded = inner
    ts._grads = rounded


def _count_all_gathers(stop: bool = False) -> list:
    """Counts the calls of the process group's single-tensor all-gather
    (FSDP2's unshard) into the returned list until ``stop``."""
    import torch.distributed as dist

    name = "all_gather_single" if hasattr(dist, "all_gather_single") else "all_gather_into_tensor"
    inner = getattr(dist, name)
    inner = getattr(inner, "counted", inner)
    if stop:
        setattr(dist, name, inner)
        return []
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    counted.counted = inner
    setattr(dist, name, counted)
    return calls


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def run_trainer(case: dict, mesh=None) -> dict:
    """``trainer.main`` on this rank, from an in-memory loader of the
    rank's rows (its row block of ``mesh``: the model_parallel ranks of a
    block take the same rows) or (``loader=None``) the streaming loader, with every
    one-writer call counted, the eval images kept, the state's digest
    taken at each chunk checkpoint (of the rank's shards under FSDP), and
    each full-state restore checked against its files (the restored state,
    gathered whole, equal to the saved params and codes)."""
    from stable_diffusion_training_tpu_torch.core import slice_batch_for_process
    from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader
    from stable_diffusion_training_tpu_torch.data import dataloader as dl
    from stable_diffusion_training_tpu_torch.parallel import state_digest
    from stable_diffusion_training_tpu_torch.train import checkpoint, eval_sampler, trainer
    from stable_diffusion_training_tpu_torch.train.states import state_tensors

    calls = {"write_model": 0, "write_train_state": 0, "json": 0, "png": 0, "fetch": 0, "delete": 0}
    digests, pixel_digests, images, restored = [], [], [], []

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def save_chunk(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state,
                   unet_ema, text_encoder_ema, frozen_vae, train_rng=None):
        digests.append(state_digest(state_tensors(unet_state, text_encoder_state, unet_ema, text_encoder_ema)))
        return save_chunk_orig(config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state,
                               unet_ema, text_encoder_ema, frozen_vae, train_rng=train_rng)

    def grab(self):
        b = grab_orig(self)
        if isinstance(b, dict):
            pixel_digests.append(_digest(b["pixel_values"]))
        return b

    def save_png(arr, directory):
        images.append(np.asarray(arr).copy())
        return save_png_orig(arr, directory)

    def restore(directory, template):
        out = restore_orig(directory, template)
        restored.append(restored_as_saved(directory, out))
        return out

    save_chunk_orig, grab_orig = trainer._save_chunk_checkpoints, dl.DataLoader.grab_next_batch
    save_png_orig, restore_orig = eval_sampler.save_png_images, trainer.restore_train_state
    patches = [
        (checkpoint, "_write_model", counted("write_model", checkpoint._write_model)),
        (checkpoint, "_write_train_state", counted("write_train_state", checkpoint._write_train_state)),
        (trainer, "save_dict_to_json", counted("json", trainer.save_dict_to_json)),
        (eval_sampler, "save_png_images", counted("png", save_png)),
        (trainer, "restore_train_state", restore),
        (dl.DataLoader, "_fetch_one_chunk", counted("fetch", dl.DataLoader._fetch_one_chunk)),
        (dl.DataLoader, "delete_prev_chunks", counted("delete", dl.DataLoader.delete_prev_chunks)),
        (dl.DataLoader, "grab_next_batch", grab),
        (trainer, "_save_chunk_checkpoints", save_chunk),
    ]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    loader, tokenizer = None, None
    if case["loader"] == "memory":
        loader = InMemoryDataLoader([slice_batch_for_process(b, mesh) for b in case["batches"]])
    else:
        tokenizer = StubTokenizer()
    try:
        for owner, name, fn in patches:
            setattr(owner, name, fn)
        trainer.main(case["config_path"], dataloader=loader, tokenizer=tokenizer, device="cpu")
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    return {"calls": calls, "digests": digests, "pixel_digests": pixel_digests, "images": images,
            "restored": restored}


def restored_as_saved(directory: str, restored: dict) -> bool:
    """Whether the restored UNet state, gathered whole, holds the saved
    params and momentum codes bit for bit (every rank calls it)."""
    from stable_diffusion_training_tpu_torch.models.hf_io import load_safetensors

    saved = load_safetensors(os.path.join(directory, "unet_state.safetensors"))
    state = restored["unet_state"]
    params = whole_params(state, state.params)
    ok = bool(params) and all(torch.equal(v, saved[f"unet_state/params/{k}"]) for k, v in params.items())
    plan = state.plan
    for name, m in state.opt_state[1][0].mu_quant.items():
        if hasattr(m, "codes"):
            shard = plan.momentum(name, m.codes.shape[1]) if plan is not None and name in plan.rows else None
            codes = shard.gather(m.codes, m.scales)[0] if shard is not None else m.codes
            ok = ok and torch.equal(codes, saved[f"unet_state/opt_state/1/0/mu_quant/{name}/codes"])
    return ok


class StubTokenizer:
    """Whitespace words hashed (crc32) into the tiny CLIP's 1,000 ids."""

    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0
    model_max_length = 77

    def __call__(self, texts, add_special_tokens=False, **kw):
        import zlib

        return {"input_ids": [[3 + zlib.crc32(w.encode()) % 996 for w in t.split()] for t in texts]}

    def save_pretrained(self, directory):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "stub_tokenizer.json"), "w") as f:
            json.dump({"vocab_size": 1000}, f)


def run_layout(case: dict) -> dict:
    """The process-group helpers of ``core`` and ``parallel`` on this rank:
    batch slicing, the config's mesh checks, meshes, the buckets of the
    collectives."""
    from stable_diffusion_training_tpu_torch.core import distributed as cd
    from stable_diffusion_training_tpu_torch.core import mesh as cm
    from stable_diffusion_training_tpu_torch.parallel import all_reduce_grads_, replicate_

    out = {"rank": cd.process_index(), "count": cd.process_count()}
    out["local_slice"] = cd.process_local_batch_slice(case["global_batch"])
    out["sliced"] = cd.slice_batch_for_process(case["batch"])
    out["sliced_torch"] = cd.slice_batch_for_process({k: torch.as_tensor(v) for k, v in case["batch"].items()})
    configs = {}
    for name, overrides in case["configs"].items():
        try:
            step_config(overrides)
            configs[name] = "ok"
        except (NotImplementedError, ValueError) as e:
            configs[name] = f"{type(e).__name__}: {e}"
    out["configs"] = configs
    mesh = cm.create_mesh(device_type="cpu")
    out["mesh"] = (cm.axis_size(mesh), cm.axis_index(mesh), cm.axis_size(mesh, cm.AXIS_TENSOR))
    hybrid = cd.create_hybrid_mesh((1, 1, 1), (2, 1, 1), device_type="cpu")
    out["hybrid"] = (tuple(hybrid.mesh.shape), hybrid.mesh.flatten().tolist(), hybrid.mesh_dim_names)
    # every dtype and a leaf of an odd size in each bucket; rank r's
    # tensors hold r + 1, so the sums are 3 and rank 0's values win
    rank = cd.process_index()
    shapes = [(3,), (5, 7), (1,), (4, 4), (33,)]
    grads = {f"g{i}": torch.full(s, rank + 1.0, dtype=dt) for i, (s, dt) in
             enumerate(zip(shapes, [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16, torch.float32]))}
    all_reduce_grads_(grads, mesh)
    out["reduced"] = {k: (v.float().tolist(), v.data_ptr() % 16, v.is_contiguous()) for k, v in grads.items()}
    tensors = [torch.full(s, rank + 1.0) for s in shapes] + [torch.full((9,), rank + 1, dtype=torch.int8)]
    replicate_(tensors, mesh)
    out["replicated"] = [t.tolist() for t in tensors]
    return out


class RuleModel(torch.nn.Module):
    """One leaf of each kind for the momentum co-sharding rule at block 16
    on two ranks: a Dense and a Conv kernel (transposed leaves: 32 and 16
    output channels a rank), leaves whose orders agree (the biases; an
    embedding table of 77 rows, split 39 and 38), and leaves kept whole (a
    Conv kernel of 4 output channels; a 48-wide norm, 24 elements a rank,
    not whole blocks)."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(24, 64)
        self.conv = torch.nn.Conv2d(8, 32, 3)
        self.table = torch.nn.Embedding(77, 16)
        self.out = torch.nn.Conv2d(8, 4, 3)
        self.norm = torch.nn.LayerNorm(48)


RULE_EXCLUDED = ("out.bias",)  # 4 elements: dense momentum


class TpRuleModel(torch.nn.Module):
    """One leaf of each kind for the rule over a ``(1, 2, 2)`` mesh at block
    16 (TP first, then FSDP2 on each TP slice): the ``wide`` attention's
    q, k, v (column-split, 16 output channels a rank) and ``to_out``
    (row-split, then sharded on its outputs: 32 input rows a rank, in runs
    of 32 of its 64 output channels), ``mlp_fc1`` (column-split with its
    bias) and ``mlp_fc2`` (row-split; its bias whole under TP), all whole
    blocks at both levels; the ``narrow`` attention's q, k, v (12 output
    channels a rank) and ``to_out`` (24 rows, or bias elements, a rank under
    FSDP), which keep their whole momentum; a Conv kernel and a 48-wide norm that TP leaves
    whole and FSDP splits (the norm into 24 elements a rank, not whole
    blocks)."""

    def __init__(self):
        super().__init__()
        from stable_diffusion_training_tpu_torch.models.attention import Attention

        self.wide = Attention(64, heads=2, dim_head=32)
        self.narrow = Attention(48, heads=2, dim_head=24)
        self.mlp_fc1 = torch.nn.Linear(64, 128)
        self.mlp_fc2 = torch.nn.Linear(128, 64)
        self.conv = torch.nn.Conv2d(8, 32, 3)
        self.norm = torch.nn.LayerNorm(48)


def rule_inputs(seed: int = 0, model_class=None):
    """The rule model's params and two steps of grads, whole, from a seed."""
    torch.manual_seed(seed)
    model = (model_class or RuleModel)()
    g = torch.Generator().manual_seed(seed + 1)
    grads = [{n: torch.randn(p.shape, generator=g) for n, p in model.named_parameters()} for _ in range(2)]
    return model, grads


def rule_optimizer(model, use_pallas, plan=None, max_norm=0.5):
    """Global-norm clipping at ``max_norm`` and 8-bit Lion at block 16 over
    the rule model (``plan``: its FSDP plan, or None for one process)."""
    from stable_diffusion_training_tpu_torch.models.hf_io import jax_param_paths
    from stable_diffusion_training_tpu_torch.optim import transforms
    from stable_diffusion_training_tpu_torch.optim.lion8bit import scale_by_lion_8bit

    mask = {n: n not in RULE_EXCLUDED for n, _ in model.named_parameters()}
    orders = {n: perm for n, (_, perm) in jax_param_paths(model).items()}
    lion = scale_by_lion_8bit(block_size=16, excluded_layer_mask=mask, use_pallas=use_pallas,
                              leaf_orders=orders, plan=plan)
    return transforms.chain(transforms.clip_by_global_norm(max_norm, plan), lion)


def rule_state(state) -> dict:
    mu = state.mu_quant
    return {n: (m.codes.clone(), m.scales.clone()) if hasattr(m, "codes") else m.clone() for n, m in mu.items()}


def shard_layout(shard) -> tuple:
    """A plan's shard of one leaf as plain values: ``("rows", dim, bounds,
    index)``, or ``("nested", outer, inner)`` of two such."""
    if hasattr(shard, "outer"):
        return ("nested", shard_layout(shard.outer), shard_layout(shard.inner))
    return ("rows", shard.dim, tuple(shard.bounds), shard.index)


def run_rule(case: dict, mesh) -> dict:
    """The rule model sharded with FSDP2 over the mesh's fsdp axis (with
    ``tp``: ``TpRuleModel``, first split over the model_parallel axis); the
    clip and 8-bit Lion chain on this rank's shards (``use_pallas`` as the
    case says) for two updates of the whole grads' local parts: the local
    momentum after init and after each update, the local updates, each
    leaf's rows (its layout under TP), and ``global_norm``'s value and
    collectives on the shards."""
    import torch.distributed as dist
    from torch.distributed.fsdp import fully_shard

    from stable_diffusion_training_tpu_torch.optim import transforms
    from stable_diffusion_training_tpu_torch.parallel.sharding import (
        fsdp_mesh, local_tensor, shard_plan, tensor_parallel_,
    )

    model, grads = rule_inputs(model_class=TpRuleModel if case.get("tp") else None)
    if case.get("tp"):
        tensor_parallel_(model, mesh)
    fully_shard(model, mesh=fsdp_mesh(mesh))
    plan = shard_plan(model)
    params = {n: local_tensor(p) for n, p in model.named_parameters()}
    tx = rule_optimizer(model, case["use_pallas"], plan, case.get("max_norm", 0.5))
    state = tx.init(params)
    rows = {n: shard_layout(r) if case.get("tp") else (r.start, r.stop) for n, r in plan.rows.items()}
    out = {"rows": rows,
           "whole": sorted(n for n in plan.rows if n not in RULE_EXCLUDED and plan.momentum(n, 16) is None),
           "init": rule_state(state[1]), "updates": [], "states": []}
    for step in grads:
        local = {n: plan.take(n, g) for n, g in step.items()}
        updates, state = tx.update(local, state, params)
        out["updates"].append({n: u.clone() for n, u in updates.items()})
        out["states"].append(rule_state(state[1]))
    local = {n: plan.take(n, g) for n, g in grads[0].items()}
    calls = []
    inner = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    dist.all_reduce = counted
    try:
        out["global_norm"] = float(transforms.global_norm(local, plan))
    finally:
        dist.all_reduce = inner
    out["norm_collectives"] = len(calls)
    return out


def run_plan(case: dict, mesh) -> dict:
    """The trained models' plans on this rank after
    ``on_device_model_training_state`` with the case's config: ``{model:
    {name: shard_layout}}``, and the leaves whose momentum the rule keeps
    whole."""
    from stable_diffusion_training_tpu_torch.train import on_device_model_training_state

    states = on_device_model_training_state(step_config(case["config"]), device="cpu", mesh=mesh)
    out = {"layout": {}, "whole": {}}
    for key, state in (("unet", states[0]), ("text_encoder", states[1])):
        plan = state.plan
        out["layout"][key] = {n: shard_layout(r) for n, r in plan.rows.items()}
        mu = state.opt_state[1][0].mu_quant
        out["whole"][key] = sorted(n for n, m in mu.items() if hasattr(m, "codes") and plan.momentum(n, 16) is None)
    return out


def run_rank(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    from stable_diffusion_training_tpu_torch.core import create_mesh, initialize_distributed

    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    initialize_distributed(
        device="cpu", rank=rank, world_size=world, init_method=f"file://{os.path.join(workdir, 'store')}",
        timeout=datetime.timedelta(seconds=120),
    )
    meshes = {}
    for name, case in payload["cases"].items():
        shape = tuple(case.get("mesh", (world, 1)))
        if shape not in meshes:
            meshes[shape] = create_mesh(shape, device_type="cpu")
        mesh = meshes[shape]
        try:
            if case["kind"] == "step":
                result = run_step(case, mesh)
            elif case["kind"] == "plan":
                result = run_plan(case, mesh)
            elif case["kind"] == "trainer":
                result = run_trainer(case, mesh)
            elif case["kind"] == "rule":
                result = run_rule(case, mesh)
            else:
                result = run_layout(case)
        except Exception:  # written for the test to show, then the rank stops
            with open(os.path.join(workdir, f"{name}_{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
            raise
        torch.save(result, os.path.join(workdir, f"{name}_{rank}.pt"))


# --- the parent's side: start a world, collect its results --------------------


def start_world(workdir: str, cases: dict, world: int = 2) -> list:
    """Write ``cases`` to ``workdir/payload.pt`` and start ``world`` ranks
    (``spawn``) that run them."""
    import multiprocessing

    torch.save({"cases": cases}, os.path.join(workdir, "payload.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_rank, args=(r, world, workdir), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def wait_world(procs: list, deadline: float) -> list:
    """Join the ranks; a rank that exits non-zero, or the deadline
    (``time.monotonic()``), ends the world (the rest are killed). Returns
    the exit codes."""
    import time

    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    return [p.exitcode for p in procs]


def world_results(workdir: str, cases: dict, world: int = 2) -> dict:
    """``{(case, rank): result}``, a rank's traceback (str) where it failed."""
    results = {}
    for name in cases:
        for r in range(world):
            pt, err = os.path.join(workdir, f"{name}_{r}.pt"), os.path.join(workdir, f"{name}_{r}.err")
            if os.path.exists(pt):
                results[(name, r)] = torch.load(pt, weights_only=False)
            elif os.path.exists(err):
                with open(err) as f:
                    results[(name, r)] = f.read()
    return results
