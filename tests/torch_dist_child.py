"""One rank of ``tests/test_torch_port_distributed.py``'s two-rank world.

Started with the ``spawn`` method; imports torch and the port only (no JAX,
no conftest). ``run_rank`` joins the gloo group through
``core.initialize_distributed`` (a file store in the work directory), runs
each case of ``payload.pt`` in order and writes ``<case>_<rank>.pt`` (or
``<case>_<rank>.err`` with the traceback: the other rank then fails at the
next collective instead of hanging, the group having a timeout).
"""

import datetime
import hashlib
import json
import os
import traceback

import numpy as np
import torch


def step_dump(out, before) -> dict:
    """What the tests compare of a step's output: the loss, each model's
    params (and ``before``, its params before the step) and EMA, and its
    Lion momentum (codes and scales, or the dense tensor)."""
    dump = {"loss": float(out[4]["loss"]), "params": {}, "ema": {}, "mu": {}, "before": before}
    for key, idx in (("unet", 0), ("text_encoder", 1)):
        state = out[idx]
        dump["params"][key] = {k: v.detach().clone() for k, v in state.params.items()}
        dump["ema"][key] = {k: v.clone() for k, v in (out[idx + 2] or {}).items()}
        mu = {}
        if state.opt_state:
            for name, m in state.opt_state[1][0].mu_quant.items():
                mu[name] = (m.codes.clone(), m.scales.clone()) if hasattr(m, "codes") else m.clone()
        dump["mu"][key] = mu
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
    rank's rows with ``mesh``, the whole batch without."""
    from stable_diffusion_training_tpu_torch.core import slice_batch_for_process
    from stable_diffusion_training_tpu_torch.train import on_device_model_training_state, restore_train_state
    from stable_diffusion_training_tpu_torch.train import train_step

    cfg = step_config(case["config"])
    states = on_device_model_training_state(cfg, device="cpu", mesh=mesh)
    if case.get("state_dir"):
        template = {
            "unet_state": states[0], "text_encoder_state": states[1], "unet_ema_params": states[2],
            "text_encoder_ema_params": states[3], "train_rng": torch.Generator(),
        }
        restore_train_state(case["state_dir"], template)
        states[4].call.load_state_dict(torch.load(os.path.join(case["state_dir"], "vae.pt")), strict=True)
    before = {key: {k: v.detach().clone() for k, v in state.params.items()}
              for key, state in (("unet", states[0]), ("text_encoder", states[1]))}
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    if mesh is not None:
        batch = slice_batch_for_process(batch)
    out = train_step(
        *states[:4], batch, None, states[4], states[5], draws=case[draws_key], mesh=mesh,
        strip_bos_eos_token=True, ema_rate=cfg.ema_rate, offset_noise_magnitude=cfg.offset_noise_magnitude,
        min_snr_gamma_magnitude=cfg.min_snr_gamma_magnitude,
        perturbation_noise_magnitude=cfg.perturbation_noise_magnitude,
        grad_accumulation_steps=cfg.grad_accumulation_steps, train_text_encoder=cfg.train_text_encoder,
    )
    return step_dump(out, before)


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def run_trainer(case: dict) -> dict:
    """``trainer.main`` on this rank, from an in-memory loader of the
    rank's rows or (``loader=None``) the streaming loader, with every
    one-writer call counted and the state's digest taken at each chunk
    checkpoint."""
    from stable_diffusion_training_tpu_torch.core import slice_batch_for_process
    from stable_diffusion_training_tpu_torch.data import InMemoryDataLoader
    from stable_diffusion_training_tpu_torch.data import dataloader as dl
    from stable_diffusion_training_tpu_torch.parallel import state_digest
    from stable_diffusion_training_tpu_torch.train import checkpoint, eval_sampler, trainer
    from stable_diffusion_training_tpu_torch.train.states import state_tensors

    calls = {"write_model": 0, "write_train_state": 0, "json": 0, "png": 0, "fetch": 0, "delete": 0}
    digests, pixel_digests = [], []

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

    save_chunk_orig, grab_orig = trainer._save_chunk_checkpoints, dl.DataLoader.grab_next_batch
    patches = [
        (checkpoint, "_write_model", counted("write_model", checkpoint._write_model)),
        (checkpoint, "_write_train_state", counted("write_train_state", checkpoint._write_train_state)),
        (trainer, "save_dict_to_json", counted("json", trainer.save_dict_to_json)),
        (eval_sampler, "save_png_images", counted("png", eval_sampler.save_png_images)),
        (dl.DataLoader, "_fetch_one_chunk", counted("fetch", dl.DataLoader._fetch_one_chunk)),
        (dl.DataLoader, "delete_prev_chunks", counted("delete", dl.DataLoader.delete_prev_chunks)),
        (dl.DataLoader, "grab_next_batch", grab),
        (trainer, "_save_chunk_checkpoints", save_chunk),
    ]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    loader, tokenizer = None, None
    if case["loader"] == "memory":
        loader = InMemoryDataLoader([slice_batch_for_process(b) for b in case["batches"]])
    else:
        tokenizer = StubTokenizer()
    try:
        for owner, name, fn in patches:
            setattr(owner, name, fn)
        trainer.main(case["config_path"], dataloader=loader, tokenizer=tokenizer, device="cpu")
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    return {"calls": calls, "digests": digests, "pixel_digests": pixel_digests}


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


def run_rank(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    from stable_diffusion_training_tpu_torch.core import create_mesh, initialize_distributed

    payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    initialize_distributed(
        device="cpu", rank=rank, world_size=world, init_method=f"file://{os.path.join(workdir, 'store')}",
        timeout=datetime.timedelta(seconds=120),
    )
    mesh = create_mesh(device_type="cpu")
    for name, case in payload["cases"].items():
        try:
            if case["kind"] == "step":
                result = run_step(case, mesh)
            elif case["kind"] == "trainer":
                result = run_trainer(case)
            else:
                result = run_layout(case)
        except Exception:  # written for the test to show, then the rank stops
            with open(os.path.join(workdir, f"{name}_{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
            raise
        torch.save(result, os.path.join(workdir, f"{name}_{rank}.pt"))
