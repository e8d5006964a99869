"""Chunked training orchestration: the body of
``python -m stable_diffusion_training_tpu_torch.training``.

Port of ``stable_diffusion_training_tpu/train/trainer.py``, with the
reference trainer's quirks that it keeps:

- the JSON config is a mutable resume-state store: ``model_path``,
  ``chunk_number``, ``chunk_steps`` and ``master_seed`` are rewritten during
  the run, with a ``backup_<name>.json`` taken at startup;
- a save probe before each chunk: a real ``save_model`` (and its EMA
  variant) to ``test_save_path``, ``sys.exit()`` on failure, the probe
  deleted on success;
- ``loss.csv`` with the header ``steps, step_size, loss, time, chunk, seed``
  and newline-prefixed rows; the metric list is reset inside the loop, so
  the logged "avg loss" is the current step's loss;
- checkpoints to ``{base}@{chunk_steps}`` (and ``{base}-EMA@{chunk_steps}``)
  with rotation deleting ``@{chunk_steps - keep_trained_model_buffer}``;
- DEBUG mode: the logging interval ``//= 10`` (persisted with the JSON) and
  the loader capped at 100 batches;
- each batch goes to the step of its shape (``train.aot``).

The full training state (optimizer, EMA, the generator) rides in each
checkpoint's ``train_state/`` subfolder and is restored from ``model_path``
when present. Random draws come from a ``torch.Generator`` on the training
device seeded with ``master_seed``. Batches reach the device from pinned
host memory without blocking, ``device_prefetch_depth`` ahead of the step.

With ``dataloader=None`` the trainer builds the streaming ``DataLoader``
(``data/dataloader.py``) from the config, as the JAX trainer does: each
chunk is fetched into ``ramdisk_path``, bucketed and decoded on worker
threads. A loader can be passed instead: an ``InMemoryDataLoader``, or a
``CachedLatentLoader`` over an offline latent cache (``data/latent_cache.py``:
``latent_moments``, and for SDXL the pooled embeds, time ids and the frozen
towers' context; each chunk checkpoint then holds the SDXL UNet with its
``add_embedding`` under diffusers names, as the JAX trainer's does). The
lines that the JAX trainer writes through ``tqdm`` are printed.

``eval_sample_interval`` samples with DDIM from the live weights every N
steps (``train/eval_sampler.py``); ``profile_trace_dir`` records the first
steps of the first chunk (``min(4, loss_logging_interval) + 1``, as the JAX
trainer stops its trace) with ``torch.profiler`` and writes a Chrome trace
there. A tokenizer is used only when passed, or when
``model_path/tokenizer`` exists (``transformers`` is then imported).
"""

import contextlib
import os
import sys
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.json_io import delete_file_or_folder, read_json_file, save_dict_to_json
from ..utils.metrics import MetricsWriter
from ..utils.profiling import profiler_trace
from .aot import batch_dispatch_key, bucket_train_steps
from .checkpoint import restore_train_state, save_model, save_train_state
from .config import training_config_from_dict
from .eval_sampler import EvalSampler
from .states import on_device_model_training_state

# subfolder of each chunk checkpoint that holds the full training state
TRAIN_STATE_SUBDIR = "train_state"


def load_run_config(config_dict_path: str):
    """Read and back up the JSON state file, check the bucket config, build
    the typed subset."""
    config_dict = read_json_file(config_dict_path)
    directory, name = os.path.split(config_dict_path)
    save_dict_to_json(config_dict, os.path.join(directory, f"backup_{name}"))
    if len(config_dict["image_area_root"]) != len(config_dict["minimum_axis_length"]):
        raise ValueError(
            "number of elements in image_area_root and minimum_axis_length is not "
            "match! check your config files!"
        )
    return config_dict, training_config_from_dict(config_dict)


def _build_dataloader(config_dict, config_dict_path, tokenizer):
    """The streaming loader of the config's repos, chunk and seed."""
    from ..data import DataLoader

    return DataLoader(
        tokenizer_obj=tokenizer,
        config=config_dict_path,
        ramdisk_path=config_dict["ramdisk_path"],
        training_batch_size=config_dict["batch_size"],
        repeat_batch=config_dict["repeat_batch"],
        maximum_resolution_areas=[x**2 for x in config_dict["image_area_root"]],
        bucket_lower_bound_resolutions=config_dict["minimum_axis_length"],
        numb_of_worker_thread=config_dict["numb_of_dataloader_worker_thread"],
        queue_get_timeout=config_dict["queue_get_timeout"],
        chunk_number=config_dict["chunk_number"],
        seed=config_dict["master_seed"],
        context_concatenation_multiplier=config_dict["context_window_concatenation_count"],
    )


def _to_device(batch: dict, device: torch.device) -> dict:
    """Numpy arrays to ``device``: from pinned host memory without blocking
    on a card, as they are on the CPU."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) else value
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def _prefetch_to_device(dataloader, total: int, context_window: int, device, depth: int = 1):
    """Keep up to ``depth`` batches with their host-to-device copies in
    flight while the step runs. Yields the ``grab_next_batch`` stream (a
    batch, ``None`` or ``"end_of_batch"``), ids and mask reshaped to the
    context window; ``None`` entries pass through without holding back the
    batches behind them. Never grabs more than ``total`` items, and none
    after ``"end_of_batch"``."""
    depth = max(1, int(depth))
    device = torch.device(device)

    def grab():
        b = dataloader.grab_next_batch()
        if b is None or isinstance(b, str):
            return b
        b = dict(b)
        b["input_ids"] = b["input_ids"].reshape(-1, context_window)
        if "attention_mask" in b:
            b["attention_mask"] = b["attention_mask"].reshape(-1, context_window)
        return _to_device(b, device)

    buf = deque()
    grabbed = 0
    ended = False
    for _ in range(total):
        while not ended and len(buf) < depth and grabbed < total:
            b = grab()
            grabbed += 1
            if isinstance(b, str) and b == "end_of_batch":
                ended = True
            buf.append(b)
        if not buf:
            return
        yield buf.popleft()


def _ema_or_params(config_dict, key, ema, state):
    return ema if config_dict[key] else state.params


def _run_save_probe(
    config_dict, model_object_dict, tokenizer,
    unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params, frozen_vae,
) -> None:
    """A real save (and its EMA variant) to ``test_save_path`` before the
    chunk: exit on failure, delete the probe on success."""
    probe_path = config_dict["test_save_path"]
    try:
        print("trying to save model to check if the saving mechanism works")
        save_model(
            model_object_dict=model_object_dict, tokenizer_object=tokenizer,
            unet_params=unet_state.params, text_encoder_params=text_encoder_state.params,
            vae_params=frozen_vae.params, output_dir=probe_path,
        )
        if config_dict["ema_rate"]:
            save_model(
                model_object_dict=model_object_dict, tokenizer_object=tokenizer,
                unet_params=_ema_or_params(config_dict, "accumulate_unet_ema", unet_ema_params, unet_state),
                text_encoder_params=_ema_or_params(
                    config_dict, "accumulate_text_encoder_ema", text_encoder_ema_params, text_encoder_state
                ),
                vae_params=frozen_vae.params, output_dir=f"{probe_path}-EMA",
            )
    except Exception as e:  # the probe's whole point: any failure to save stops the run
        print("failed to save model prior to training session! please check your config or your code first")
        print(f"reason: {e}")
        sys.exit()

    print("save function works as expected deleting the test model")
    delete_file_or_folder(probe_path)
    delete_file_or_folder(f"{probe_path}-EMA")


def _save_chunk_checkpoints(
    config_dict, model_object_dict, tokenizer,
    unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params, frozen_vae,
    train_rng=None,
) -> str:
    """The chunk's checkpoint to ``{base}@{chunk_steps}`` (and ``-EMA``),
    rotation, and the full state in its ``train_state/``. Returns the new
    model path."""
    base = config_dict["model_path"].split("@")[0]
    steps = config_dict["chunk_steps"]
    keep = config_dict["keep_trained_model_buffer"]

    latest_model_path = f"{base}@{steps}"
    save_model(
        model_object_dict=model_object_dict, tokenizer_object=tokenizer,
        unet_params=unet_state.params, text_encoder_params=text_encoder_state.params,
        vae_params=frozen_vae.params, output_dir=latest_model_path,
    )
    delete_file_or_folder(f"{base}@{steps - keep}")

    if config_dict["ema_rate"]:
        save_model(
            model_object_dict=model_object_dict, tokenizer_object=tokenizer,
            unet_params=_ema_or_params(config_dict, "accumulate_unet_ema", unet_ema_params, unet_state),
            text_encoder_params=_ema_or_params(
                config_dict, "accumulate_text_encoder_ema", text_encoder_ema_params, text_encoder_state
            ),
            vae_params=frozen_vae.params, output_dir=f"{base}-EMA@{steps}",
        )
        delete_file_or_folder(f"{base}-EMA@{steps - keep}")

    # inside the checkpoint directory, so rotation removes it with the chunk;
    # diffusers loaders ignore the extra subfolder
    if train_rng is not None and config_dict.get("full_state_checkpoint", True):
        save_train_state(
            os.path.join(latest_model_path, TRAIN_STATE_SUBDIR),
            unet_state=unet_state, text_encoder_state=text_encoder_state,
            unet_ema_params=unet_ema_params, text_encoder_ema_params=text_encoder_ema_params,
            train_rng=train_rng,
            step_metadata={
                "chunk_steps": steps,
                "chunk_number": config_dict["chunk_number"],
                "master_seed": config_dict["master_seed"],
            },
        )
    return latest_model_path


def _maybe_restore_full_state(
    config_dict, unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params, train_rng,
):
    """Optimizer state (quantized momentum included), EMA buffers and the
    generator from ``model_path/train_state`` when it exists."""
    state_dir = os.path.join(config_dict["model_path"], TRAIN_STATE_SUBDIR)
    if not (config_dict.get("full_state_checkpoint", True) and os.path.isdir(state_dir)):
        return unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params, train_rng
    template = {
        "unet_state": unet_state,
        "text_encoder_state": text_encoder_state,
        "unet_ema_params": unet_ema_params if unet_ema_params is not None else {},
        "text_encoder_ema_params": text_encoder_ema_params if text_encoder_ema_params is not None else {},
        "train_rng": train_rng,
    }
    restored = restore_train_state(state_dir, template)
    print(f"restored full training state (optimizer/EMA/RNG) from {state_dir}")
    return (
        restored["unet_state"],
        restored["text_encoder_state"],
        restored["unet_ema_params"] if unet_ema_params is not None else None,
        restored["text_encoder_ema_params"] if text_encoder_ema_params is not None else None,
        restored["train_rng"],
    )


def main(
    config_dict_path: str = "model_properties.json",
    dataloader: Optional[Any] = None,
    tokenizer: Optional[Any] = None,
    device=None,
) -> None:
    """Run ``chunk_limit`` chunks of training from the JSON config at
    ``config_dict_path`` on ``device`` (cuda unless told otherwise), with
    ``dataloader`` (None: the streaming ``DataLoader`` built from the
    config; or an ``InMemoryDataLoader``, a ``CachedLatentLoader`` or
    anything with their protocol)."""
    config_dict, training_config = load_run_config(config_dict_path)

    if tokenizer is None:
        tok_dir = os.path.join(config_dict["model_path"], "tokenizer")
        if os.path.isdir(tok_dir):
            from transformers import CLIPTokenizer

            tokenizer = CLIPTokenizer.from_pretrained(config_dict["model_path"], subfolder="tokenizer")

    if dataloader is None:
        dataloader = _build_dataloader(config_dict, config_dict_path, tokenizer)
    device = resolve_device(device)

    if not config_dict["DEBUG"]:
        dataloader._print_debug = False

    train_rng = torch.Generator(device=device).manual_seed(config_dict["master_seed"])
    (
        unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params,
        frozen_vae, frozen_schedulers, model_object_dict,
    ) = on_device_model_training_state(training_config, device=device)
    unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params, train_rng = (
        _maybe_restore_full_state(
            config_dict, unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params, train_rng,
        )
    )
    train_step_funcs = bucket_train_steps(training_config, frozen_vae)

    if config_dict["DEBUG"]:
        # careful: this mutates the persisted json states, as in the reference
        config_dict["loss_logging_interval"] //= 10
    if not os.path.isfile(config_dict["loss_csv"]):
        with open(config_dict["loss_csv"], "w") as loss_file:
            loss_file.write("steps, step_size, loss, time, chunk, seed\n")

    # the first steps of the first chunk under torch.profiler (opt-in)
    profile_trace_dir = config_dict.get("profile_trace_dir")

    metrics_writer = MetricsWriter(config_dict.get("tensorboard_dir"))
    global_step = 0  # steps this invocation (chunk and seed tagged alongside)
    interval = config_dict["loss_logging_interval"]
    # in-loop DDIM eval sampling every N steps (opt-in)
    eval_sampler = EvalSampler(config_dict, model_object_dict, tokenizer, metrics_writer, device=device)

    for chunk_index in range(config_dict["chunk_limit"]):
        dataloader.delete_prev_chunks(prev_chunk=config_dict["chunk_number"] - 1)
        if config_dict["chunk_number"] >= config_dict["chunk_limit"]:
            dataloader.delete_prev_chunks(prev_chunk=config_dict["chunk_number"])
            config_dict["chunk_number"] = 0
        dataloader.chunk_number = config_dict["chunk_number"]
        dataloader.grab_and_prefetch_chunk(numb_of_prefetched_batch=config_dict["numb_of_prefetched_batch"])
        dataloader.prepare_training_dataframe()
        dataloader.create_training_dataframe()
        if config_dict["DEBUG"]:
            dataloader._bulk_batch_count = min(dataloader._bulk_batch_count, 100)
        dataloader.dispatch_worker()

        _run_save_probe(
            config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state,
            unet_ema_params, text_encoder_ema_params, frozen_vae,
        )

        start = time.time()
        # the profiler window: open for the first steps, closed by the end
        # of the chunk at the latest
        trace = contextlib.ExitStack()
        tracing = bool(profile_trace_dir) and chunk_index == 0
        if tracing:
            trace.enter_context(profiler_trace(profile_trace_dir, device=device))
        total_batches = int(dataloader._bulk_batch_count + dataloader._first_batch_count)
        batch_stream = _prefetch_to_device(
            dataloader, total_batches, config_dict["text_encoder_context_window"], device,
            depth=config_dict.get("device_prefetch_depth", 1),
        )
        with trace:
            for count, current_batch in enumerate(batch_stream):
                if isinstance(current_batch, str) and current_batch == "end_of_batch":
                    break
                if current_batch is None:
                    continue

                # reference quirk kept: reset inside the loop, so the logged
                # "avg loss" is the single current step's loss
                train_metrics = []
                (
                    unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params,
                    train_metric, train_rng,
                ) = train_step_funcs[batch_dispatch_key(current_batch)](
                    unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params,
                    current_batch, train_rng, frozen_vae, frozen_schedulers,
                )
                train_metrics.append(train_metric["loss"])

                if tracing and count >= min(4, interval):
                    train_metric["loss"].item()  # the traced steps' work ends inside the trace
                    trace.close()
                    tracing = False

                global_step += 1
                sampled = eval_sampler.maybe_sample(global_step)
                if sampled:
                    print(f"eval samples at step {global_step} -> {sampled}")
                if count % interval == 0:
                    stop = time.time()
                    time_elapsed = round(stop - start, 4)
                    # an f32 value printed as a Python float, as the JAX
                    # trainer's f-string prints its f32 array
                    loss = float(sum(train_metrics) / len(train_metrics))
                    time_per_step = round(time_elapsed / interval, 4)
                    start = time.time()
                    if metrics_writer.active:
                        metrics_writer.scalar("train/loss", float(loss), global_step)
                        metrics_writer.scalar("train/step_time_s", time_per_step, global_step)
                        metrics_writer.scalar("train/chunk", config_dict["chunk_steps"], global_step)
                        # flush per logging interval: a killed run keeps its tail
                        metrics_writer.flush()
                    print(
                        f"at steps {count}, avg loss for {interval} steps: {loss},"
                        f"took {time_elapsed} second(s) or {time_per_step} second(s) per step"
                    )
                    with open(config_dict["loss_csv"], "a") as loss_file:
                        loss_file.write(
                            f"\n{count},{interval},{loss},{time_elapsed},"
                            f'{config_dict["chunk_steps"]},{config_dict["master_seed"]}'
                        )

        config_dict["model_path"] = _save_chunk_checkpoints(
            config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state,
            unet_ema_params, text_encoder_ema_params, frozen_vae, train_rng=train_rng,
        )
        config_dict["chunk_number"] += 1
        config_dict["chunk_steps"] += 1
        save_dict_to_json(config_dict, config_dict_path)

    # flush temp storage
    for flushed_batch in range(config_dict["chunk_limit"] + config_dict["numb_of_prefetched_batch"] + 1):
        dataloader.delete_prev_chunks(prev_chunk=flushed_batch)

    config_dict["master_seed"] += 1
    save_dict_to_json(config_dict, config_dict_path)
    metrics_writer.close()
