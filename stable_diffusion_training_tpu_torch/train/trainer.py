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

Data parallelism, FSDP and tensor parallelism: under ``torchrun
--nproc_per_node=N`` (or in a process group the caller started) every rank
runs ``main``: one process per card, on the config's ``mesh_shape`` (``[D,
F, T]``: ``data_parallel``, ``fsdp``, ``model_parallel``; by default every
rank on the data axis), ``batch_size`` the global batch, split over the
data x fsdp ranks (the T ranks of a row block take the same rows). With
``fsdp_shard_params`` the UNet and the text encoder are sharded over the
``fsdp`` axis (FSDP2, ``train/states.py``); with
``tensor_parallel_shard_params`` their attention and CLIP projections are
split over the ``model_parallel`` axis, and every rank samples the evals.
Before each chunk's checkpoint the ranks of a ``model_parallel`` axis above
1 are checked to hold the same params of every leaf that is not split
(``parallel.assert_replicated``; the train step gives them one rank's
grads). The streaming loader gives each
rank its rows of each batch of one plan (``core.distributed.batch_shard``);
an injected loader yields the rank's own rows
(``core.slice_batch_for_process``). A host's first rank alone fetches and
deletes the chunks of the ramdisk the host's ranks share, and rank 0 alone
writes the JSON state, ``loss.csv``, the save probe, the checkpoints and
their rotation, the eval images, TensorBoard events and the trace; every
rank calls the saves (under FSDP or TP each first gathers its shards), the others
wait, and a failure on one rank stops every rank. The ranks agree on every
step before it runs: a rank whose queue timed out grabs again while the
others hold their batch, so no rank steps or skips alone.
"""

import contextlib
import os
import sys
import time
from collections import deque
from typing import Any, Optional

import torch

from ..core.distributed import (
    agree_min,
    batch_shard,
    initialize_distributed,
    local_process_index,
    process_count,
    process_index,
    put_local_batch,
    rank_device,
    run_on,
)
from ..core.mesh import AXIS_DATA, AXIS_TENSOR, axis_size, create_mesh
from ..parallel import assert_replicated
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
    run_on(process_index() == 0, save_dict_to_json, config_dict, os.path.join(directory, f"backup_{name}"))
    if len(config_dict["image_area_root"]) != len(config_dict["minimum_axis_length"]):
        raise ValueError(
            "number of elements in image_area_root and minimum_axis_length is not "
            "match! check your config files!"
        )
    return config_dict, training_config_from_dict(config_dict)


def _build_dataloader(config_dict, config_dict_path, tokenizer, mesh=None):
    """The streaming loader of the config's repos, chunk and seed, giving
    this process its rows of each batch (its block of the data x fsdp
    ranks)."""
    from ..data import DataLoader

    index, count = batch_shard(mesh)
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
        process_index=index,
        process_count=count,
    )


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
        return put_local_batch(b, device)

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
    run_on(process_index() == 0, _delete_all, probe_path, f"{probe_path}-EMA")


def _delete_all(*paths) -> None:
    for path in paths:
        delete_file_or_folder(path)


def _assert_replicas_alike(mesh, *states) -> None:
    """Raise unless the ``model_parallel`` ranks of each row block hold the
    same params of every leaf that no plan splits over that axis (the train
    step gives them one rank's grads; under FSDP their local shards);
    nothing without such an axis."""
    if axis_size(mesh, AXIS_TENSOR) <= 1:
        return
    whole = [p for s in states for name, p in s.params.items() if s.plan is None or name not in s.plan.tp_names]
    assert_replicated(whole, "the model_parallel ranks' whole leaves", mesh, AXIS_TENSOR)


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
    run_on(process_index() == 0, delete_file_or_folder, f"{base}@{steps - keep}")

    if config_dict["ema_rate"]:
        save_model(
            model_object_dict=model_object_dict, tokenizer_object=tokenizer,
            unet_params=_ema_or_params(config_dict, "accumulate_unet_ema", unet_ema_params, unet_state),
            text_encoder_params=_ema_or_params(
                config_dict, "accumulate_text_encoder_ema", text_encoder_ema_params, text_encoder_state
            ),
            vae_params=frozen_vae.params, output_dir=f"{base}-EMA@{steps}",
        )
        run_on(process_index() == 0, delete_file_or_folder, f"{base}-EMA@{steps - keep}")

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
    mesh=None,
) -> None:
    """Run ``chunk_limit`` chunks of training from the JSON config at
    ``config_dict_path`` on ``device`` (the rank's card unless told
    otherwise), with ``dataloader`` (None: the streaming ``DataLoader``
    built from the config; or an ``InMemoryDataLoader``, a
    ``CachedLatentLoader`` or anything with their protocol, yielding this
    rank's rows). In a process group (torchrun's environment, or one the
    caller started) the ranks train over ``mesh``, by default the config's
    ``mesh_shape`` or every rank on the data axis: data-parallel, with the
    models sharded over its ``fsdp`` axis (``fsdp_shard_params``), or with
    their projections split over its ``model_parallel`` axis
    (``tensor_parallel_shard_params``)."""
    group = initialize_distributed(device=device)  # None: one process, nothing to join
    config_dict, training_config = load_run_config(config_dict_path)

    if tokenizer is None:
        tok_dir = os.path.join(config_dict["model_path"], "tokenizer")
        if os.path.isdir(tok_dir):
            from transformers import CLIPTokenizer

            tokenizer = CLIPTokenizer.from_pretrained(config_dict["model_path"], subfolder="tokenizer")

    if mesh is None and group is not None:
        device = rank_device(device)
        axes = training_config.mesh_axes() or {AXIS_DATA: process_count(), AXIS_TENSOR: 1}
        mesh = create_mesh(tuple(axes.values()), tuple(axes), device_type=device.type)
    if dataloader is None:
        # this rank's row block of the mesh (the model_parallel ranks of a block read the same rows)
        dataloader = _build_dataloader(config_dict, config_dict_path, tokenizer, mesh)
    device = rank_device(device)
    leader = process_index() == 0  # writes the run's files
    ramdisk_leader = local_process_index() == 0  # fetches and deletes the host's chunks

    if not config_dict["DEBUG"]:
        dataloader._print_debug = False

    # the same seed on every rank: each keeps its rows of the global draws
    train_rng = torch.Generator(device=device).manual_seed(config_dict["master_seed"])
    (
        unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params,
        frozen_vae, frozen_schedulers, model_object_dict,
    ) = on_device_model_training_state(training_config, device=device, mesh=mesh)
    unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params, train_rng = (
        _maybe_restore_full_state(
            config_dict, unet_state, text_encoder_state, unet_ema_params, text_encoder_ema_params, train_rng,
        )
    )
    train_step_funcs = bucket_train_steps(training_config, frozen_vae, mesh=mesh)

    if config_dict["DEBUG"]:
        # careful: this mutates the persisted json states, as in the reference
        config_dict["loss_logging_interval"] //= 10
    if leader and not os.path.isfile(config_dict["loss_csv"]):
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
        run_on(ramdisk_leader, dataloader.delete_prev_chunks, prev_chunk=config_dict["chunk_number"] - 1)
        if config_dict["chunk_number"] >= config_dict["chunk_limit"]:
            run_on(ramdisk_leader, dataloader.delete_prev_chunks, prev_chunk=config_dict["chunk_number"])
            config_dict["chunk_number"] = 0
        dataloader.chunk_number = config_dict["chunk_number"]
        run_on(
            ramdisk_leader, dataloader.grab_and_prefetch_chunk,
            numb_of_prefetched_batch=config_dict["numb_of_prefetched_batch"],
        )
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
            count, held = -1, None  # the stream's index of the held item
            while True:
                if held is None:
                    held = next(batch_stream, "end_of_batch")
                    count += 1
                # every rank steps, or none: "end_of_batch" anywhere ends the
                # chunk; a None (a queue timeout) has that rank grab again
                # while the others hold their batch
                agreed = agree_min(0 if isinstance(held, str) else 1 if held is None else 2)
                if agreed == 0:
                    break
                if agreed == 1:
                    continue
                current_batch, held = held, None

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
                if leader and count % interval == 0:
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

        _assert_replicas_alike(mesh, unet_state, text_encoder_state)
        config_dict["model_path"] = _save_chunk_checkpoints(
            config_dict, model_object_dict, tokenizer, unet_state, text_encoder_state,
            unet_ema_params, text_encoder_ema_params, frozen_vae, train_rng=train_rng,
        )
        config_dict["chunk_number"] += 1
        config_dict["chunk_steps"] += 1
        run_on(leader, save_dict_to_json, config_dict, config_dict_path)

    # flush temp storage
    for flushed_batch in range(config_dict["chunk_limit"] + config_dict["numb_of_prefetched_batch"] + 1):
        run_on(ramdisk_leader, dataloader.delete_prev_chunks, prev_chunk=flushed_batch)

    config_dict["master_seed"] += 1
    run_on(leader, save_dict_to_json, config_dict, config_dict_path)
    metrics_writer.close()
