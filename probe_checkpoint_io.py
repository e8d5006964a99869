#!/usr/bin/env python3
"""Time the checkpoint writer and reader of the port on one card.

    python3 probe_checkpoint_io.py            # SD1.5 in f32: UNet, CLIP ViT-L/14, VAE

``save_model`` writes a whole SD1.5 pipeline (4.27 GB in f32) twice a chunk
and once more for its save probe, so a checkpoint's seconds are a share of
every chunk. This times, on the same seeded weights on the card:

- ``write``: ``hf_io.save_safetensors`` (device tensors through two pinned
  staging buffers) against the earlier writer (``.cpu()`` a tensor, then
  write it), in the order earlier, staged, staged, earlier; each file read
  back and held bitwise against the weights;
- ``read``: ``hf_io.load_safetensors`` (each tensor's bytes read into its
  own storage) against the earlier reader (one read into a buffer, each
  tensor copied out of it), in turn on each file;
- ``host``: what the host part of each costs alone: ``.cpu()`` of a 256 MiB
  device tensor into fresh pageable memory, a copy into pinned memory, the
  first touch of fresh pageable memory, and ``write`` of memory already
  touched.

One JSON line each, also in ``chiprun_out/probe_checkpoint_io.jsonl``; the
last line carries the card's name and power limit. The files go to
``.cache/probe_checkpoint_io/`` and are deleted.
"""

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "probe_checkpoint_io.jsonl")
WORK = os.path.join(REPO, ".cache", "probe_checkpoint_io")
CHUNK = 256 << 20


def emit(probe, **fields):
    line = json.dumps(dict(probe=probe, **fields))
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def earlier_writer(tensors, path):
    """The writer before the staging: each tensor to the host, then to the file."""
    import struct

    import torch

    from stable_diffusion_training_tpu_torch.models import hf_io

    header, offset = {}, 0
    for key, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[key] = {"dtype": hf_io._ST_NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)


def earlier_reader(path):
    """The reader before: the data read once into one buffer, each tensor
    copied out of it."""
    import struct

    import numpy as np
    import torch

    from stable_diffusion_training_tpu_torch.models import hf_io

    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = np.empty(os.fstat(f.fileno()).st_size - 8 - header_len, dtype=np.uint8)
        view, done = memoryview(data), 0
        while done < len(data):
            done += f.readinto(view[done:])
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dtype = hf_io._ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        out[key] = torch.frombuffer(data, dtype=dtype, offset=start, count=count).clone().reshape(info["shape"])
    return out


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def main():
    import numpy as np
    import torch

    from stable_diffusion_training_tpu_torch.models import configs, hf_io
    from stable_diffusion_training_tpu_torch.models.clip import CLIPTextModel
    from stable_diffusion_training_tpu_torch.models.unet import UNet2DConditionModel
    from stable_diffusion_training_tpu_torch.models.vae import AutoencoderKL

    if not torch.cuda.is_available():
        sys.exit("probe_checkpoint_io.py needs a CUDA card")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    family = configs.MODEL_FAMILIES["sd15"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    tensors = {}
    for name, cls, cfg in (("unet", UNet2DConditionModel, family["unet"]), ("vae", AutoencoderKL, family["vae"]),
                           ("text_encoder", CLIPTextModel, family["text_encoder"])):
        model = cls(**cfg, device="meta")
        for key, p in model.state_dict().items():
            tensors[f"{name}.{key}"] = torch.randn(p.shape, generator=gen, device="cuda")
        del model
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    torch.cuda.synchronize()

    writers = {"earlier": earlier_writer, "staged": hf_io.save_safetensors}
    readers = {"earlier": earlier_reader, "staged": hf_io.load_safetensors}
    for i, which in enumerate(("earlier", "staged", "staged", "earlier")):
        path = os.path.join(WORK, f"{which}_{i}.safetensors")
        seconds, _ = timed(lambda: writers[which](tensors, path))
        reads = {}
        for reader in (("earlier", "staged") if i % 2 else ("staged", "earlier")):
            reads[reader], back = timed(lambda: readers[reader](path))
            if i < 2:  # each writer's file, through each reader
                assert all(torch.equal(back[k], t.cpu()) for k, t in tensors.items()), (which, reader)
            del back
        os.remove(path)
        emit("write", writer=which, tensors=len(tensors), bytes=nbytes, s=seconds, gb_per_s=nbytes / seconds / 1e9,
             read_s=reads, read_gb_per_s={k: nbytes / v / 1e9 for k, v in reads.items()}, read_back_equal=i < 2)

    device = torch.empty(CHUNK, dtype=torch.uint8, device="cuda").random_(generator=gen)
    pinned = torch.empty(CHUNK, dtype=torch.uint8, pin_memory=True)
    reps = 8
    torch.cuda.synchronize()
    s, hosts = timed(lambda: [device.cpu() for _ in range(reps)])
    emit("host", what="cpu() into fresh pageable memory", bytes=reps * CHUNK, gb_per_s=reps * CHUNK / s / 1e9)
    del hosts

    def to_pinned():
        for _ in range(reps):
            pinned.copy_(device, non_blocking=True)
        torch.cuda.synchronize()

    s, _ = timed(to_pinned)
    emit("host", what="copy into pinned memory", bytes=reps * CHUNK, gb_per_s=reps * CHUNK / s / 1e9)
    s, touched = timed(lambda: np.ones(reps * CHUNK, dtype=np.uint8))
    emit("host", what="first touch of fresh pageable memory", bytes=reps * CHUNK, gb_per_s=reps * CHUNK / s / 1e9)
    path = os.path.join(WORK, "raw.bin")

    def write_raw():
        with open(path, "wb") as f:
            f.write(touched.data)

    s, _ = timed(write_raw)
    emit("host", what="write of touched memory", bytes=reps * CHUNK, gb_per_s=reps * CHUNK / s / 1e9)
    shutil.rmtree(WORK, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit("card", nvidia_smi=smi, device=torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
