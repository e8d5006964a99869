"""The checkpoint byte path: ``utils.staging`` (device bytes through two
pinned buffers, in order) and ``hf_io``'s safetensors writer and reader.

On the CPU no tensor is on a card, so the staging buffers' order is driven
here with a stand-in for the CUDA event and stream calls and buffers of a
few bytes; the card runs the same code in ``probe_checkpoint_io.py``.
"""

import io
import json
import struct

import numpy as np
import pytest
import torch

from stable_diffusion_training_tpu_torch.models import hf_io
from stable_diffusion_training_tpu_torch.utils import staging
from torch_threads import _one_thread  # noqa: F401 (the fixture)


class _Event:
    def record(self, stream):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def small_stage(monkeypatch):
    """Buffers of 10 bytes, unpinned, events that are ready at once."""
    empty = torch.empty
    monkeypatch.setattr(staging, "STAGE_BYTES", 10)
    monkeypatch.setattr(staging.torch.cuda, "Event", _Event)
    monkeypatch.setattr(staging.torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(staging.torch, "empty", lambda *a, pin_memory=False, **k: empty(*a, **k))


class _OnCard(torch.Tensor):
    """A host tensor that ``stream_bytes`` takes for a device tensor."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("seed", range(4))
def test_staged_bytes_reach_the_sink_in_order(small_stage, seed):
    """Tensors of other dtypes and shapes, shorter than, as long as and
    longer than a buffer, some through the buffers and some (host tensors,
    which flush the buffers first) straight to the sink: their bytes come
    out whole and in order."""
    rng = np.random.default_rng(seed)
    tensors = []
    for _ in range(12):
        n = int(rng.choice([1, 3, 9, 10, 11, 20, 27]))
        t = torch.from_numpy(rng.integers(0, 256, 4 * n, dtype=np.uint8)).view(torch.float32)
        t = t.reshape(n, 1) if rng.random() < 0.5 else t
        tensors.append(t if rng.random() < 0.25 else t.as_subclass(_OnCard))
    out = io.BytesIO()
    staging.stream_bytes(tensors, out.write)
    assert out.getvalue() == b"".join(t.numpy().tobytes() for t in (x.as_subclass(torch.Tensor) for x in tensors))


def test_safetensors_round_trip(tmp_path):
    """Every dtype, an empty and a 0-d tensor, a cast on the way out:
    written, read back bitwise, in the format's layout."""
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=gen),
        "bf16": torch.randn(7, generator=gen).to(torch.bfloat16),
        "i8": torch.randint(-128, 127, (2, 3), generator=gen, dtype=torch.int8),
        "bool": torch.rand(5, generator=gen) > 0.5,
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "t.safetensors")
    hf_io.save_safetensors(tensors, path, metadata={"format": "pt"})
    back = hf_io.load_safetensors(path)
    assert list(back) == list(tensors)
    for key, t in tensors.items():
        assert back[key].dtype == t.dtype and torch.equal(back[key], t), key
    hf_io.save_safetensors({"x": tensors["bf16"]}, path, dtype=torch.float32)
    assert torch.equal(hf_io.load_safetensors(path)["x"], tensors["bf16"].float())


def test_safetensors_reader_refuses_bad_offsets(tmp_path):
    """A tensor whose byte range does not match its shape, or runs past the
    file, is refused."""
    path = str(tmp_path / "t.safetensors")
    hf_io.save_safetensors({"x": torch.arange(4, dtype=torch.float32)}, path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header, data = json.loads(f.read(n)), f.read()
    for offsets, message in (([0, 12], "holds 12 bytes"), ([0, 20], "lies outside the file")):
        header["x"]["data_offsets"] = offsets
        blob = json.dumps(header).encode()
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(blob)) + blob + data)
        with pytest.raises(ValueError, match=message):
            hf_io.load_safetensors(path)
