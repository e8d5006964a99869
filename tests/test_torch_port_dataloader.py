"""The port's streaming ``DataLoader`` (``data/dataloader.py``) against the
JAX package's, on the same local chunks, seeds and tokenizer stub.

Everything here is exact: the metadata rows, the bucket plan, the
first/bulk counts, the token windows, the decoded and bucketed images and
the batches, bitwise. The decode workers seed their caption rngs with
``threading.get_ident()``, so both packages run one worker with the id
patched to one value in each module. The JAX loader reads its CSVs with
pandas, the port with the stdlib ``csv`` module: a missing caption is
compared through ``str`` (pandas 3 keeps it a float NaN, whose ``str`` is the
``"nan"`` that ``astype(str)`` gave before pandas 3).
"""

import csv
import io
import os
import shutil
import sys
import tarfile
import threading
import time
import types
import zipfile
import zlib

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from stable_diffusion_training_tpu.data import dataloader as jax_dl
from stable_diffusion_training_tpu_torch.data import dataloader as port_dl
from torch_threads import _one_thread  # noqa: F401 (the fixture)

COLUMNS = ["filepath", "caption", "width", "height", "repo_key"]


class StubTokenizer:
    """Whitespace words hashed (crc32) into a 1,000-id vocabulary, CLIP's
    special-token layout at tiny size."""

    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0
    model_max_length = 77

    def __call__(self, texts, add_special_tokens=False, **kw):
        return {"input_ids": [[3 + zlib.crc32(w.encode()) % 996 for w in t.split()] for t in texts]}


def _png(path, w, h, seed):
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)


# (width, height) of the chunk's images: landscape, portrait and square at
# 64 px, and larger ones that the 128-area tier buckets apart
SIZES = [(100, 60), (60, 100), (80, 80), (200, 64), (64, 200), (130, 128), (96, 96), (300, 90)] * 3


@pytest.fixture(scope="module")
def ramdisk(tmp_path_factory):
    """A local chunk: seeded PNGs and a metadata CSV under
    ``chunk_0/repo_0`` (a repo entry without ``name``)."""
    root = tmp_path_factory.mktemp("ramdisk")
    repo_dir = root / "chunk_0" / "repo_0"
    os.makedirs(repo_dir)
    rows = []
    for i, (w, h) in enumerate(SIZES):
        _png(repo_dir / f"img_{i}.png", w, h, i)
        tags = ", ".join(f"tag{(i * 7 + k) % 11}" for k in range(2 + i % 5))
        rows.append([f"img_{i}.png", f"photo {i}, {tags}", w, h])
    with open(repo_dir / "meta.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["file", "text", "w", "h"])
        writer.writerows(rows)
    return str(root)


REPO_CFG = {
    "filename_col": "file", "caption_col": "text", "image_width_col_name": "w",
    "image_height_col_name": "h", "coma_separated_shuffle": True, "max_tag_count": 4,
    "drop_caption_ratio": 0.75,
}


def _loader(module, ramdisk, repo_cfg=None, workers=1, **kw):
    args = dict(
        tokenizer_obj=StubTokenizer(),
        config={"repo": {"repo_0": dict(REPO_CFG if repo_cfg is None else repo_cfg)}, "token": None},
        ramdisk_path=ramdisk, training_batch_size=2, repeat_batch=2,
        maximum_resolution_areas=[64**2, 128**2], bucket_lower_bound_resolutions=[64, 64],
        numb_of_worker_thread=workers, queue_get_timeout=5, chunk_number=0, seed=3,
        context_concatenation_multiplier=3,
    )
    args.update(kw)
    loader = module.DataLoader(**args)
    loader._print_debug = False
    return loader


@pytest.fixture
def one_thread_id(monkeypatch):
    """Each package's worker rng seeded from the same thread id."""
    for module in (jax_dl, port_dl):
        fake = types.SimpleNamespace(**{k: getattr(threading, k) for k in ("Thread", "Lock", "Event")})
        fake.get_ident = lambda: 1234567
        monkeypatch.setattr(module, "threading", fake)


def _drain(loader, limit=60.0):
    batches, deadline = [], time.monotonic() + limit
    while time.monotonic() < deadline:
        b = loader.grab_next_batch()
        if isinstance(b, str):
            assert b == "end_of_batch"
            return batches
        if b is not None:
            batches.append(b)
    raise AssertionError("the loader did not end")


def _jax_rows(frame):
    return [{k: row[k] for k in COLUMNS} for _, row in frame.iterrows()]


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_tokenize_concat_windows_matches_jax():
    tok = StubTokenizer()
    captions = ["hello world", "", "a " * 300, " ".join(f"w{i}" for i in range(150))]
    for concat in (1, 3):
        got = port_dl.tokenize_concat_windows(tok, captions, 77, concat)
        want = jax_dl.tokenize_concat_windows(tok, captions, 77, concat)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("bucket", [(64, 64), (128, 64), (64, 192), (128, 128)])
def test_load_and_bucket_image_matches_jax(ramdisk, bucket):
    for i in range(8):
        path = os.path.join(ramdisk, "chunk_0", "repo_0", f"img_{i}.png")
        got, want = port_dl.load_and_bucket_image(path, bucket), jax_dl.load_and_bucket_image(path, bucket)
        assert got.shape == (3, bucket[1], bucket[0]) and got.dtype == np.float32
        assert np.array_equal(got, want), path
    assert port_dl.load_and_bucket_image(os.path.join(ramdisk, "missing.png"), bucket) is None


@pytest.mark.parametrize(
    "mode,shuffle,max_tags,ratio",
    [("tags", True, None, 0.5), ("tags", True, 3, None), ("tags", False, None, 0.5),
     ("whole", False, None, 0.3), ("whole", True, 2, 0.3), ("whole", True, None, 0.0)],
)
def test_shuffle_and_drop_tags_matches_jax(mode, shuffle, max_tags, ratio):
    """Both modes, given the same ``np.random.Generator``: the same captions
    and the same draws taken from it."""
    caption = ", ".join(f"tag{i}" for i in range(10))
    rng_port, rng_jax = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(50):
        got = port_dl._shuffle_and_drop_tags(caption, rng_port, shuffle, max_tags, ratio, mode)
        want = jax_dl._shuffle_and_drop_tags(caption, rng_jax, shuffle, max_tags, ratio, mode)
        assert got == want
    assert rng_port.random() == rng_jax.random()
    with pytest.raises(ValueError, match="caption_drop_mode"):
        port_dl._shuffle_and_drop_tags("a", rng_port, True, None, 0.5, "caption")


def test_full_protocol_matches_jax(ramdisk, one_thread_id):
    """One worker on each side over the same chunk: the same rows, bucket
    plan, counts and batches, bitwise; then ``end_of_batch``."""
    jax_loader, port = _loader(jax_dl, ramdisk), _loader(port_dl, ramdisk)
    for loader in (jax_loader, port):
        loader.grab_and_prefetch_chunk(numb_of_prefetched_batch=0)
        loader.prepare_training_dataframe()
        loader.create_training_dataframe()
    assert port._dataframe == _jax_rows(jax_loader._dataframe) and len(port._dataframe) == len(SIZES)
    assert port._batches == jax_loader._batches
    assert len({tuple(b["resolution"]) for b in port._batches}) >= 3  # several buckets
    assert (port._first_batch_count, port._bulk_batch_count) == (
        jax_loader._first_batch_count, jax_loader._bulk_batch_count)
    for loader in (jax_loader, port):
        loader.dispatch_worker()
    _assert_same_batches(_drain(port), _drain(jax_loader))
    assert port.grab_next_batch() == "end_of_batch"


def test_metadata_csv_reads_as_pandas_does(tmp_path):
    """Missing captions (empty, ``NA``, ``None``, ``nan``) are ``"nan"``; a
    numeric filename column loses its zeros; a float width is cut to int;
    quoted commas and newlines stay in their cell; blank lines are skipped.
    Row for row ``str``-equal to the JAX package's pandas table."""
    repo_dir = tmp_path / "chunk_0" / "repo_0"
    os.makedirs(repo_dir)
    with open(repo_dir / "a.csv", "w") as f:
        f.write('filename,caption,image_width,image_height\n'
                '001,,64,64\n002,NA,64.0,64\n\n003,"tag a, tag b",128,64\n'
                '004,None,64,128\n005,"two\nlines",64,64\n006,nan,64,64\n')
    with open(repo_dir / "b.csv", "w") as f:
        f.write('filename,caption,image_width,image_height\nx.png,1.50,64,64\ny.png,,64,64\n')
    repo_cfg = {"repo_0": {}}
    port = _loader(port_dl, str(tmp_path), repo_cfg={})
    jax_loader = _loader(jax_dl, str(tmp_path), repo_cfg={})
    port.config["repo"] = jax_loader.config["repo"] = repo_cfg
    port.prepare_training_dataframe()
    jax_loader.prepare_training_dataframe()
    want = _jax_rows(jax_loader._dataframe)
    assert len(port._dataframe) == len(want) == 8
    for got, row in zip(port._dataframe, want):
        assert {k: str(v) for k, v in got.items()} == {k: str(v) for k, v in row.items()}
        assert isinstance(got["caption"], str) and isinstance(got["width"], int)
    by_name = {os.path.basename(r["filepath"]): r for r in port._dataframe}
    assert by_name["1"]["caption"] == by_name["2"]["caption"] == by_name["y.png"]["caption"] == "nan"
    assert by_name["2"]["width"] == 64 and by_name["x.png"]["caption"] == "1.5"
    assert by_name["3"]["caption"] == "tag a, tag b" and by_name["5"]["caption"] == "two\nlines"


def test_plan_and_batches_split_across_processes_as_jax(ramdisk, one_thread_id):
    """``process_count=2``: both packages give each process the same plan
    and the same half of every batch, in plan order (two workers each, so
    captions are left unshuffled: which worker's rng takes a batch is a
    race)."""
    repo_cfg = dict(REPO_CFG, coma_separated_shuffle=False, drop_caption_ratio=None)
    for index in (0, 1):
        loaders = [_loader(m, ramdisk, repo_cfg, process_index=index, process_count=2, workers=2)
                   for m in (jax_dl, port_dl)]
        for loader in loaders:
            loader.prepare_training_dataframe()
            loader.create_training_dataframe()
            loader.dispatch_worker()
        jax_batches, port_batches = (_drain(loader) for loader in loaders)
        assert loaders[1]._batches == loaders[0]._batches
        assert all(b["pixel_values"].shape[0] == 1 for b in port_batches)
        _assert_same_batches(port_batches, jax_batches)


def test_multiprocess_emission_is_plan_ordered(tmp_path, monkeypatch):
    """Racing workers (earlier rows decode slower) still release batches in
    plan order with ``process_count > 1``, and a failed decode becomes a
    blank image instead of a skipped batch (``tests/test_dataloader.py``'s
    check of the JAX loader)."""

    class IndexTok(StubTokenizer):
        def __call__(self, captions, add_special_tokens=False, **kw):
            return {"input_ids": [[int(c[1:]) + 10] * 3 for c in captions]}

    rows = []
    for i in range(16):
        path = tmp_path / f"{i}.png"
        Image.new("RGB", (64, 64), (i * 10 % 255, 0, 0)).save(path)
        rows.append({"filepath": str(path), "caption": f"c{i}", "width": 64, "height": 64, "repo_key": "r"})
    rows[2]["filepath"] = str(tmp_path / "missing.png")
    real_load = port_dl.load_and_bucket_image

    def slow_early_loads(path, wh):
        name = os.path.basename(path).split(".")[0]
        time.sleep(0.05 * max(0, 8 - (int(name) if name.isdigit() else 0)) / 8)
        return real_load(path, wh)

    monkeypatch.setattr(port_dl, "load_and_bucket_image", slow_early_loads)
    loader = _loader(port_dl, str(tmp_path / "rd"), repo_cfg={}, training_batch_size=4, repeat_batch=1,
                     maximum_resolution_areas=[64**2], bucket_lower_bound_resolutions=[64], workers=4,
                     process_count=2)
    loader.tokenizer = IndexTok()
    loader._dataframe = rows
    loader.create_training_dataframe()
    plan = [item["indices"][:2] for item in loader._batches]
    loader.dispatch_worker()
    emitted = [[int(t) - 10 for t in b["input_ids"].reshape(2, 3, -1)[:, 0, 1]] for b in _drain(loader)]
    assert emitted == [list(s) for s in plan] and len(plan) == 4


def test_many_workers_deliver_every_batch_once(tmp_path):
    """Twice as many decode threads as this box has cores, a short switch
    interval: every planned batch comes out once, each image in it once,
    and the loader ends (the outstanding count is not lost to a race)."""

    class IndexTok(StubTokenizer):
        def __call__(self, captions, add_special_tokens=False, **kw):
            return {"input_ids": [[int(c[1:]) + 10] for c in captions]}

    rows = []
    for i in range(64):
        path = tmp_path / f"{i}.png"
        Image.new("RGB", (64, 64), (i * 3, 0, 0)).save(path)
        rows.append({"filepath": str(path), "caption": f"c{i}", "width": 64, "height": 64, "repo_key": "r"})
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        loader = _loader(port_dl, str(tmp_path / "rd"), repo_cfg={}, repeat_batch=1, queue_max_size=4,
                         maximum_resolution_areas=[64**2], bucket_lower_bound_resolutions=[64],
                         workers=2 * (os.cpu_count() or 4))
        loader.tokenizer = IndexTok()
        loader._dataframe = rows
        loader.create_training_dataframe()
        loader.dispatch_worker()
        batches = _drain(loader)
    finally:
        sys.setswitchinterval(switch)
    seen = sorted(int(t) - 10 for b in batches for t in b["input_ids"][:, 1])
    assert len(batches) == 32 and seen == list(range(64))
    for t in loader._workers:
        t.join(timeout=10)
        assert not t.is_alive()


def test_first_and_bulk_counts_match_jax(tmp_path):
    """16 rows in one bucket, batch 2, ``repeat_batch`` 3: the first group
    counts 3, the rest 5, on both sides, with the same plan."""
    rows = [{"filepath": f"/nonexistent/{i}.png", "caption": "cap", "width": 64, "height": 64,
             "repo_key": "repo_0"} for i in range(16)]
    loaders = []
    for module, frame in ((jax_dl, pd.DataFrame(rows)), (port_dl, rows)):
        loader = _loader(module, str(tmp_path / "rd"), repo_cfg={}, repeat_batch=3,
                         maximum_resolution_areas=[64**2], bucket_lower_bound_resolutions=[64])
        loader._dataframe = frame
        loader.create_training_dataframe()
        loaders.append(loader)
    assert (loaders[1]._first_batch_count, loaders[1]._bulk_batch_count) == (3, 5)
    assert loaders[1]._batches == loaders[0]._batches


def _zip_bytes(files):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, data in files.items():
            zf.writestr(name, data)
    return buf.getvalue()


def _tar_bytes(files):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _png_bytes(w, h, seed):
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture
def fake_hub(tmp_path, monkeypatch):
    """``huggingface_hub.hf_hub_download`` stubbed to serve staged files
    (FileNotFoundError for the rest), as ``tests/test_hub_fetch.py`` stubs it."""
    hub_dir = tmp_path / "hub"

    def stage(repo_id, filename, data):
        path = hub_dir / repo_id.replace("/", "__") / filename
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)

    def fake_download(repo_id, filename, repo_type=None, token=None):
        path = hub_dir / repo_id.replace("/", "__") / filename
        if not path.exists():
            raise FileNotFoundError(f"{repo_id}/{filename} not staged")
        return str(path)

    import huggingface_hub

    monkeypatch.setattr(huggingface_hub, "hf_hub_download", fake_download)
    return stage


@pytest.mark.parametrize("archive", ["zip", "tar"])
def test_hub_fetch_matches_jax(tmp_path, fake_hub, one_thread_id, archive):
    """A chunk served by the stubbed hub (an archive and its CSV with the
    repo's own column names, the chunk index wrapped by
    ``total_file_count``): both packages extract it and give the same rows
    and batches."""
    files = {f"img_{i}.png": _png_bytes(80 + 8 * i, 64, i) for i in range(4)}
    pack = _zip_bytes if archive == "zip" else _tar_bytes
    fake_hub("org/data", "chunks/pre-1." + archive, pack(files))
    table = io.StringIO()
    csv.writer(table).writerows([["file_name", "tags", "w_px", "h_px"]] + [
        [name, f"tag a, tag b, caption {i}", 80 + 8 * i, 64] for i, name in enumerate(files)])
    fake_hub("org/data", "chunks/pre-1.csv", table.getvalue().encode())
    repo_cfg = {"name": "org/data", "prefix": "pre-", "total_file_count": 3, "folder_path_in_repo": "chunks",
                "filename_col": "file_name", "caption_col": "tags", "image_width_col_name": "w_px",
                "image_height_col_name": "h_px", "coma_separated_shuffle": True, "max_tag_count": 2}
    batches, rows = [], []
    for module in (jax_dl, port_dl):
        loader = _loader(module, str(tmp_path / f"rd_{module.__name__}"), repo_cfg=repo_cfg, chunk_number=4)
        loader.grab_and_prefetch_chunk(numb_of_prefetched_batch=0)
        loader.prepare_training_dataframe()
        loader.create_training_dataframe()
        loader.dispatch_worker()
        batches.append(_drain(loader))
        frame = loader._dataframe
        rows.append([{**r, "filepath": os.path.relpath(r["filepath"], loader.ramdisk_path)}
                     for r in (_jax_rows(frame) if module is jax_dl else frame)])
    assert rows[1] == rows[0] and len(rows[1]) == 4
    _assert_same_batches(batches[1], batches[0])


def test_missing_hub_repo_warns(tmp_path, fake_hub, capsys):
    loader = _loader(port_dl, str(tmp_path / "rd"), repo_cfg={"name": "org/nothing", "prefix": "x"})
    loader._fetch_one_chunk(0)
    out = capsys.readouterr().out
    assert "WARNING" in out and "org/nothing" in out and "x0.zip" in out


def test_local_repo_needs_no_hub_package(tmp_path, monkeypatch):
    """A repo without ``name`` is read from the chunk directory: the fetch
    imports no ``huggingface_hub``."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # any import of it raises
    loader = _loader(port_dl, str(tmp_path / "rd"))
    loader.grab_and_prefetch_chunk(numb_of_prefetched_batch=1)
    assert os.path.isdir(loader._chunk_dir(0))


@pytest.mark.parametrize("archive", ["zip", "tar"])
def test_archive_path_traversal_rejected(tmp_path, fake_hub, archive):
    """A member escaping the extraction directory stops the fetch, as in
    the JAX loader: the zip guard's ValueError, tar's "data" filter."""
    pack = _zip_bytes if archive == "zip" else _tar_bytes
    fake_hub("org/evil", "e0." + archive, pack({"../evil.txt": b"pwned"}))
    loader = _loader(port_dl, str(tmp_path / "rd"), repo_cfg={"name": "org/evil", "prefix": "e"})
    expected = ValueError if archive == "zip" else tarfile.FilterError
    with pytest.raises(expected):
        loader._fetch_one_chunk(0)
    assert not (tmp_path / "rd" / "evil.txt").exists() and not (tmp_path / "evil.txt").exists()


def test_delete_prev_chunks(tmp_path):
    loader = _loader(port_dl, str(tmp_path))
    victim = os.path.join(str(tmp_path), "chunk_9")
    os.makedirs(victim)
    loader.delete_prev_chunks(9)
    assert not os.path.exists(victim)
    shutil.rmtree(str(tmp_path), ignore_errors=True)
