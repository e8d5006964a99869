"""The streaming chunked data loader.

Port of ``stable_diffusion_training_tpu/data/dataloader.py``: a chunk of
each Hub repo fetched to the ramdisk (zip or tar archives extracted with a
path-traversal guard, and their CSVs), aspect-ratio bucket assignment (the
grid of ``train.aot``), caption tag shuffle and drop, N x 77 window
tokenization, decode workers on threads filling a bounded queue, and the
``grab_next_batch`` protocol: a batch, ``None`` (a timeout) or
``"end_of_batch"``.

The loader is host-only: numpy, PIL and threads, so it launches nothing on
the card; it yields numpy batches, and the trainer's ``_prefetch_to_device``
copies them from pinned memory. The metadata table is a list of row dicts
read with the stdlib ``csv`` module, not pandas, holding the values
``pandas.read_csv`` and the JAX package's ``astype`` calls give: a cell that
pandas reads as missing (empty, ``NA``, ``nan``, ``None``...) becomes the
caption ``"nan"`` (what ``astype(str)`` made of it before pandas 3, which
keeps it a float NaN whose ``str`` is ``"nan"``), and a column whose every
cell is a number is read as numbers before it is turned back into text
(``"001"`` -> ``"1"``).
``huggingface_hub`` is imported only to fetch a repo that has a ``name``.
"""

import csv
import os
import queue
import shutil
import tarfile
import threading
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.json_io import delete_file_or_folder, read_json_file
from .buckets import assign_bucket, calculate_resolution_array

# the cells ``pandas.read_csv`` reads as missing by default
_NA_CELLS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _as_int(cell: str) -> Optional[int]:
    try:
        return int(cell)
    except ValueError:
        return None


def _as_float(cell: str) -> Optional[float]:
    try:
        return float(cell)
    except ValueError:
        return None


def _pandas_text(cells: Sequence[str]) -> List[str]:
    """A CSV column as ``pandas.read_csv(...)[col].astype(str)`` gives it:
    missing cells are ``"nan"``; an all-integer column is read as int64 (or
    float64 when a cell is missing) and an all-number column as float64,
    then printed."""
    present = [c for c in cells if c not in _NA_CELLS]
    if present and all(_as_int(c) is not None for c in present):
        if len(present) == len(cells):
            return [str(int(c)) for c in cells]
        return ["nan" if c in _NA_CELLS else str(float(int(c))) for c in cells]
    if present and all(_as_float(c) is not None for c in present):
        return ["nan" if c in _NA_CELLS else str(float(c)) for c in cells]
    return ["nan" if c in _NA_CELLS else c for c in cells]


def _pandas_int(cells: Sequence[str]) -> List[int]:
    """A CSV column as ``pandas.read_csv(...)[col].astype(int)`` gives it."""
    return [int(c) if _as_int(c) is not None else int(float(c)) for c in cells]


def read_metadata_csv(csv_path: str, repo_dir: str, repo_key: str, repo_cfg: dict) -> List[dict]:
    """The rows of one metadata CSV: ``filepath`` (the file name under
    ``repo_dir``), ``caption``, ``width``, ``height`` and ``repo_key``, from
    the columns the repo's config names."""
    with open(csv_path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]  # pandas skips blank lines
    header, body = rows[0], rows[1:]

    def column(name):
        i = header.index(name)
        return [r[i] if i < len(r) else "" for r in body]

    names = _pandas_text(column(repo_cfg.get("filename_col", "filename")))
    captions = _pandas_text(column(repo_cfg.get("caption_col", "caption")))
    widths = _pandas_int(column(repo_cfg.get("image_width_col_name", "image_width")))
    heights = _pandas_int(column(repo_cfg.get("image_height_col_name", "image_height")))
    return [
        {"filepath": os.path.join(repo_dir, n), "caption": c, "width": w, "height": h, "repo_key": repo_key}
        for n, c, w, h in zip(names, captions, widths, heights)
    ]


def _shuffle_and_drop_tags(
    caption: str,
    rng: np.random.Generator,
    coma_separated_shuffle: bool,
    max_tag_count: Optional[int],
    drop_caption_ratio: Optional[float],
    caption_drop_mode: str = "tags",
) -> str:
    """Caption augmentation. ``drop_caption_ratio`` means what the repo's
    ``caption_drop_mode`` says:

    - ``"tags"`` (default): keep that FRACTION of the shuffled
      comma-separated tags (requires ``coma_separated_shuffle``);
    - ``"whole"``: drop the ENTIRE caption with that PROBABILITY (the
      classifier-free-guidance unconditional-training convention).
    """
    if caption_drop_mode == "whole":
        if drop_caption_ratio and rng.random() < float(drop_caption_ratio):
            return ""
    elif caption_drop_mode != "tags":
        raise ValueError(f"caption_drop_mode must be 'tags' or 'whole', got {caption_drop_mode!r}")
    if not coma_separated_shuffle:
        return caption
    tags = [t.strip() for t in caption.split(",") if t.strip()]
    rng.shuffle(tags)
    if drop_caption_ratio and caption_drop_mode == "tags":
        keep = max(1, int(round(len(tags) * float(drop_caption_ratio))))
        tags = tags[:keep]
    if max_tag_count:
        tags = tags[: int(max_tag_count)]
    return ", ".join(tags)


def tokenize_concat_windows(
    tokenizer,
    captions: Sequence[str],
    context_window: int = 77,
    concat_count: int = 3,
) -> Dict[str, np.ndarray]:
    """Tokenize long captions into ``concat_count`` BOS/EOS-wrapped windows.

    Each window carries its own BOS/EOS (the train step strips the inner
    ones back out). Content capacity is ``(context_window - 2) *
    concat_count`` tokens."""
    bos = tokenizer.bos_token_id
    eos = tokenizer.eos_token_id
    pad = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else eos
    content_len = context_window - 2

    ids_out = np.full((len(captions), concat_count * context_window), pad, dtype=np.int32)
    mask_out = np.zeros_like(ids_out)

    encoded = tokenizer(list(captions), add_special_tokens=False)["input_ids"]
    for row, content in enumerate(encoded):
        content = content[: content_len * concat_count]
        for win in range(concat_count):
            chunk = content[win * content_len : (win + 1) * content_len]
            window = [bos] + list(chunk) + [eos]
            window += [pad] * (context_window - len(window))
            start = win * context_window
            ids_out[row, start : start + context_window] = window
            mask_out[row, start : start + len(chunk) + 2] = 1
    return {"input_ids": ids_out, "attention_mask": mask_out}


def load_and_bucket_image(path: str, bucket_wh) -> Optional[np.ndarray]:
    """Decode, resize (preserving aspect, bicubic), center-crop to the
    bucket, and normalize to [-1, 1]; returns CHW float32, or None when the
    file does not decode."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            im = im.convert("RGB")
            bw, bh = int(bucket_wh[0]), int(bucket_wh[1])
            scale = max(bw / im.width, bh / im.height)
            new_w = max(bw, int(round(im.width * scale)))
            new_h = max(bh, int(round(im.height * scale)))
            im = im.resize((new_w, new_h), Image.BICUBIC)
            left = (new_w - bw) // 2
            top = (new_h - bh) // 2
            im = im.crop((left, top, left + bw, top + bh))
            arr = np.asarray(im, dtype=np.float32) / 127.5 - 1.0
            return arr.transpose(2, 0, 1)  # HWC -> CHW
    except Exception:  # any file that does not decode is dropped, as the JAX loader drops it
        return None


class DataLoader:
    """Chunked Hub dataset loader with aspect-ratio bucketing; the JAX
    package's constructor and protocol."""

    def __init__(
        self,
        tokenizer_obj,
        config,
        ramdisk_path: str,
        training_batch_size: int,
        repeat_batch: int,
        maximum_resolution_areas: Sequence[int],
        bucket_lower_bound_resolutions: Sequence[int],
        numb_of_worker_thread: int = 4,
        queue_get_timeout: float = 60.0,
        chunk_number: int = 0,
        seed: int = 0,
        context_concatenation_multiplier: int = 3,
        context_window: int = 77,
        queue_max_size: int = 32,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.tokenizer = tokenizer_obj
        self.config = read_json_file(config) if isinstance(config, str) else dict(config)
        self.ramdisk_path = ramdisk_path
        self.batch_size = training_batch_size
        self.repeat_batch = repeat_batch
        self.max_res_areas = list(maximum_resolution_areas)
        self.bucket_lower_bounds = list(bucket_lower_bound_resolutions)
        self.num_workers = numb_of_worker_thread
        self.queue_get_timeout = queue_get_timeout
        self.chunk_number = chunk_number
        self.seed = seed
        self.concat_count = context_concatenation_multiplier
        self.context_window = context_window
        # per-host slices of one batch plan: every process builds the same
        # plan (same seed, so the same shapes in the same order) and decodes
        # only its slice of each batch
        if training_batch_size % process_count:
            raise ValueError(
                f"training_batch_size={training_batch_size} must divide "
                f"evenly across process_count={process_count} hosts"
            )
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch_size = training_batch_size // process_count

        self._print_debug = True
        self._bulk_batch_count = 0
        self._first_batch_count = 0

        rounding = int(self.config.get("bucket_rounding", 64))
        self._resolutions = np.concatenate(
            [
                calculate_resolution_array(area, lower, rounding)
                for area, lower in zip(self.max_res_areas, self.bucket_lower_bounds)
            ]
        )
        self._dataframe: Optional[List[dict]] = None  # rows: filepath, caption, width, height, repo_key
        self._batches: List[dict] = []  # the plan: work items (metadata only)
        self._queue: queue.Queue = queue.Queue(maxsize=queue_max_size)
        self._workers: List[threading.Thread] = []
        self._work_queue: queue.Queue = queue.Queue()
        self._producers_done = threading.Event()
        self._outstanding = 0
        self._outstanding_lock = threading.Lock()
        # several processes: workers finish in any order, so batches are
        # released strictly in plan order through a reorder buffer
        self._reorder: dict = {}
        self._next_emit = 0
        self._reorder_lock = threading.Lock()
        self._emit_lock = threading.Lock()  # serializes ordered queue puts

        os.makedirs(ramdisk_path, exist_ok=True)

    def _debug(self, msg: str) -> None:
        if self._print_debug:
            print(f"[dataloader] {msg}")

    # --- chunk fetch ---------------------------------------------------------
    def _chunk_dir(self, chunk: int) -> str:
        return os.path.join(self.ramdisk_path, f"chunk_{chunk}")

    def delete_prev_chunks(self, prev_chunk: int) -> None:
        delete_file_or_folder(self._chunk_dir(prev_chunk))

    @staticmethod
    def _safe_extract_zip(archive_path: str, dest: str) -> None:
        """Extract, refusing absolute or parent-escaping member paths."""
        with zipfile.ZipFile(archive_path) as zf:
            dest_real = os.path.realpath(dest)
            for member in zf.namelist():
                resolved = os.path.realpath(os.path.join(dest, member))
                if not resolved.startswith(dest_real + os.sep) and resolved != dest_real:
                    raise ValueError(f"archive member escapes extraction dir: {member!r}")
            zf.extractall(dest)

    def _fetch_one_chunk(self, chunk: int) -> None:
        """Download and extract every named repo's files for ``chunk``. A
        repo whose chunk yields no file at all (no archive and no CSV) is
        reported: a misconfigured repo must not look like an empty chunk."""
        target = self._chunk_dir(chunk)
        if os.path.isdir(target) and os.listdir(target):
            return  # already fetched
        os.makedirs(target, exist_ok=True)
        token = self.config.get("token")
        for repo_key, repo_cfg in self.config.get("repo", {}).items():
            repo_id = repo_cfg.get("name")
            if repo_id is None:
                continue  # a local repo: its files are already in the chunk directory
            from huggingface_hub import hf_hub_download

            prefix = repo_cfg.get("prefix", "")
            folder = repo_cfg.get("folder_path_in_repo", "")
            file_index = chunk % int(repo_cfg.get("total_file_count", 1))
            fetched, errors = [], []
            for ext in (".zip", ".tar", ".csv"):
                fname = f"{prefix}{file_index}{ext}"
                rel = os.path.join(folder, fname) if folder else fname
                try:
                    local = hf_hub_download(repo_id=repo_id, filename=rel, repo_type="dataset", token=token)
                except Exception as e:  # a missing extension is expected; recorded for the warning
                    errors.append(f"{rel}: {type(e).__name__}: {e}")
                    continue
                dest = os.path.join(target, repo_key)
                os.makedirs(dest, exist_ok=True)
                if ext == ".zip":
                    self._safe_extract_zip(local, dest)
                elif ext == ".tar":
                    with tarfile.open(local) as tf:
                        # the "data" filter rejects absolute paths, .. escapes,
                        # device nodes and links out of the directory
                        tf.extractall(dest, filter="data")
                else:
                    shutil.copy(local, os.path.join(dest, fname))
                fetched.append(fname)
            if fetched:
                self._debug(f"fetched chunk {chunk} for {repo_key}: {fetched}")
            else:
                print(
                    f"[dataloader] WARNING: no chunk file found for repo "
                    f"{repo_key!r} ({repo_id}) chunk {chunk}; tried: " + "; ".join(errors)
                )

    def grab_and_prefetch_chunk(self, numb_of_prefetched_batch: int = 1) -> None:
        """Fetch the current chunk; prefetch the next N on threads."""
        self._fetch_one_chunk(self.chunk_number)
        for ahead in range(1, numb_of_prefetched_batch + 1):
            threading.Thread(target=self._fetch_one_chunk, args=(self.chunk_number + ahead,), daemon=True).start()

    # --- the metadata table ----------------------------------------------------
    def prepare_training_dataframe(self) -> None:
        """Collect the current chunk's metadata rows: each repo's CSVs in its
        chunk directory, else its ``csv_path``."""
        chunk_dir = self._chunk_dir(self.chunk_number)
        rows: List[dict] = []
        for repo_key, repo_cfg in self.config.get("repo", {}).items():
            repo_dir = os.path.join(chunk_dir, repo_key)
            csv_candidates = []
            if os.path.isdir(repo_dir):
                csv_candidates = [os.path.join(repo_dir, f) for f in os.listdir(repo_dir) if f.endswith(".csv")]
            if not csv_candidates and repo_cfg.get("csv_path") and os.path.exists(repo_cfg["csv_path"]):
                csv_candidates = [repo_cfg["csv_path"]]
            for csv_path in csv_candidates:
                rows += read_metadata_csv(csv_path, repo_dir, repo_key, repo_cfg)
        self._dataframe = rows
        self._debug(f"prepared dataframe with {len(rows)} rows")

    def create_training_dataframe(self) -> None:
        """Assign buckets, group into fixed-size batches, shuffle the groups.

        ``repeat_batch`` keeps that many same-resolution batches adjacent, so
        the trainer does not switch between bucket shapes every step."""
        rng = np.random.default_rng(self.seed + self.chunk_number)
        df = self._dataframe
        if not df:
            self._batches = []
            self._bulk_batch_count = 0
            self._first_batch_count = 0
            return

        buckets: Dict[tuple, list] = {}
        for idx in rng.permutation(len(df)):
            row = df[int(idx)]
            wh = assign_bucket(row["width"], row["height"], self._resolutions)
            buckets.setdefault(wh, []).append(int(idx))

        # fixed-size batches per bucket (the ragged remainder is dropped: one
        # step shape per bucket)
        per_bucket_batches: Dict[tuple, list] = {}
        for wh, indices in buckets.items():
            n_full = len(indices) // self.batch_size
            per_bucket_batches[wh] = [
                indices[i * self.batch_size : (i + 1) * self.batch_size] for i in range(n_full)
            ]

        # interleave groups of `repeat_batch` same-resolution batches
        groups = []
        for wh, batch_list in per_bucket_batches.items():
            for i in range(0, len(batch_list), self.repeat_batch):
                groups.append((wh, batch_list[i : i + self.repeat_batch]))
        rng.shuffle(groups)

        self._batches = [{"resolution": wh, "indices": indices} for wh, group in groups for indices in group]
        # the reference trainer sums first and bulk for its loop bound: the
        # first same-resolution group counts as "first", the rest as "bulk";
        # the DEBUG cap (trainer) touches only the bulk count
        self._first_batch_count = min(self.repeat_batch, len(self._batches))
        self._bulk_batch_count = len(self._batches) - self._first_batch_count
        self._debug(f"created {len(self._batches)} batches across {len(buckets)} buckets")

    # --- the worker pool ---------------------------------------------------------
    def _worker_loop(self) -> None:
        rng = np.random.default_rng((self.seed, self.chunk_number, threading.get_ident() % (2**31)))
        while True:
            try:
                item = self._work_queue.get(timeout=0.25)
            except queue.Empty:
                if self._producers_done.is_set():
                    return
                continue
            batch = self._build_batch(item, rng)
            if self.process_count > 1:
                # ordered emission: park out-of-order results and flush the
                # contiguous prefix (a None slot still advances the cursor).
                # The blocking put happens under the emit lock, never under
                # the reorder lock, which dispatch_worker takes between chunks.
                with self._reorder_lock:
                    self._reorder[item["seq"]] = batch
                while True:
                    with self._emit_lock:
                        with self._reorder_lock:
                            if self._next_emit not in self._reorder:
                                break
                            ready = self._reorder.pop(self._next_emit)
                            self._next_emit += 1
                        if ready is not None:
                            self._queue.put(ready)
            elif batch is not None:
                self._queue.put(batch)
            with self._outstanding_lock:
                self._outstanding -= 1

    def _build_batch(self, item: dict, rng) -> Optional[dict]:
        df = self._dataframe
        wh = item["resolution"]
        # decode only this process's slice of the batch
        lo = self.process_index * self.local_batch_size
        local_indices = item["indices"][lo : lo + self.local_batch_size]
        pixels, captions = [], []
        for idx in local_indices:
            row = df[idx]
            arr = load_and_bucket_image(row["filepath"], wh)
            if arr is None:
                if self.process_count > 1:
                    # a skip on one process would put the processes' batch
                    # sequences out of step: a blank image instead
                    self._debug(f"decode failed for {row['filepath']}; substituting blank image")
                    arr = np.zeros((3, int(wh[1]), int(wh[0])), np.float32)
                else:
                    continue
            repo_cfg = self.config.get("repo", {}).get(row["repo_key"], {})
            captions.append(
                _shuffle_and_drop_tags(
                    row["caption"],
                    rng,
                    repo_cfg.get("coma_separated_shuffle", False),
                    repo_cfg.get("max_tag_count"),
                    repo_cfg.get("drop_caption_ratio"),
                    repo_cfg.get("caption_drop_mode", "tags"),
                )
            )
            pixels.append(arr)
        if len(pixels) < self.local_batch_size:
            return None  # decode failures broke the batch's shape
        toks = tokenize_concat_windows(self.tokenizer, captions, self.context_window, self.concat_count)
        return {
            "pixel_values": np.stack(pixels).astype(np.float32),
            "input_ids": toks["input_ids"],
            "attention_mask": toks["attention_mask"],
        }

    def dispatch_worker(self) -> None:
        """Start the worker threads that fill the batch queue."""
        self._producers_done.clear()
        with self._outstanding_lock:
            self._outstanding = len(self._batches)
        with self._reorder_lock:
            self._reorder.clear()
            self._next_emit = 0
        for seq, item in enumerate(self._batches):
            self._work_queue.put({**item, "seq": seq})
        self._producers_done.set()
        self._workers = []
        for _ in range(self.num_workers):
            t = threading.Thread(target=self._worker_loop, daemon=True)
            t.start()
            self._workers.append(t)

    def grab_next_batch(self):
        """A batch dict, None (a timeout or a transient miss), or
        ``"end_of_batch"``."""
        with self._outstanding_lock:
            drained = self._outstanding <= 0
        if drained and self._queue.empty():
            return "end_of_batch"
        try:
            return self._queue.get(timeout=self.queue_get_timeout)
        except queue.Empty:
            with self._outstanding_lock:
                drained = self._outstanding <= 0
            return "end_of_batch" if drained else None
