"""JSON config/state IO.

The port's own copy of ``stable_diffusion_training_tpu/utils/json_io.py``.
The run config JSON doubles as a mutable resume-state store: the trainer
rewrites ``model_path``/``chunk_number``/``chunk_steps``/``master_seed``
after every chunk, as the reference trainer does.
"""

import json
import os
import shutil


def read_json_file(path: str) -> dict:
    """Read a JSON file into a dict."""
    with open(path, "r") as f:
        return json.load(f)


def save_dict_to_json(data: dict, path: str) -> None:
    """Atomically write a dict as JSON (write temp file then rename).

    Atomicity matters because the file is the crash-resume state store:
    a partially written state file would brick the run.
    """
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=4)
    os.replace(tmp, path)


def delete_file_or_folder(path: str) -> None:
    """Delete a file or directory tree; silently ignore missing paths.

    Used for the save probe's cleanup and checkpoint rotation.
    """
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        try:
            os.remove(path)
        except OSError:
            pass
