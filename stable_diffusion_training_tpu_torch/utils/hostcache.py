"""The key of the kernel build cache and the purge of its stale entries.

Port of ``stable_diffusion_training_tpu/utils/hostcache.py``. The JAX
package keys its XLA:CPU compile caches by the host's CPU, because an
executable compiled for one CPU may crash on another. The port's cache is
``ops/cuda_build.py``'s ``_build/``: shared libraries that ``nvcc`` compiled
for sm_90a. A library is only as good as the toolkit and host compiler that
built it, so its directory is keyed by ``toolchain_fingerprint()`` beside
its sources and flags, and a directory that another toolkit built is never
loaded.

``prepare_cache_dir`` removes the entries that a new key leaves stale: every
sibling ``<name>-<16 hex digits>`` with another key (an edited source or
another toolchain), and the temporary file of a build whose process is gone.
Nothing here runs at import: ``nvcc`` is asked only when a key is computed,
which is when a library is built.
"""

import functools
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Sequence

KEY_DIGITS = 16


def _version(cmd: Sequence[str]) -> str:
    """The first lines of ``cmd``'s output (its version banner)."""
    try:
        out = subprocess.run(list(cmd), capture_output=True, text=True, timeout=60, check=True).stdout
    except FileNotFoundError:
        return f"{cmd[0]}: not found"
    return out.strip()


def host_compiler(flags: Sequence[str]) -> str:
    """The host compiler ``nvcc`` calls: what ``-ccbin`` (or
    ``--compiler-bindir``) names in ``flags``, else ``c++``."""
    for i, flag in enumerate(flags):
        for opt in ("-ccbin", "--compiler-bindir"):
            if flag == opt and i + 1 < len(flags):
                return flags[i + 1]
            if flag.startswith(opt + "="):
                return flag.split("=", 1)[1]
    return "c++"


def toolchain_parts(nvcc: str, flags: Sequence[str]) -> Dict[str, str]:
    """What a build's output depends on beside its sources: ``nvcc
    --version``, the host compiler's ``--version`` and the flags."""
    cxx = host_compiler(flags)
    return {
        "nvcc": _version([nvcc, "--version"]),
        "host_compiler": f"{cxx}: {_version([cxx, '--version'])}",
        "flags": " ".join(flags),
    }


@functools.lru_cache(maxsize=None)
def toolchain_fingerprint(nvcc: str, flags: Sequence[str]) -> str:
    """A short sha256 of ``toolchain_parts``; computed once a process for
    each ``nvcc`` and flags (``toolchain_fingerprint.cache_clear()`` forgets
    it)."""
    parts = toolchain_parts(nvcc, tuple(flags))
    digest = hashlib.sha256("\0".join(f"{k}={v}" for k, v in sorted(parts.items())).encode())
    return digest.hexdigest()[:KEY_DIGITS]


def prepare_cache_dir(base_dir: str, name: str, key: str) -> str:
    """Create (and return) ``base_dir/<name>-<key>`` and purge what is stale
    beside it: each sibling named exactly ``<name>-`` and 16 hex digits with
    another key, and in the kept directory each ``lib<name>.so.<pid>.tmp``
    whose process is gone.

    The match is exact, ``-`` and all. The JAX package's rule (``prefix``
    or ``prefix + "_"``) would let a library named ``flash_attention``
    purge ``flash_attention_fwd-*``, another library's directory. Another
    process may purge the same entries at the same time: an entry already
    gone is no error."""
    path = os.path.join(base_dir, f"{name}-{key}")
    stale = re.compile(rf"^{re.escape(name)}-[0-9a-f]{{{KEY_DIGITS}}}$")
    try:
        entries = os.listdir(base_dir)
    except FileNotFoundError:
        entries = []
    for entry in entries:
        if entry != os.path.basename(path) and stale.match(entry):
            shutil.rmtree(os.path.join(base_dir, entry), ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    tmp = re.compile(rf"^lib{re.escape(name)}\.so\.(\d+)\.tmp$")
    for entry in os.listdir(path):
        m = tmp.match(entry)
        if m and not _alive(int(m.group(1))):
            try:
                os.remove(os.path.join(path, entry))
            except FileNotFoundError:
                pass
    return path


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # another user's process
        return True
    return True
