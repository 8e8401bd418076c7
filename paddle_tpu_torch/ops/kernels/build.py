"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and
compiles on its own into ``build/paddle_tpu_torch/<name>.<digest>.so``
at the root of the checkout (the directory is listed in ``.gitignore``).
The digest is taken over the source text, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited source or header
builds anew and an unchanged one is reused. Nothing is
built at import time: the first launch of a kernel builds its library,
and ``build()`` builds several at once, one ``nvcc`` process per source,
all started together.

The target is ``sm_90a`` (Hopper). ``-Xptxas -v`` makes ptxas report each
kernel's registers, shared memory and spills; the report is kept beside
the library as ``<name>.<digest>.ptxas.txt`` and returned by
:func:`build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                       "the PATH to build the port's CUDA kernels")


def sources() -> list:
    """The names of every CUDA source of the port."""
    return sorted(p.stem for p in SOURCE_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    text = (SOURCE_DIR / f"{name}.cu").read_bytes()
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}.{digest[:12]}.so"


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build the named sources (all of them by default) that are not
    built yet, one ``nvcc`` each, all at once. Returns each source's
    ptxas report. Raises with the compiler's output if any build fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SOURCE_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        _report_path(lib).write_text(out)
        os.replace(tmp, lib)            # atomic against a concurrent build
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {name: _report_path(library_path(name)).read_text()
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
