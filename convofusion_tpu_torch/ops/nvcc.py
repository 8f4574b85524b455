"""Build a hand-written CUDA kernel of ``csrc/`` into a shared library with a
plain C interface, for ``ctypes``: ``nvcc`` for ``sm_90a`` into ``_build/``
at first use, no PyTorch headers (~3.7 s a file on the card's machine).
A caller that knows it will launch a kernel may ``start`` its build early,
in a child process, so that the compile overlaps its own set-up; ``build``
then waits for that process."""
from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no --use_fast_math and no contracted multiply-adds: a kernel rounds
    # as its plain PyTorch version does, and writes any multiply-add it
    # needs as an intrinsic
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the kernel")
    return nvcc


# the process's builds under way, by library: (compiler, its output file,
# its command); one library file serves the whole process.  The lock is
# held while a build is waited for, so that no second compile of the same
# library starts meanwhile.
_PENDING: Dict[Path, Tuple[subprocess.Popen, Path, List[str]]] = {}
_LOCK = threading.Lock()


def _start(source: Path, library: Path) -> None:
    if library in _PENDING or (
            library.exists()
            and library.stat().st_mtime >= source.stat().st_mtime):
        return
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *FLAGS, "-o", str(tmp), str(source)]
    # the report is a few lines: the pipe does not fill before it is read
    _PENDING[library] = (subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        tmp, cmd)


def start(source: Path, library: Path) -> None:
    """Start compiling ``source`` into ``library`` in a child process,
    unless a library newer than the source is there or a build of it is
    under way; :func:`build` waits for it."""
    with _LOCK:
        _start(source, library)


def build(source: Path, library: Path) -> str:
    """Compile ``source`` into ``library`` unless a library newer than the
    source is there, or wait for the build :func:`start` began.  Returns
    the compiler's output (register and spill report), or '' when nothing
    was built."""
    with _LOCK:
        _start(source, library)
        pending = _PENDING.pop(library, None)
        if pending is None:
            return ""
        proc, tmp, cmd = pending
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
        os.replace(tmp, library)
    return out
