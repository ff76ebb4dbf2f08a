"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``kernels/csrc/`` exposes a plain C interface and is
compiled at first use into ``build/`` at the repository root (listed in
``.gitignore``), named by a hash of its text, the shared ``.cuh`` headers
beside it and the flags, so an edited source or header is rebuilt and an
unchanged one is reused within a checkout.  There is no prebuilt binary
and no fallback: a missing compiler or a failed build raises.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -shared -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
#: compiler output of each build made by this process (``-Xptxas -v``)
build_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on
    ``PATH``, or ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lands: named by a hash of the
    source, every ``.cuh`` header of ``csrc/`` (a source may include any
    of them) and the flags."""
    tag = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        tag.update(header.name.encode() + header.read_bytes())
    tag.update(" ".join(ARCH_FLAGS + FLAGS).encode())
    return BUILD_DIR / f"{name}-{tag.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its build exists; returns the
    shared library's path.  Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *ARCH_FLAGS, *FLAGS, "-Xptxas", "-v", "-o", tmp,
           str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_logs[name] = proc.stdout + proc.stderr
    return out


def build_all(names) -> dict[str, Path]:
    """Compile several sources at once, one ``nvcc`` process each, all
    started together; returns each build's path (raises as :func:`build`
    does, once every compiler has finished)."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as ex:
        return dict(zip(names, ex.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
