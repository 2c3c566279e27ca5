"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded through ``ctypes``.
The build happens at first use, into ``build/kernels/`` at the root of the
checkout, and is cached by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once. ``defines`` (``NAME=VALUE``
strings, passed as ``-D``) build a variant of a source beside the shipped
one, for a sweep of its compile-time choices. A missing ``nvcc`` or a
failed compile raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict[tuple, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple("-D" + d for d in defines)


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Where the library of ``csrc/<name>.cu`` lands for its current source."""
    digest = hashlib.sha256(Path(CSRC, name + ".cu").read_bytes()
                            + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name.replace('/', '_')}-{digest}.so"


def build(name: str, defines: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its cached library exists. Returns
    the library path and the compiler's report (register and shared-memory
    use per kernel; empty when the cache was hit)."""
    lib = library_path(name, defines)
    if lib.is_file():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *_flags(defines), "-o", tmp, str(CSRC / (name + ".cu"))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)      # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    key = (name, defines)
    with _LOCK:
        if key not in _LOADED:
            path, _ = build(name, defines)
            _LOADED[key] = ctypes.CDLL(str(path))
        return _LOADED[key]


def _cuobjdump(path: Path, what: str) -> str:
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    return subprocess.run([tool, what, str(path)], check=True,
                          capture_output=True, text=True).stdout


def kernel_resources(path: Path) -> dict[str, dict[str, int]]:
    """Per kernel of a built library (by mangled name): its registers and
    its stack frame and local memory in bytes (cuobjdump -res-usage); a
    register spill lands in the stack frame."""
    out, name = {}, None
    for line in _cuobjdump(path, "-res-usage").splitlines():
        if "Function" in line:
            name = line.split("Function", 1)[1].strip().rstrip(":")
        elif name and "REG:" in line:
            fields = dict(f.split(":", 1) for f in line.split()
                          if f.split(":", 1)[0] in ("REG", "STACK", "LOCAL"))
            out[name] = dict(registers=int(fields["REG"]),
                             stack=int(fields["STACK"]),
                             local=int(fields["LOCAL"]))
            name = None
    return out


def tensor_core_ops(path: Path) -> dict[str, dict[str, int]]:
    """Per kernel of a built library (by mangled name): how many of each
    tensor-core instruction (HMMA.<shape>.<types>) its SASS holds."""
    out, name = {}, None
    for line in _cuobjdump(path, "-sass").splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = {}
        elif name and "HMMA" in line:
            op = "HMMA" + line.split("HMMA", 1)[1].split()[0]
            out[name][op] = out[name].get(op, 0) + 1
    return out
