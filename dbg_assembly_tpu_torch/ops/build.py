"""Builds the hand-written CUDA kernels (ops/csrc/*.cu) and loads them.

Each source compiles with nvcc into its own shared library with a plain C
interface, under dbg_assembly_tpu_torch/_build/, at first use; a library is
rebuilt when its source is newer; ptxas's report of each kernel's registers,
shared memory and spills is kept beside it (``resources``).  Callers bind it
with ctypes: pointers from ``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``, both as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only on a machine with the "
                       "CUDA toolkit")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into _build/lib<name>.so (and ptxas's report
    into lib<name>.so.ptxas.txt) if either is missing or the library is
    older than its source; returns the library's path."""
    src = os.path.join(CSRC, name + ".cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if (os.path.exists(so) and os.path.exists(so + ".ptxas.txt")
            and os.path.getmtime(so) >= os.path.getmtime(src)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent loader never
    # opens a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        with open(so + ".ptxas.txt", "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _kernel_label(mangled: str) -> str:
    """The kernel's name in a mangled symbol (a run of length-prefixed
    identifiers), with its bool template arguments."""
    i = re.match(r"_ZN?", mangled).end() if mangled.startswith("_Z") else 0
    while (d := re.match(r"\d+", mangled[i:])) is not None:
        start = i + d.end()
        i = start + int(d.group())
        if mangled[start:i].endswith("kernel"):
            tmpl = re.match(r"I((?:Lb[01]E)+)E", mangled[i:])
            return mangled[start:i] + (
                f"<{','.join(re.findall(r'Lb([01])E', tmpl[1]))}>"
                if tmpl else "")
    return mangled


def resources(name: str) -> list[str]:
    """One line per kernel of the last build of csrc/<name>.cu, from
    ptxas: registers, shared memory, spill stores and loads."""
    with open(os.path.join(BUILD_DIR, f"lib{name}.so.ptxas.txt")) as f:
        text = f.read()
    return [f"{_kernel_label(m[1])}: {m[3]}; {m[2]}" for m in re.finditer(
        r"Function properties for (\S+)\n\s*(.*?spill stores, .*?spill "
        r"loads)\n.*?Used ([^\n]*)", text)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
