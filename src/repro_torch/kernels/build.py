"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds; :func:`build` starts
one ``nvcc`` per source, all together) into
``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the checkout.
The hash covers the source, the headers it may include (``HEADERS``, found
with ``-I csrc``) and the flags, so an edited ``.cu`` or header rebuilds and
an unchanged one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the headers under csrc/ that the sources include: hashed into every key
HEADERS = ("common.cuh",)

KERNELS = ("decode_attention", "paged_decode_attention",
           "paged_prefill_attention", "varlen_attention", "tabq_quantize",
           "ts_mask", "dequant_matmul")

# name -> loaded library; filled by load()
_LIBS: dict = {}
# name -> nvcc's stderr (ptxas's register and shared-memory report), for
# the libraries this process built
BUILD_LOG: dict = {}


def source_hash(name: str) -> str:
    """Hash of a kernel's source, the shared headers and the flags it is
    built with."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in HEADERS:
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_hash(name)}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for path in cand:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def nvcc_command(out, src) -> list:
    """The ``nvcc`` command that builds ``src`` (a ``.cu`` anywhere: the
    probes build edited copies under ``build/``) into the library ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def build(*names: str) -> None:
    """Compile the named kernels whose libraries do not exist yet, one
    ``nvcc`` per source, all started together."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(tmp, CSRC / f"{name}.cu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{stdout}{stderr}")
            continue
        os.replace(tmp, library_path(name))  # atomic: never a partial file
        BUILD_LOG[name] = stderr
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
