"""What the kernel probes (``sweep``, ``k7_probe``, ``decode_probe``)
share: exact-string edits of a kernel's source, building the edited copies
side by side, and the timer.

A variant is the kernel's ``.cu`` with one string replaced; an edit that
no longer finds its string raises, so a changed source fails before any
time is spent building. The copies are built into ``build/`` (one ``nvcc``
each, all started together) and loaded with ctypes beside the real
library.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import torch

from repro_torch.kernels import build


def edit(src: str, old: str, new: str) -> str:
    """``src`` with its one ``old`` replaced by ``new``."""
    if src.count(old) != 1:
        raise RuntimeError(f"the kernel source changed: cannot find {old!r}")
    return src.replace(old, new)


def build_variants(stem: str, variants: dict) -> dict:
    """{name: ctypes.CDLL} of each source text in ``variants``, built into
    ``build/<stem>/``."""
    out = build.BUILD_DIR.parent / stem
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"{name}-{os.getpid()}.so"
        procs[name] = (so, subprocess.Popen(
            build.nvcc_command(so, cu),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {stem} {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def timer(fns: dict, iters: int = 10, flush: str = "dirty") -> dict:
    """{name: median µs} of single calls of each of ``fns``, timed in turns
    with CUDA events, the device held busy until the call is enqueued (as
    ``chip_smoke.py``'s ``Timer``). Before each call the 50 MB L2 is
    flushed: ``dirty`` writes 256 MB (the L2 is left full of dirty lines,
    which a memory-bound call then writes back beside its own reads);
    ``clean`` writes them and then reads another 256 MB (the L2 is left
    full of clean lines, as a decode step leaves it after reading
    weights)."""
    if flush not in ("dirty", "clean"):
        raise ValueError(f"flush must be 'dirty' or 'clean', got {flush!r}")
    dirty = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    clean = torch.ones(64 * 2 ** 20, dtype=torch.int32, device="cuda") \
        if flush == "clean" else None
    sink = torch.empty((), dtype=torch.int64, device="cuda")
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(iters):
        for name, fn in fns.items():
            dirty.zero_()
            if clean is not None:
                torch.sum(clean, dim=0, out=sink)
            torch.cuda._sleep(20_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1) * 1e3)
    return {name: round(statistics.median(t), 2) for name, t in times.items()}
