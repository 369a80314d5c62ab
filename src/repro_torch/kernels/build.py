"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each ``csrc/<source>.cu`` compiles on its own, with the headers
``csrc/*.cuh`` it includes, into ``build/repro_torch/<source>-<hash>.so``
under the repository root::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

``<hash>`` covers the source, every header and the flags, so a stale
library is never loaded. Nothing is built when the package is imported:
``load`` builds its library at first use, and ``build`` starts one ``nvcc``
for each missing library, all at once. ``nvcc`` is ``$CUDA_HOME/bin/nvcc``
or the one on ``PATH``; without it, or when a build fails, these raise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
# two matrices (m_in and out, or acc and block), partial, the work list (5),
# nbr, h, lo, thr, x, num_items, num_split, num_regs, variant, changed, stream
_ITEM_SWEEP = [_P] * 13 + [_I] * 4 + [_P, _P]
#: kernel name -> (source ``csrc/<source>.cu``, C entry point, argument types)
SIGNATURES = {
    "sketch_fill": ("sketch_fill", "repro_sketch_fill", [_P, _P, _I, _I, _U, _U, _P]),
    "sketch_cardinality": ("sketch_cardinality", "repro_cardinality_stats",
                           [_P, _P, _I, _I, _P]),
    "sketch_propagate": ("sketch_propagate", "repro_propagate_sweep", _ITEM_SWEEP),
    "cascade_step": ("cascade_step", "repro_cascade_sweep", _ITEM_SWEEP),
    "fused_sample": ("fused_sample", "repro_fused_sample",
                     [_P, _P, _P, _P, _P, _L, _I, _I, _P]),
    # m_in, out, scratch, then _ITEM_SWEEP's from partial on, num_sweeps after variant
    "fused_sweep": ("fused_sweep", "repro_fused_sweep", [_P] * 14 + [_I] * 5 + [_P, _P]),
    "bucket_propagate": ("bucket_propagate", "repro_bucket_propagate", _ITEM_SWEEP),
    "bucket_cascade": ("bucket_propagate", "repro_bucket_cascade", _ITEM_SWEEP),
}
KERNELS = tuple(SIGNATURES)
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))

_LOADED: Dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{source}.cu"):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{source}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library of the sources ``names`` in parallel.
    Returns the compiler's report (registers, spills) of each library built
    now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (lib, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, lib)
        reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str):
    """The C entry point of kernel ``name``, built at first use."""
    fn = _LOADED.get(name)
    if fn is None:
        source, symbol, argtypes = SIGNATURES[name]
        lib = library_path(source)
        if not lib.exists():
            build([source])
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn


def check(name: str, status: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
