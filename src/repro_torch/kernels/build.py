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

Block shapes: the single path's work-item sweeps (``VARIANT_KERNELS``) are
also built at the other block shapes of ``ITEM_WARPS``, each into a library
of its own, ``<source>-w<warps>-<hash>.so``, compiled with
``-DREPRO_ITEM_WARPS=<warps>`` (the flag is in its hash). ``load(name,
warps)`` takes the library of that shape; the default shape
(``edges.ITEM_WARPS``) is the plain library, and a kernel without variants
refuses any other shape.

Threads: the async engine's serving and mutation threads may reach the same
kernel first together. ``load`` holds one lock over its check, the build
and the ``CDLL``, so a library is built and loaded once; every ``nvcc``
writes a temporary file of its own and renames it into place.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid
from pathlib import Path
from typing import Dict, Iterable, Tuple

from repro_torch.kernels.edges import ITEM_WARPS as DEFAULT_WARPS

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
    # m_in, out, ids (or null), id bytes, n_rows, num_regs, reg_offset, seed, stream
    "sketch_fill": ("sketch_fill", "repro_sketch_fill", [_P, _P, _P, _I, _I, _I, _U, _U, _P]),
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
#: the kernels built at every block shape of ``ITEM_WARPS`` (each its own source)
VARIANT_KERNELS = ("sketch_propagate", "cascade_step")
#: the block shapes (warps, and so work items, a block) of ``VARIANT_KERNELS``;
#: ``ptxas -v`` reports no spill at any of them (``chip_smoke.py`` phase 1)
ITEM_WARPS = (2, 4, 8)

_LOADED: Dict[Tuple[str, int], ctypes._CFuncPtr] = {}
_LOAD_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels cannot be built")
    return found


def _variant_sources() -> Tuple[str, ...]:
    return tuple(SIGNATURES[k][0] for k in VARIANT_KERNELS)


def _flags(warps: int) -> Tuple[str, ...]:
    return FLAGS if warps == DEFAULT_WARPS else (*FLAGS, f"-DREPRO_ITEM_WARPS={warps}")


def library_path(source: str, warps: int = DEFAULT_WARPS) -> Path:
    digest = hashlib.sha256(" ".join(_flags(warps)).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{source}.cu"):
        digest.update(src.read_bytes())
    shape = "" if warps == DEFAULT_WARPS else f"-w{warps}"
    return BUILD_DIR / f"{source}{shape}-{digest.hexdigest()[:16]}.so"


def _check_shape(source: str, warps: int) -> None:
    if warps == DEFAULT_WARPS:
        return
    if source not in _variant_sources():
        raise ValueError(f"{source} is built at {DEFAULT_WARPS} warps a block only")
    if warps not in ITEM_WARPS:
        raise ValueError(f"{source} is built at {ITEM_WARPS} warps a block, not {warps}")


def _library(source: str, warps: int) -> Path:
    return library_path(source) if warps == DEFAULT_WARPS else library_path(source, warps)


def build(names: Iterable[str] = SOURCES,
          warps: Iterable[int] = ITEM_WARPS) -> Dict[str, str]:
    """Compile every missing library of the sources ``names`` in parallel:
    each at the default block shape, and the sweeps' sources also at the
    other shapes of ``warps``. Returns the compiler's report (registers,
    spills) of each library built now, keyed by the source's name
    (``<source>-w<warps>`` for another shape)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = []
    for name in names:
        for w in dict.fromkeys((DEFAULT_WARPS, *warps)):
            if w == DEFAULT_WARPS or name in _variant_sources():
                _check_shape(name, int(w))
                targets.append((name, int(w)))
    jobs = {}
    for name, w in targets:
        lib = _library(name, w)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{uuid.uuid4().hex}.tmp.so")
        cmd = [nvcc(), *_flags(w), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        label = name if w == DEFAULT_WARPS else f"{name}-w{w}"
        jobs[label] = (lib, tmp, subprocess.Popen(
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


def load(name: str, warps: int = DEFAULT_WARPS):
    """The C entry point of kernel ``name`` at ``warps`` warps a block, built
    at first use."""
    warps = int(warps)
    with _LOAD_LOCK:
        fn = _LOADED.get((name, warps))
        if fn is None:
            source, symbol, argtypes = SIGNATURES[name]
            _check_shape(source, warps)
            lib = _library(source, warps)
            if not lib.exists() and warps == DEFAULT_WARPS:
                build([source])
            elif not lib.exists():
                build([source], warps=(warps,))
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LOADED[(name, warps)] = fn
        return fn


def check(name: str, status: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
