"""Build and load the hand-written Hopper kernels of ``groma_tpu_torch/csrc``.

Two shared libraries with a plain C interface, loaded with ``ctypes``:

* :func:`library`, the production kernels: every ``csrc/*.cu`` but the
  probes.  The model, the trainer and the server load it.
* :func:`probe_library`, the H100 probes ``csrc/probe_*.cu``, loaded only
  by ``groma_tpu_torch/benchmarks/exp_*.py``, so that a probe that fails to
  build takes nothing else down.

Each source is compiled by its own ``nvcc`` for ``sm_90a``, all of a
library's sources at once, and the objects are linked into the library.
The build runs at first use, never at import, into ``csrc/build/``
(git-ignored); a library's file name carries a hash of its sources and of
the headers, so an edit rebuilds it.  Nothing here imports anything
CUDA-specific until a library is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = CSRC / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
PROBE_PREFIX = 'probe_'

_lock = threading.Lock()
_probe_lock = threading.Lock()
_lib = None
_probe_lib = None
build_info: dict = {}        # path, seconds, ptxas log of the loaded library
probe_build_info: dict = {}  # the same for the probe library


def sources() -> list:
    """The production library's sources."""
    return sorted(p for p in CSRC.glob('*.cu')
                  if not p.name.startswith(PROBE_PREFIX))


def probe_sources() -> list:
    """The probe library's sources."""
    return sorted(CSRC.glob(f'{PROBE_PREFIX}*.cu'))


def _digest(srcs) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in [*srcs, *sorted(CSRC.glob('*.cuh'))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels of groma_tpu_torch '
                       'are built on a machine with the CUDA toolkit')


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.groma_int8_matmul.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.groma_int8_matmul.restype = i
    lib.groma_int8_decode_attention.argtypes = [p, p, p, p, p, p, p,
                                                i, i, i, i, i, i, p]
    lib.groma_int8_decode_attention.restype = i
    lib.groma_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, p]
    lib.groma_flash_fwd.restype = i
    lib.groma_flash_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                    i, i, i, i, i, f, i, p]
    lib.groma_flash_bwd.restype = i
    lib.groma_int4_matmul.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.groma_int4_matmul.restype = i
    lib.groma_paged_attention.argtypes = [p, p, p, p, p, p, p, p,
                                          i, i, i, i, i, p]
    lib.groma_paged_attention.restype = i
    lib.groma_decode_megakernel.argtypes = [p] * 19 + [i] * 6 + [f, p, p]
    lib.groma_decode_megakernel.restype = i
    lib.groma_decode_megakernel_maps.argtypes = [p, p, i, i, i]
    lib.groma_decode_megakernel_maps.restype = i


def _declare_probes(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.groma_probe_int4_unpack.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.groma_probe_int4_unpack.restype = i
    lib.groma_probe_m8_matmul.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.groma_probe_m8_matmul.restype = i
    lib.groma_probe_decode_attn.argtypes = [p] * 10 + [i] * 10 + [p]
    lib.groma_probe_decode_attn.restype = i


def _build(srcs, so: Path) -> str:
    """One nvcc per source, all started together, then one link.
    Returns the compilers' output (ptxas register and spill summaries)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f'{src.stem}.o' for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        logs = [f'== {src.name}\n{proc.communicate()[0]}'
                for src, proc in zip(srcs, procs)]
        log = ''.join(logs)
        failed = [src.name for src, proc in zip(srcs, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n{log}')
        lib = Path(tmp) / so.name
        proc = subprocess.run([nvcc, '-shared', '-o', str(lib),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc link failed:\n{proc.stdout}'
                               f'{proc.stderr}')
        os.replace(lib, so)       # atomic: concurrent builds agree
    return log


def _load(stem: str, srcs, declare, info: dict):
    so = BUILD_DIR / f'{stem}_{_digest(srcs)}.so'
    log = ''
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _build(srcs, so)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    declare(lib)
    info.update(path=str(so), seconds=seconds, log=log)
    return lib


def library():
    """The loaded production kernel library, built first if its sources
    changed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load('libgroma_kernels', sources(), _declare, build_info)
        return _lib


def probe_library():
    """The loaded probe library (``csrc/probe_*.cu``), built first if its
    sources changed."""
    global _probe_lib
    with _probe_lock:
        if _probe_lib is None:
            _probe_lib = _load('libgroma_probes', probe_sources(),
                               _declare_probes, probe_build_info)
        return _probe_lib


def check(status: int, name: str):
    """Raise if a C entry point reported a CUDA error at launch."""
    if status != 0:
        raise RuntimeError(f'{name}: CUDA error {status} at launch')


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
