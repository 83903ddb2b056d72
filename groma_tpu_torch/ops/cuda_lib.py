"""Build and load the hand-written Hopper kernels of ``groma_tpu_torch/csrc``.

Every ``*.cu`` file there is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, never at import, into ``csrc/build/`` (git-ignored); the
library's file name carries a hash of the sources, so an edit rebuilds it.
Nothing here imports anything CUDA-specific until :func:`library` is called.
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
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_lib = None
build_info: dict = {}      # path, seconds, ptxas log of the loaded library


def _digest(sources) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in sources:
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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.groma_int8_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.groma_int8_matmul.restype = i
    lib.groma_int8_decode_attention.argtypes = [p, p, p, p, p, p, p,
                                                i, i, i, i, p]
    lib.groma_int8_decode_attention.restype = i


def library():
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob('*.cu'))
        so = BUILD_DIR / f'libgroma_kernels_{_digest(sources)}.so'
        log = ''
        seconds = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, '-o', tmp, *map(str, sources)],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
            os.replace(tmp, so)       # atomic: concurrent builds agree
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        build_info.update(path=str(so), seconds=seconds, log=log)
        _lib = lib
        return lib


def check(status: int, name: str):
    """Raise if a C entry point reported a CUDA error at launch."""
    if status != 0:
        raise RuntimeError(f'{name}: CUDA error {status} at launch')


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
