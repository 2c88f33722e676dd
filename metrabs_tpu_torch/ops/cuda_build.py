"""Builds the port's CUDA sources (`metrabs_tpu_torch/csrc/<name>.cu`) with
nvcc into shared libraries with a plain C interface, loaded with ctypes.

A library is built at first use into `metrabs_tpu_torch/_build/`, keyed by a
hash of its source and the flags, so an edited source or flag set builds
anew and an unchanged one is reused. Nothing is built when a module is
imported: the CPU paths never reach nvcc.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / 'csrc'
BUILD_DIR = _PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--fmad=false', '-shared', '-Xcompiler', '-fPIC')


def source_path(name: str, csrc_dir: Path = CSRC_DIR) -> Path:
    return Path(csrc_dir) / f'{name}.cu'


def nvcc() -> str:
    for home in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH')):
        if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(found):
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built')
    return found


def build_library(name: str, csrc_dir: Path = CSRC_DIR,
                  defines: Tuple[str, ...] = ()) -> Tuple[Path, float]:
    """Compiles `<csrc_dir>/<name>.cu`, with a `-D` for each of `defines`,
    unless a build of the same source and flags exists. Returns (library
    path, seconds spent compiling; 0 if cached)."""
    source = source_path(name, csrc_dir)
    flags = (*NVCC_FLAGS, *(f'-D{d}' for d in defines))
    key = hashlib.sha256(source.read_bytes() + ' '.join(flags).encode()).hexdigest()
    lib = BUILD_DIR / f'libmetrabs_{name}_{key[:16]}.so'
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    start = time.perf_counter()
    proc = subprocess.run([nvcc(), *flags, '-o', str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source}:\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib, time.perf_counter() - start
