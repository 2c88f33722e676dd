"""Builds the port's native sources into shared libraries with a plain C
interface, loaded with ctypes: the CUDA kernels (`metrabs_tpu_torch/csrc/
<name>.cu`) with nvcc, and host code (`csrc/<name>.cpp`, the JPEG decoder)
with the host C++ compiler (`$CXX`, else `c++`).

A library is built at first use into `metrabs_tpu_torch/_build/`, keyed by a
hash of its source and the flags, so an edited source or flag set builds
anew and an unchanged one is reused; concurrent builders each write their
own file and rename it into place. Nothing is built when a module is
imported: the CPU paths never reach nvcc.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Tuple

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / 'csrc'
BUILD_DIR = _PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '--fmad=false', '-shared', '-Xcompiler', '-fPIC')
# No -ffast-math or -march: the decoder is integer arithmetic that must give
# libjpeg-turbo's numbers on every host.
CXX_FLAGS = ('-O2', '-std=c++17', '-shared', '-fPIC')


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
    return _build(nvcc, source_path(name, csrc_dir),
                  (*NVCC_FLAGS, *(f'-D{d}' for d in defines)), name)


def build_host_library(name: str, csrc_dir: Path = CSRC_DIR) -> Tuple[Path, float]:
    """Compiles the host source `<csrc_dir>/<name>.cpp` with `$CXX` (else
    `c++`) and CXX_FLAGS, as `build_library` compiles a kernel."""
    return _build(lambda: os.environ.get('CXX') or 'c++', Path(csrc_dir) / f'{name}.cpp', CXX_FLAGS,
                  name)


def _build(compiler: Callable[[], str], source: Path, flags: Tuple[str, ...], name: str) -> Tuple[Path, float]:
    key = hashlib.sha256(source.read_bytes() + ' '.join(flags).encode()).hexdigest()
    lib = BUILD_DIR / f'libmetrabs_{name}_{key[:16]}.so'
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    start = time.perf_counter()
    compiler = compiler()  # found only when something is to be built
    proc = subprocess.run([compiler, *flags, '-o', str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'{compiler} failed on {source}:\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib, time.perf_counter() - start
