"""Writes the MATLAB-layout HDF5 fixtures of the port's HDF5 reader,
`tests/torch_fixtures/hdf5/{TS1,TS5}_annot_data.mat`, with h5py, and
`manifest.json`: for each file and dataset the SHA-256 of the C-order bytes
h5py reads, their dtype and shape. The card's machine has no h5py;
`chip_smoke.py` holds the port's reader to these hashes there.

    python tests/_torch_hdf5_fixtures.py

No file written by MATLAB itself is in the repository, so the layout is
h5py's imitation of MATLAB v7.3's `annot_data.mat` of the MPI-INF-3DHP test
set: a 512-byte user block that starts with MATLAB's header text, doubles
in MATLAB's column-major order (its [3, 17, 1, F] `annot3` reads as
[F, 1, 17, 3]), chunked and deflated with edge chunks, each dataset with
its `MATLAB_class` attribute. TS1 holds 48 frames (TS1-4 are 2048x2048),
TS5 40 (TS5-6 are 1920x1080); each has one invalid frame.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent / 'torch_fixtures' / 'hdf5'
MANIFEST = FIXTURE_DIR / 'manifest.json'
# sequence -> (frames, the invalid frame)
SEQUENCES = {'TS1': (48, 5), 'TS5': (40, 30)}
CHUNK_FRAMES = 32  # frames per chunk: both fixtures end in an edge chunk
MATLAB_HEADER = (b'MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: Sat Oct 17 00:00:00 '
                 b'2026 HDF5 schema 1.00 .')


def fixture_name(sequence: str) -> str:
    return f'{sequence}_annot_data.mat'


def matlab_annotations(n_frames: int, invalid, seed: int) -> dict:
    """`valid_frame` [F, 1], `annot3` and `univ_annot3` [F, 1, 17, 3] float64
    in mm, as h5py reads MATLAB's arrays: one person walking about 4 m in
    front of the camera, `invalid` frames marked 0."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)[:, None, None]
    centre = np.array([-300.0, 100.0, 4000.0]) + t * [12.0, 0.0, -5.0]
    annot3 = centre + rng.normal(0, 200, (1, 17, 3)) + rng.normal(0, 10, (n_frames, 17, 3))
    valid = np.ones((n_frames, 1))
    valid[list(np.atleast_1d(invalid))] = 0
    return dict(valid_frame=valid, annot3=annot3[:, None],
                univ_annot3=annot3[:, None] * 0.95)


def write_matlab_h5py(path, arrays: dict) -> None:
    """MATLAB v7.3's layout of `arrays`, written by h5py (module docstring)."""
    import h5py
    with h5py.File(path, 'w', userblock_size=512) as f:
        for name, value in arrays.items():
            chunks = (min(CHUNK_FRAMES, len(value)),) + value.shape[1:]
            ds = f.create_dataset(name, data=value, chunks=chunks, compression='gzip')
            ds.attrs['MATLAB_class'] = np.bytes_('double')
    with open(path, 'r+b') as f:
        f.write(MATLAB_HEADER.ljust(116, b' ') + b'\0' * 8 + b'\x00\x02IM')


def digest(value: np.ndarray) -> dict:
    value = np.ascontiguousarray(value)
    return dict(sha256=hashlib.sha256(value.tobytes()).hexdigest(), dtype=value.dtype.str,
                shape=list(value.shape))


def write_fixtures() -> dict:
    import h5py
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for i, (sequence, (n_frames, invalid)) in enumerate(SEQUENCES.items()):
        path = FIXTURE_DIR / fixture_name(sequence)
        write_matlab_h5py(path, matlab_annotations(n_frames, invalid, seed=i))
        with h5py.File(path, 'r') as f:
            manifest[path.name] = {name: digest(f[name][()]) for name in f}
    MANIFEST.write_text(json.dumps(manifest, indent=1, sort_keys=True) + '\n')
    return manifest


def read_manifest() -> dict:
    return json.loads(MANIFEST.read_text())


if __name__ == '__main__':
    written = write_fixtures()
    total = sum((FIXTURE_DIR / n).stat().st_size for n in written)
    print(f'{len(written)} fixtures, {total / 1024:.1f} KiB, in {FIXTURE_DIR}')
