"""Times the port's H.264 and HEVC decoders on one host thread: each packet
of the 1080x1920 libx264 and libx265 fixtures (I and P slices, and B
slices) decoded (to RGB and planes of the frames it outputs), median
milliseconds per packet, for this checkout and for another (`--parent`,
e.g. `git archive` of the parent commit unpacked under runs/), in the order
parent, this, this, parent, each in a process of its own that imports its
tree's `metrabs_tpu_torch` (each builds its own decoders). A clip the other
checkout lacks or refuses is left out of its turns.

    python3 scripts/h264_decode_ab_torch.py --parent runs/parent [--repeats 3]

Prints the card's name and power limit (the host's CPU is the card
machine's) and one JSON line; writes it to chiprun_out/h264_decode_ab.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ('tests/torch_fixtures/h264/h264_1080x1920.mp4',  # I and P slices
            'tests/torch_fixtures/h264_b/h264b_1080x1920.mp4',  # B slices
            'tests/torch_fixtures/hevc/hevc_1080x1920.mp4',  # I and P slices
            'tests/torch_fixtures/hevc_b/hevcb_1080x1920.mp4')  # B slices

CHILD = r'''
import json, statistics, sys, time
tree, repeats = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, tree)
from metrabs_tpu_torch.data import video
out = {}
for name in sys.argv[3:]:
    try:
        idx = video.index(f'{tree}/{name}')
    except (FileNotFoundError, video.UnsupportedVideo):
        continue
    packets = [idx.packet(i) for i in range(idx.n_frames)]
    times = []
    for _ in range(repeats):
        decoder = idx.decoder(0)
        for packet in packets:
            t = time.perf_counter()
            decoder.decode(packet, planes=True)
            times.append(time.perf_counter() - t)
        decoder.close()
    out[name] = dict(median_ms=statistics.median(times) * 1e3, n=len(times))
print(json.dumps(out))
'''


def card() -> str:
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return 'no card'


def run(tree: Path, repeats: int) -> dict:
    proc = subprocess.run([sys.executable, '-c', CHILD, str(tree.resolve()), str(repeats),
                           *FIXTURES], capture_output=True, text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', required=True, help='a checkout of the commit to compare with')
    ap.add_argument('--repeats', type=int, default=3, help='passes over each clip per turn')
    args = ap.parse_args()
    turns = [('parent', Path(args.parent)), ('this', ROOT), ('this', ROOT),
             ('parent', Path(args.parent))]
    results = {'parent': [], 'this': []}
    for label, tree in turns:
        results[label].append(run(tree, args.repeats))
        print(f'{label}: {json.dumps(results[label][-1])}', flush=True)
    summary = {label: {name: [turn[name]['median_ms'] for turn in runs if name in turn]
                       for name in FIXTURES} for label, runs in results.items()}
    print(card(), flush=True)
    line = json.dumps({'card': card(), 'median_ms_per_packet': summary})
    out = ROOT / 'chiprun_out'
    out.mkdir(exist_ok=True)
    (out / 'h264_decode_ab.json').write_text(line + '\n')
    print(line, flush=True)


if __name__ == '__main__':
    main()
