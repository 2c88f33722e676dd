"""Times the port's MPEG-4 Part 2 decoder on one host thread: each packet of
the 1080x1920 mp4v fixtures decoded to RGB, median milliseconds per packet,
for this checkout and for another (`--parent`, e.g. `git archive` of the
parent commit unpacked under runs/), in the order parent, this, this,
parent, each in a process of its own that imports its tree's
`metrabs_tpu_torch` (each builds its own decoder). The clips: cv2's Simple
Profile stream (FFmpeg's encoder, simple IDCT), Xvid's Simple Profile
stream (Xvid's IDCT) and Xvid's usual Advanced Simple stream (B-VOPs,
packed, quarter-pel, MPEG quantisation, GMC). A clip the other checkout
lacks or refuses is left out of its turns.

    python3 scripts/mp4v_decode_ab_torch.py --parent runs/parent [--repeats 3]

Prints the card's name and power limit (the host's CPU is the card
machine's) and one JSON line; writes it to chiprun_out/mp4v_decode_ab.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ('tests/torch_fixtures/mp4v/mp4v_1080x1920.mp4',  # cv2's Simple Profile
            'tests/torch_fixtures/mp4v/xvid_1080x1920.avi',  # Xvid's Simple Profile
            'tests/torch_fixtures/mp4v_asp/xvid_asp_usual_1080x1920.avi')  # Advanced Simple

CHILD = r'''
import json, statistics, sys, time
tree, repeats = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, tree)
from metrabs_tpu_torch.data import video
out = {}
for name in sys.argv[3:]:
    try:
        idx = video.index(f'{tree}/{name}')
        packets = [idx.packet(i) for i in range(idx.n_frames)]
        idx.decoder(0).decode(packets[0])
    except (FileNotFoundError, video.UnsupportedVideo):
        continue
    times = []
    for _ in range(repeats):
        decoder = idx.decoder(0)
        for packet in packets:
            t = time.perf_counter()
            decoder.decode(packet)
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
    (out / 'mp4v_decode_ab.json').write_text(line + '\n')
    print(line, flush=True)


if __name__ == '__main__':
    main()
