"""Multi-process training validation of `metrabs_tpu_torch` on the CPU (the
counterpart of scripts/validate_distributed_cpu.py).

Spawns TWO processes that form a gloo process group through torchrun's
environment variables (the same `parallel.mesh.init_distributed` path
`apps/train.py --distributed` uses), each one rank of a (2, 1) mesh. Each
process feeds its LOCAL half of the global batch through `device_prefetch`
(as `LocalRows`), runs the sharded train step for a few steps on different
local data, and prints a checksum of its parameters. The parent asserts
that the two processes agree, i.e. that the gradient all-reduce
synchronized them, and that `shard_example_stream` hands the processes
disjoint slices that cover every global block.

  python scripts/validate_distributed_cpu_torch.py      # the parent
  (internally re-runs itself with --rank for the two workers)
"""

import argparse
import datetime
import itertools
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = 2
STEPS = 3
GLOBAL_BATCH = 8
TIMEOUT_S = 300


def worker(rank: int, port: int):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(N_PROC), LOCAL_RANK=str(rank),
                      MASTER_ADDR='localhost', MASTER_PORT=str(port))
    import numpy as np
    import torch
    import torch.distributed as dist

    from metrabs_tpu_torch.config import ModelConfig, TrainConfig
    from metrabs_tpu_torch.data.pipeline import (device_prefetch, roundrobin_iterate,
                                                 shard_example_stream)
    from metrabs_tpu_torch.models.backbones.tiny import TinyBackbone
    from metrabs_tpu_torch.models.metrabs import Metrabs
    from metrabs_tpu_torch.parallel import mesh as mesh_mod
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, LSP_14
    from metrabs_tpu_torch.train import loop as loop_mod, optim

    torch.set_num_threads(1)
    mesh_mod.init_distributed(device='cpu', timeout=datetime.timedelta(seconds=120))
    assert dist.get_world_size() == N_PROC
    res = 64
    cfg = ModelConfig(proc_side=res, depth=4, n_joints=17, dtype='float32', backbone='tiny')
    tcfg = TrainConfig(training_steps=100)
    torch.manual_seed(0)  # the same initial weights on every rank
    model = Metrabs(cfg, TinyBackbone(width=8, use_bn=True))
    optimizer = optim.Optimizer(tcfg)
    state = loop_mod.create_train_state(model, optimizer, device='cpu')
    step_fn = loop_mod.make_train_step(model, optimizer, H36M_17, LSP_14, cfg, tcfg)
    mesh = mesh_mod.make_mesh()
    sharded_step = loop_mod.make_sharded_train_step(step_fn, mesh)

    # Each process loads its LOCAL half of the global batch: different data
    # per process (seeded by rank), as the app's sharded loaders do.
    local_n = GLOBAL_BATCH // N_PROC
    rng = np.random.default_rng(100 + rank)
    k = np.array([[250.0, 0, res / 2], [0, 250.0, res / 2], [0, 0, 1]], np.float32)

    def local_batches():
        while True:
            b3 = dict(image=rng.uniform(size=(local_n, res, res, 3)).astype(np.float32),
                      intrinsics=np.tile(k[None], (local_n, 1, 1)),
                      coords3d_true=(rng.normal(size=(local_n, 17, 3)) * 200
                                     + [0, 0, 3000]).astype(np.float32),
                      joint_validity_mask=np.ones((local_n, 17), bool))
            b2 = dict(image=rng.uniform(size=(local_n, res, res, 3)).astype(np.float32),
                      intrinsics=np.tile(k[None], (local_n, 1, 1)),
                      coords2d_true=rng.uniform(10, res - 10, size=(local_n, 14, 2)).astype(
                          np.float32),
                      joint_validity_mask=np.ones((local_n, 14), bool))
            yield b3, b2

    feed3 = device_prefetch((b3 for b3, _ in local_batches()), 'cpu', local_rows=True)
    feed2 = device_prefetch((b2 for _, b2 in local_batches()), 'cpu', local_rows=True)
    generator = torch.Generator()
    for i in range(STEPS):
        generator.manual_seed(7 * 1_000_003 + i)
        losses = sharded_step(state, next(feed3), next(feed2), generator=generator)
    # The replicated state must be identical across processes after the
    # all-reduced gradient steps.
    checksum = float(sum(p.detach().double().sum() for p in model.parameters()))

    stream = roundrobin_iterate([list(range(0, 100)), list(range(100, 200))], [2, 2],
                                np.random.default_rng(42))
    local_ids = list(itertools.islice(shard_example_stream(stream, 8, rank, N_PROC), 12))
    print(json.dumps({'rank': rank, 'loss': float(losses['loss']), 'checksum': checksum,
                      'example_ids': local_ids}), flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--rank', type=int, default=None)
    parser.add_argument('--port', type=int, default=None)
    args = parser.parse_args()
    if args.rank is not None:
        worker(args.rank, args.port)
        return

    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), '--rank', str(i),
                               '--port', str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(N_PROC)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:  # no worker is left holding the store's port
            p.kill()
        for p in procs:
            p.wait()
        raise SystemExit(f'worker timed out after {TIMEOUT_S} s')
    results = {}
    for out, p in zip(outs, procs):
        if p.returncode != 0:
            print(out)
            raise SystemExit(f'worker failed rc={p.returncode}')
        for line in out.splitlines():
            if line.startswith('{'):
                rec = json.loads(line)
                results[rec['rank']] = rec
    assert set(results) == set(range(N_PROC)), results
    c0, c1 = (results[i]['checksum'] for i in range(N_PROC))
    l0, l1 = (results[i]['loss'] for i in range(N_PROC))
    print(f'losses: {l0:.6f} / {l1:.6f}   checksums: {c0:.6f} / {c1:.6f}')
    assert c0 == c1, 'replicated params diverged across processes!'
    assert l0 == l1, 'the global loss differs across processes!'
    ids0, ids1 = (results[i]['example_ids'] for i in range(N_PROC))
    assert not set(ids0) & set(ids1), f'example streams overlap: {ids0} / {ids1}'
    assert len(set(ids0)) == len(ids0) and len(set(ids1)) == len(ids1), (
        'duplicate examples within a process slice')
    blocks = [sorted(ids0[4 * b:4 * b + 4] + ids1[4 * b:4 * b + 4]) for b in range(3)]
    assert all(len(set(b)) == 8 for b in blocks), 'a global block is not covered'
    print(f'example streams disjoint and covering: p0={ids0[:6]}... p1={ids1[:6]}...')
    print(f'DISTRIBUTED CPU VALIDATION OK ({N_PROC} processes, gloo, {STEPS} steps)')


if __name__ == '__main__':
    main()
