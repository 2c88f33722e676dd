"""Rank workers of the port's multi-process tests (tests/test_torch_parallel.py).

This module imports no jax: spawned ranks import it to find their worker.
`run_world(worker, world_size, payload)` starts `world_size` processes on
the CPU; each joins a gloo process group (with a timeout, so that a hung
collective fails in under a minute) unless `init=False`, runs
`worker(rank, world_size, payload)` on one intra-op thread and sends back
what it returns. The parent reads the results with a deadline and kills
the ranks still running past it, so that a hung rank fails the test in
under 2 minutes. The payload crosses to the ranks as plain pickle bytes
(multiprocessing's own pickler would move its tensors to shared memory,
which the ranks would then update together); workers return numpy arrays
and plain containers.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import socket
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 115  # a hung rank fails the test in under 2 minutes
PG_TIMEOUT = datetime.timedelta(seconds=60)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(worker, rank, world_size, port, init, payload, results):
    try:
        import torch
        torch.set_num_threads(1)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                          MASTER_ADDR='localhost', MASTER_PORT=str(port))
        if init:
            from metrabs_tpu_torch.parallel import mesh
            mesh.init_process_group('gloo', f'tcp://localhost:{port}', rank, world_size,
                                    timeout=PG_TIMEOUT)
        out = worker(rank, world_size, pickle.loads(payload))
        results.put((rank, 'ok', out))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, 'error', traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(worker, world_size: int, payload=None, init: bool = True,
              deadline_s: float = DEADLINE_S) -> list:
    """[worker's result on rank r for r in range(world_size)]; raises
    RuntimeError with the rank's traceback where a rank fails, or where the
    deadline passes."""
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(worker, rank, world_size, port, init, pickle.dumps(payload),
                               results),
                         daemon=True) for rank in range(world_size)]
    for p in procs:
        p.start()
    out, errors = {}, []
    start = datetime.datetime.now()
    try:
        while len(out) + len(errors) < world_size:
            left = deadline_s - (datetime.datetime.now() - start).total_seconds()
            try:
                rank, status, value = results.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise RuntimeError(f'ranks {sorted(set(range(world_size)) - set(out))} did '
                                   f'not finish within {deadline_s} s') from None
            if status == 'ok':
                out[rank] = value
            else:
                errors.append(f'rank {rank}:\n{value}')
                break
        if errors:
            raise RuntimeError('\n'.join(errors))
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]


def numpy_tree(tree):
    """Tensors (any dtype) -> float32 or native numpy arrays, copied,
    recursively."""
    import torch
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return tree


def state_results(state, grads=None) -> dict:
    """The full train state after a step (tensor-parallel leaves gathered,
    a collective), as numpy: params, ema, mu, nu (group 'all'), buffers,
    step, and each parameter's checksum."""
    from metrabs_tpu_torch.train import loop
    full = loop.full_train_state_dict(state)
    params = {n: full['model'][n] for n, _ in state.model.named_parameters()}
    adam = full['opt_state']['groups']['all']
    out = dict(params=params, ema=full['ema_params'], mu=adam['mu'], nu=adam['nu'],
               buffers={k: v for k, v in full['model'].items()
                        if k.endswith(('running_mean', 'running_var'))},
               step=state.step, sharded=list(state.sharded))
    if grads is not None:
        out['grads'] = grads
    out = numpy_tree(out)
    out['checksum'] = float(sum(np.float64(np.abs(v).sum()) for v in out['params'].values()))
    return out


def train_steps(rank, world_size, payload):
    """Each job of `payload['jobs']`: a (n_data, n_model) mesh, the port's
    state (a pickled `train.loop.TrainState` with its configs), one sharded
    step on the global batches and mix (with `tp_min_size`: tensor-parallel
    by `tp_shardings`); returns per job the full state after it and the
    step's losses and gradients (tensor-parallel gradients gathered)."""
    import torch
    from metrabs_tpu_torch.parallel import mesh as mesh_mod
    from metrabs_tpu_torch.pipeline import skeletons
    from metrabs_tpu_torch.train import loop, optim

    results = []
    for job in payload['jobs']:
        mesh = mesh_mod.make_mesh(*job['mesh'])
        state, pcfg, ptcfg = job['state'], job['cfg'], job['tcfg']
        optimizer = optim.Optimizer(ptcfg)
        step = loop.make_train_step(state.model, optimizer, skeletons.H36M_17,
                                    skeletons.LSP_14, pcfg, ptcfg,
                                    bn_inference=job.get('bn_inference', False))
        shardings = (mesh_mod.tp_shardings(mesh, state, min_size=job['tp_min_size'])
                     if job.get('tp_min_size') else None)
        sharded = loop.make_sharded_train_step(step, mesh, state_shardings=shardings)
        losses = sharded(state, job['b3'], job['b2'], mix=torch.tensor(job['mix']))
        grads = {n: p.grad for n, p in state.model.named_parameters()}
        if state.sharded:
            grads = mesh_mod.gather_named(grads, state.sharded, mesh)
        results.append(dict(losses=numpy_tree(losses), **state_results(state, grads)))
    return results


def serve(rank, world_size, payload):
    """`payload['package']` loaded on the CPU over a (n_data, n_model) mesh
    (`payload['mesh']`; with `tp_min_size` tensor-parallel, with `fused`
    unfolded with `fuse_mbconv='on'`), then each call of `payload['calls']`
    ((method name, args, kwargs)) made alike on every rank; returns the
    results as numpy, or the message of the ValueError a call raised. Rank
    0 also makes the first `payload['reference']` calls on the one-rank
    estimator (no mesh) in the same process, as 'reference' (the test's
    own process has run XLA, which changes the CPU's floating-point
    state)."""
    import functools
    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(*payload['mesh'])
    kwargs = {}
    if payload.get('fused'):
        kwargs = dict(cfg_overrides={'bn_fold': False},
                      backbone_builder=functools.partial(build_backbone, fuse_mbconv='on'))

    def calls(est, calls):
        out = []
        for name, args, call_kwargs in calls:
            try:
                out.append(numpy_tree(getattr(est, name)(*args, **call_kwargs)))
            except ValueError as e:
                out.append(str(e))
        return out

    est = load_pose_estimator(payload['package'], device='cpu', mesh=mesh,
                              tp_min_size=payload.get('tp_min_size'), **kwargs)
    out = dict(results=calls(est, payload['calls']),
               sharded=[n for n, p in est.crop_model.named_parameters()
                        if mesh_mod.is_sharded(p)])
    if rank == 0:
        one = load_pose_estimator(payload['package'], device='cpu', **kwargs)
        out['reference'] = calls(one, payload['calls'][:payload.get('reference', 0)])
    return out


def app_runs(rank, world_size, payload):
    """`apps.train.main(argv + ['--distributed'])` for each (argv, port) of
    `payload['runs']` in turn, under torchrun's environment; returns the
    count of '.pt' files rank by rank sees after each run."""
    import pathlib
    from metrabs_tpu_torch.apps import train
    seen = []
    for argv, port in payload['runs']:
        os.environ['MASTER_PORT'] = str(port)
        train.main(argv + ['--distributed'])
        seen.append(sorted(p.name for p in pathlib.Path(payload['checkpoint_dir']).glob('*.pt')))
    return seen


def replicate(rank, world_size, payload):
    """`parallel.mesh.replicate` of tensors that differ by rank: every rank
    ends with rank 0's."""
    import torch
    from metrabs_tpu_torch.parallel import mesh as mesh_mod
    tree = {'a': torch.full((3,), float(rank)), 'b': [torch.arange(4) * (rank + 1)]}
    return numpy_tree(mesh_mod.replicate(mesh_mod.make_mesh(world_size, 1), tree))


def several(rank, world_size, payload):
    """Each (worker name, payload) of `payload` in turn on one world: the
    list of their results."""
    return [globals()[name](rank, world_size, p) for name, p in payload]
