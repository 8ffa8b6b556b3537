"""Shared harness of the port's map-sharded parity tests
(``test_torch_*_sharded.py``, ``test_torch_distributed.py``): the reference
package's sharded step on the test suite's virtual CPU devices, in the pytest
process, and the port's as worker processes of
``python -m pfilter_tpu_torch.run_distributed --device cpu`` (gloo, one
process per cell of the seq x map grid, one intra-op thread each) in its
file-in, file-out mode, so that no worker imports JAX."""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from pfilter_tpu.parallel import mesh as jmesh

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 600


def leaves(tree, prefix: str = "") -> dict:
    """A reference-package pytree of NamedTuples -> ``{dotted name: numpy}``."""
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(leaves(getattr(tree, f), f"{prefix}{f}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def run_reference(module, cfg, xyz, mask, n_seq: int, n_map: int, n_frames: int, keep=()):
    """The reference's sharded step (``module`` is its ``es_sharded`` or
    ``bpf_sharded``) over ``xyz [n_seq, F, N, 3]``: per-frame poses
    ``[n_seq, F, ...]``, diagnostics, and the global state after each frame
    in ``keep`` (numpy)."""
    mesh = jmesh.make_mesh(n_seq, n_map)
    state = module.init_sharded_state(cfg, n_seq, n_map)
    first = module.make_sharded_step(cfg, mesh, first=True)
    step = module.make_sharded_step(cfg, mesh, first=False) if n_frames > 1 else None
    qs, ts, diags, states = [], [], [], {}
    for i in range(n_frames):
        state, diag = (first if i == 0 else step)(state, jnp.asarray(xyz[:, i]), jnp.asarray(mask[:, i]))
        qs.append(np.asarray(state.pose.q))
        ts.append(np.asarray(state.pose.t))
        diags.append(jax.device_get(diag))
        if i in keep:
            states[i] = jax.device_get(state)
    return dict(q=np.stack(qs, 1), t=np.stack(ts, 1), diags=diags, states=states)


def write_scans(path: Path, xyz, mask) -> str:
    np.savez(path, xyz=np.asarray(xyz, np.float32), mask=np.asarray(mask, bool))
    return str(path)


def write_state(path: Path, state) -> str:
    np.savez(path, **leaves(state))
    return str(path)


def job(cfg, n_seq: int, n_map: int, scans: str, out: Path, **extra) -> dict:
    """One file-in, file-out job of ``run_distributed`` for a reference-package config."""
    return dict(mode=cfg.mode, n_seq=n_seq, n_map=n_map, config=dataclasses.asdict(cfg), scans=scans, out=str(out), **extra)


class Workers:
    """``world`` worker processes of ``run_distributed --device cpu`` over
    one gloo group (file-initialised in ``tmp``), running ``jobs`` in order,
    or (``jobs`` None) rendering their scans with the flags ``argv``."""

    def __init__(self, tmp: Path, name: str, world: int, jobs, argv=()):
        argv = list(argv)
        if jobs is not None:
            jobs_path = tmp / f"{name}_jobs.json"
            jobs_path.write_text(json.dumps({"jobs": jobs}))
            argv += ["--jobs", str(jobs_path)]
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        self.logs = [tmp / f"{name}_rank{r}.log" for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:
                cmd = [
                    sys.executable, "-m", "pfilter_tpu_torch.run_distributed", "--device", "cpu",
                    "--rank", str(r), "--world-size", str(world), "--init-method", f"file://{tmp / (name + '_pg')}",
                ] + argv
                self.procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))

    def wait(self) -> str:
        """Wait for every worker (killing all if one fails or time runs out);
        returns rank 0's output."""
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        try:
            while any(p.poll() is None for p in self.procs) and time.monotonic() < deadline:
                if any(p.returncode not in (None, 0) for p in self.procs):
                    break  # the others would wait in a collective for ever
                time.sleep(0.2)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(self.procs, self.logs):
            if p.returncode != 0:
                raise RuntimeError(f"worker {log.name} exited {p.returncode}:\n{log.read_text()[-4000:]}")
        return self.logs[0].read_text()


def rank_output(out: Path, rank: int) -> dict:
    with np.load(Path(out) / f"rank{rank}.npz") as z:
        return dict(z)
