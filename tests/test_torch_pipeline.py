"""The port's GPipe schedule (``repro_torch.distributed.pipeline``)
against the reference's ``pipeline_apply`` and the sequential call, on
``tests/test_pipeline_pp.py``'s case: 4 stages, 8 microbatches of 2 x 16,
``tanh(x @ w)``.  The port runs on 4 gloo ranks on the CPU (a
``FileStore`` under ``tmp_path``); the reference runs in a subprocess
with 8 host devices.  Bound 2e-5, the reference test's (measured on the
CPU: 2.4e-7 from the reference's outputs, XLA's products against
PyTorch's, and 0 from the sequential call)."""
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.distributed import pipeline
from repro_torch.launch import mesh as mesh_lib

N_STAGES, M, MB, D = 4, 8, 2, 16
TOL = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply, make_pipe_mesh
d = np.load(sys.argv[1])
out = pipeline_apply(lambda w, x: jnp.tanh(x @ w), jnp.asarray(d["w"]),
                     jnp.asarray(d["x"]), make_pipe_mesh(4))
np.save(sys.argv[2], np.asarray(out))
"""


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(N_STAGES, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M, MB, D)).astype(np.float32)
    return w, x


def _sequential(w, x):
    out = torch.from_numpy(x)
    for s in range(N_STAGES):
        out = torch.tanh(out @ torch.from_numpy(w[s]))
    return out


def _rank(rank, world, out_dir, split):
    w, x = _inputs()
    mesh = pipeline.make_pipe_mesh(N_STAGES)
    params = torch.from_numpy(w)
    if split:
        from torch.distributed.tensor import Shard, distribute_tensor
        params = distribute_tensor(params, mesh, [Shard(0)])
    out = pipeline.pipeline_apply(lambda p, v: torch.tanh(v @ p), params,
                                  torch.from_numpy(x), mesh)
    np.save(os.path.join(out_dir, f"out{rank}.npy"), out.numpy())


def _run_port(tmp_path, split):
    out_dir = str(tmp_path / ("split" if split else "full"))
    os.makedirs(out_dir)
    mesh_lib.spawn_ranks(_rank, N_STAGES, str(tmp_path), out_dir, split)
    return [np.load(os.path.join(out_dir, f"out{r}.npy"))
            for r in range(N_STAGES)]


def test_pipeline_matches_reference_and_sequential(tmp_path):
    w, x = _inputs()
    np.savez(tmp_path / "in.npz", w=w, x=x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp_path / "in.npz"),
         str(tmp_path / "ref.npy")], env=env, capture_output=True,
        text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = np.load(tmp_path / "ref.npy")
    seq = _sequential(w, x).numpy()
    outs = _run_port(tmp_path, split=False)
    for out in outs:                 # every stage holds the outputs
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out, seq, rtol=TOL, atol=TOL)


def test_pipeline_takes_stage_params_split_over_the_pipe_axis(tmp_path):
    w, x = _inputs()
    seq = _sequential(w, x).numpy()
    for out in _run_port(tmp_path, split=True):
        np.testing.assert_allclose(out, seq, rtol=TOL, atol=TOL)
