"""Multi-process distributed execution (SURVEY.md §5 communication-backend
bullet).

Spawns a REAL 2-process jax.distributed CPU cluster (4 virtual devices per
process, gloo collectives over a localhost coordinator) and checks that a
sharded train/predict step whose global RMSE reduction crosses the process
boundary agrees with the single-device computation on every process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "distributed_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cluster_matches_single_device():
    nproc = 2
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)      # workers force cpu themselves
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(i), str(nproc), addr],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO, env=env)
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    for o in outs:
        assert o["nproc"] == nproc
        assert o["ndev_global"] == 8
        assert o["ndev_local"] == 4
        # the cross-process reduction must agree with the single-device run
        np.testing.assert_allclose(o["rmse_dist"], o["rmse_single"],
                                   rtol=3e-5, atol=3e-6)
        np.testing.assert_allclose(o["sum_mean_dist"], o["sum_mean_single"],
                                   rtol=3e-5, atol=1e-4)
        np.testing.assert_allclose(o["sum_var_dist"], o["sum_var_single"],
                                   rtol=3e-5, atol=1e-4)
    # both processes see the SAME fully-reduced global scalar
    np.testing.assert_allclose(outs[0]["rmse_dist"], outs[1]["rmse_dist"],
                               rtol=1e-6)
