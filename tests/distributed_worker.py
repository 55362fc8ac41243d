"""Worker process for tests/test_distributed.py.

Usage: python distributed_worker.py <process_id> <num_processes> <addr>

Joins a jax.distributed CPU cluster (4 virtual devices per process, gloo
collectives), builds the global (data x chain) mesh, runs the sharded
sparse-GP train+predict step with a global RMSE reduction across process
boundaries, and prints one JSON line with the distributed result and the
process-local single-device reference.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

# the cluster under test is CPU-only, whatever accelerator the host has
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")


def main():
    pid, nproc, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    from gp_compressor_jax.parallel import distributed as dist

    dist.initialize(coordinator_address=addr, num_processes=nproc,
                    process_id=pid)
    assert jax.process_count() == nproc

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as ge
    from gp_compressor_jax.config import MeshConfig
    from gp_compressor_jax.models import sparse_gp
    from gp_compressor_jax.ops.kernels import RBFParams
    from gp_compressor_jax.ops.noise import GaussianNoise

    mesh = dist.global_mesh(MeshConfig(chain_size=1))
    ndev = jax.device_count()

    cfg = ge._config()
    B = ndev * 4
    X, Y, mask, Xs = ge._example(B, Pn=24, G=32, seed=3)
    kp = RBFParams(sigmaf_sq=jnp.asarray(100.0, jnp.float32),
                   l_sq=jnp.asarray(1.0, jnp.float32))
    noise = GaussianNoise(s20=jnp.asarray(0.1, jnp.float32))

    def step(X, Y, mask, Xs):
        states = sparse_gp.init_batch(cfg, X.shape[0])
        states = sparse_gp.add_points_batch(kp, noise, cfg, states, X, Y,
                                            mask)
        mean, var = sparse_gp.predict_batch(kp, cfg.s20, states, Xs)
        tmean, _ = sparse_gp.predict_batch(kp, cfg.s20, states, X)
        # the global reduction that must cross the process (DCN) boundary
        err2 = jnp.sum(jnp.where(mask, (tmean[..., 0] - Y[..., 0]) ** 2, 0.0))
        rmse = jnp.sqrt(err2 / jnp.maximum(jnp.sum(mask), 1))
        return rmse, jnp.sum(mean), jnp.sum(var)

    # ---- distributed: shard the patch axis over the global mesh ---------
    sh = NamedSharding(mesh, P("data"))
    sl = dist.process_local_slice(B)
    gl = lambda a: jax.make_array_from_process_local_data(
        sh, np.asarray(a[sl]), a.shape)
    out = jax.jit(step)(gl(X), gl(Y), gl(mask), gl(Xs))
    rmse_d, smean_d, svar_d = map(float, jax.block_until_ready(out))

    # ---- reference: the same step on this process's first device --------
    one = jax.local_devices()[0]
    args1 = [jax.device_put(np.asarray(a), one) for a in (X, Y, mask, Xs)]
    rmse_1, smean_1, svar_1 = map(float, jax.jit(step)(*args1))

    print(json.dumps({
        "pid": pid, "nproc": jax.process_count(), "ndev_global": ndev,
        "ndev_local": len(jax.local_devices()),
        "rmse_dist": rmse_d, "rmse_single": rmse_1,
        "sum_mean_dist": smean_d, "sum_mean_single": smean_1,
        "sum_var_dist": svar_d, "sum_var_single": svar_1,
    }), flush=True)


if __name__ == "__main__":
    main()
