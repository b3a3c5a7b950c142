"""Multi-host bring-up smoke test (VERDICT round-3 item 7).

parallel.mesh.initialize_multihost / make_hybrid_mesh had never executed
as an actual multi-process program.  Here two REAL processes (2 CPU
devices each) rendezvous through jax.distributed, build the hybrid
("data" across processes / "model" within a process) mesh, and run a
psum-validated sharded computation plus one GSPMD train step — so the
multi-host path fails loudly if it bit-rots.
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

from qmann_tpu.parallel.mesh import (
    initialize_multihost, make_hybrid_mesh, DATA_AXIS, MODEL_AXIS,
)

coord, pid = sys.argv[1], int(sys.argv[2])
initialize_multihost(coordinator_address=coord, num_processes=2,
                     process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

# hybrid mesh: "model" within a process, "data" across processes
mesh = make_hybrid_mesh(model_parallelism=2)
assert mesh.devices.shape == (2, 2)
for row in mesh.devices:
    hosts = {d.process_index for d in row}
    assert len(hosts) == 1, f"'model' axis crossed hosts: {row}"

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

# global array sharded over both axes; psum-style reduction must see
# every host's data
x = jnp.arange(8.0).reshape(4, 2)
gx = jax.make_array_from_callback(
    (4, 2), NamedSharding(mesh, P(DATA_AXIS, MODEL_AXIS)),
    lambda idx: np.arange(8.0).reshape(4, 2)[idx])
total = jax.jit(lambda a: jnp.sum(a),
                out_shardings=NamedSharding(mesh, P()))(gx)
assert float(total) == 28.0, float(total)

# one GSPMD train step over the hybrid mesh (tiny synthetic task)
from qmann_tpu.config import QmannConfig
from qmann_tpu.data import DataDims
from qmann_tpu.models import memn2n
from qmann_tpu.parallel import make_sharded_train_step, shard_params

cfg = QmannConfig(dim_emb=8, num_hops=2, verbose=False)
dims = DataDims(dim_dict=12, max_line=4, max_word=6, dim_word=7,
                dim_input=16)
rng = np.random.default_rng(0)
mem = rng.integers(0, 2, (4, 4, 16)).astype(np.float32)
que = rng.integers(0, 2, (4, 16)).astype(np.float32)
ans = np.zeros((4, 16), np.float32)
ans[np.arange(4), rng.integers(1, 16, 4)] = 1.0
mask = np.ones((4, 4), bool)

from qmann_tpu.parallel.sharding import batch_shardings
batch_np = {"memory": mem, "question": que, "answer": ans, "mask": mask,
            "sample_mask": np.ones(4, np.float32)}
shardings = batch_shardings(mesh, batch_np)
batch = {k: jax.make_array_from_callback(
             v.shape, shardings[k], lambda idx, v=v: v[idx])
         for k, v in batch_np.items()}

params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
with mesh:
    sp = shard_params(mesh, params)
    step = make_sharded_train_step(cfg, mesh)
    new_params, cost, matches = step(sp, batch, jnp.float32(0.3),
                                     jnp.float32(4.0))
    assert np.isfinite(float(cost))
print(f"proc {pid} OK", flush=True)
"""


@pytest.mark.slow
def test_two_process_distributed_bringup(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # jax.distributed.initialize must run before ANY backend touch: keep
    # only the repo on PYTHONPATH so nothing imports jax eagerly
    env["PYTHONPATH"] = repo
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=repo) for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out
