"""The port's multi-host process groups (ray_tpu_torch.parallel.multihost)
on 2 simulated hosts of 2 CPU ranks each, against the JAX package.

``spawn_local_group`` starts this file as a script once per rank (the
member entry under ``__main__``), each with torchrun's variables: host 0
holds ranks 0 and 1, host 1 ranks 2 and 3. Each member joins the process
group at the coordinator's TCP store (``initialize``), builds the global
(fsdp 2, tp 2) mesh, checks that the hosts' rows (``host_local_batch``)
make the global batch, that a slice mesh of one slice a host groups the
ranks by host, and takes 3 steps of ``make_train_step`` from the JAX
package's parameters (passed in a ``.npz`` file). The test holds every
member's losses equal, and within 1e-5 relative of JAX's
``make_train_step`` on the same (fsdp 2, tp 2) mesh of 4 CPU devices,
the bound of tests/test_torch_sharded_training.py.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

HOSTS, RANKS_PER_HOST = 2, 2
CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq_len=64)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
N_STEPS = 3
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tokens():
    return np.random.RandomState(0).randint(0, 128, (4, 32)).astype(np.int32)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _flat(v, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def _unflat(arrays):
    """The tree of ``_flat``'s keys, lists for the block indices."""
    tree = {}
    for path, x in arrays.items():
        *parents, leaf = path.strip("/").split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = x
    tree["blocks"] = [tree["blocks"][str(i)]
                      for i in range(len(tree["blocks"]))]
    return tree


def _member(coord, n_procs, pid, params_path):
    """One rank of one simulated host."""
    import torch.distributed as dist
    from ray_tpu_torch.models import (
        TrainState, TransformerConfig, make_optimizer, make_train_step,
        param_specs, shard_params_from_jax)
    from ray_tpu_torch.parallel import multihost
    from ray_tpu_torch.parallel.mesh import MeshSpec, P
    from ray_tpu_torch.parallel.slice_mesh import (
        SliceTopology, make_slice_mesh)
    torch.set_num_threads(1)
    multihost.initialize(coord, n_procs, pid, device="cpu")
    n_global = multihost.global_device_count()
    n_local = multihost.local_device_count()
    assert n_global == n_local * n_procs, (n_global, n_local, n_procs)
    assert multihost.process_index() == pid

    mesh = multihost.global_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    tokens = _tokens()
    rows = tokens.shape[0] // n_procs
    batch = multihost.host_local_batch(
        torch.from_numpy(tokens[pid * rows:(pid + 1) * rows]), mesh,
        P(("dp", "fsdp"), "sp"))
    assert torch.equal(batch.full_tensor(), torch.from_numpy(tokens))

    smesh = make_slice_mesh(SliceTopology(num_slices=n_procs,
                                          inner=MeshSpec(fsdp=n_local)))
    assert smesh.local_slice_index() == pid
    assert [{d.process_index for d in smesh.slice_devices(s)}
            for s in range(n_procs)] == [{s} for s in range(n_procs)]

    cfg = TransformerConfig(**CFG, dtype=torch.float32, remat=False)
    tx = make_optimizer(**OPT)
    with np.load(params_path) as arrays:
        params = _unflat(dict(arrays))
    p = shard_params_from_jax(params, mesh, param_specs(cfg), device="cpu")
    state = TrainState(step=0, params=p, opt_state=tx.init(p))
    step = make_train_step(cfg, tx, mesh)
    losses = []
    for _ in range(N_STEPS):
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(metrics["loss"].item())
    print(f"MEMBER-OK pid={pid} rank={dist.get_rank()} global={n_global} "
          f"losses={json.dumps(losses)}", flush=True)
    dist.destroy_process_group()


def test_train_step_over_two_simulated_hosts(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from ray_tpu.models import (
        TransformerConfig, init_params, make_optimizer, make_train_step)
    from ray_tpu.models.training import TrainState, state_specs
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh, tree_shardings
    from ray_tpu_torch.parallel.multihost import spawn_local_group

    cfg = TransformerConfig(**CFG, dtype=jnp.float32, remat=False)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                  cfg))
    params_path = str(tmp_path / "params.npz")
    np.savez(params_path, **_flat(params))
    results = spawn_local_group(
        os.path.abspath(__file__), num_processes=HOSTS,
        devices_per_process=RANKS_PER_HOST, timeout=300,
        extra_args=[params_path])
    member_losses = []
    for r in results:
        assert r.returncode == 0, r.stdout[-3000:]
        line = next(x for x in r.stdout.splitlines() if "MEMBER-OK" in x)
        assert f"global={HOSTS * RANKS_PER_HOST}" in line
        member_losses.append(json.loads(line.split("losses=")[1]))
    assert len(member_losses) == HOSTS * RANKS_PER_HOST
    assert all(m == member_losses[0] for m in member_losses), member_losses

    mesh = make_mesh(MeshSpec(fsdp=2, tp=2),
                     jax.devices()[:HOSTS * RANKS_PER_HOST])
    tx = make_optimizer(**OPT)
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams))
    state = jax.device_put(state, tree_shardings(
        mesh, state_specs(cfg, tx, jparams)))
    toks = jax.device_put(jnp.asarray(_tokens()),
                          NamedSharding(mesh, JP(("dp", "fsdp"), "sp")))
    step = make_train_step(cfg, tx, mesh, donate=False)
    j_losses = []
    for _ in range(N_STEPS):
        state, metrics = step(state, {"tokens": toks})
        j_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(member_losses[0], j_losses, rtol=REL, atol=0)


if __name__ == "__main__":
    _member(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
