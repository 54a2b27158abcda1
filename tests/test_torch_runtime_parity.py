"""The port's runtime against the JAX package's on the same numpy inputs,
one runtime at a time (init, scenario, shutdown) in this process: first
``ray_tpu`` on ``num_tpus=8``, then ``ray_tpu_torch`` on ``num_gpus=8``.
The two packages' runtimes share no state: each has its own module
globals, its own ``rtpu_``/``rtpt_`` names on the host and its own
collective root.

- a seeded scenario of tasks with dependencies, a tree reduce, multiple
  returns, error types and messages, actor ordering, ``wait`` and
  ``cluster_resources`` without the accelerator key, equal in every
  value;
- the collective results of 4 actors on seeded arrays, element for
  element;
- the whole slice: the tiny flagship served by an accelerator actor
  (``num_tpus=1`` in the JAX package, ``num_gpus=1`` with
  ``device="cpu"`` in the port) on the same weights, carried across by
  ``params_from_jax``; the logits within 2e-5 at fp32.
"""

import importlib
import re

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

ACCEL = ((ray_tpu, "num_tpus", "TPU"), (ray_tpu_torch, "num_gpus", "GPU"))
TINY = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=8,
            n_kv_heads=4, d_ff=352, max_seq_len=128, use_flash=True)
LOGITS_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _run(scenario, **init_kw):
    """``scenario(rt, accel_kw)`` on each package's runtime in turn."""
    outs = []
    for rt, accel, _ in ACCEL:
        rt.init(num_cpus=4, **{accel: 8}, **init_kw)
        try:
            outs.append(scenario(rt, accel))
        finally:
            rt.shutdown()
    return outs


def _error_record(e, rt):
    """The parts of a task error that do not name the package: its type
    chain, its first line and the user exception's last line."""
    names = [re.sub(r"^ray_tpu(_torch)?\.", "", f"{c.__module__}.{c.__name__}")
             for c in type(e).__mro__]
    lines = str(e).splitlines()
    return (names, lines[0], lines[-1],
            isinstance(e, rt.exceptions.TaskError),
            isinstance(e, ValueError))


def _core_scenario(rt, accel):
    rs = np.random.RandomState(0)
    xs = rs.standard_normal((16, 32)).astype(np.float32)
    out = {}

    @rt.remote
    def affine(x, k):
        return (x * k + 1.0).astype(np.float32)

    @rt.remote
    def combine(a, b):
        return a + b

    @rt.remote(num_returns=3)
    def stats(x):
        return float(x.min()), float(x.max()), x.argsort()[:4].tolist()

    @rt.remote(max_retries=0)
    def bad(x):
        raise ValueError(f"bad input {float(x.sum()):.4f}")

    @rt.remote
    def passthrough(x):
        return x

    # a chain of dependencies
    r = rt.put(xs[0])
    for k in range(1, 6):
        r = affine.remote(r, float(k))
    out["chain"] = rt.get(r)
    # a tree reduce over 16 leaves
    refs = [affine.remote(xs[i], 0.5) for i in range(16)]
    while len(refs) > 1:
        refs = [combine.remote(refs[i], refs[i + 1])
                for i in range(0, len(refs), 2)]
    out["tree"] = rt.get(refs[0])
    out["stats"] = rt.get(list(stats.remote(xs[3])))
    errors = []
    for ref in (bad.remote(xs[4]), passthrough.remote(bad.remote(xs[5]))):
        try:
            rt.get(ref)
            errors.append(None)
        except Exception as e:  # noqa: BLE001
            errors.append(_error_record(e, rt))
    out["errors"] = errors

    @rt.remote
    class Appender:
        def __init__(self, scale):
            self.items = []
            self.scale = scale

        def add(self, x):
            self.items.append(float(x) * self.scale)
            return len(self.items)

        def get(self):
            return self.items

    a = Appender.remote(3.0)
    for v in xs[6, :20]:
        a.add.remote(float(v))
    out["actor"] = rt.get(a.get.remote())
    rt.kill(a)

    ready_refs = [affine.remote(xs[i], 2.0) for i in range(4)]
    ready, not_ready = rt.wait(ready_refs, num_returns=4, timeout=30)
    out["wait"] = (len(ready), len(not_ready),
                   [rt.get(x).tolist() for x in ready])
    res = rt.cluster_resources()
    out["accel"] = res.pop(dict((a, k) for _, a, k in ACCEL)[accel])
    out["resources"] = res
    return out


def test_core_scenario_matches_the_jax_package():
    ref, port = _run(_core_scenario, max_process_workers=2)
    assert ref["errors"][0] is not None and ref["errors"][0][3:] == (
        True, True)
    assert port["errors"] == ref["errors"]
    assert port["actor"] == ref["actor"]
    assert port["stats"] == ref["stats"]
    assert port["wait"][:2] == ref["wait"][:2] == (4, 0)
    assert sorted(port["wait"][2]) == sorted(ref["wait"][2])
    assert port["resources"] == ref["resources"]
    assert port["accel"] == ref["accel"] == 8.0
    np.testing.assert_array_equal(port["chain"], ref["chain"])
    np.testing.assert_array_equal(port["tree"], ref["tree"])


def _collective_scenario(rt, accel):
    col = importlib.import_module(f"{rt.__name__}.collective")
    rs = np.random.RandomState(7)
    data = rs.standard_normal((4, 24)).astype(np.float32)

    @rt.remote
    class Rank:
        def _join_collective_group(self, world, rank, backend, name):
            col.init_collective_group(world, rank, backend, name,
                                      timeout_s=20.0)
            self._group, self._rank = name, rank
            return rank

        def run(self, x):
            g = self._group
            return {
                "allreduce": col.allreduce(x, g),
                "allreduce_max": col.allreduce(x, g, op=col.ReduceOp.MAX),
                "allgather": np.stack(col.allgather(x, g)),
                "reducescatter": col.reducescatter(x, g),
                "broadcast": col.broadcast(x, 2, g),
            }

        def leave(self):
            col.destroy_collective_group(self._group)

    ranks = [Rank.options(num_cpus=0.5).remote() for _ in range(4)]
    name = col.create_collective_group(ranks, world_size=4,
                                       ranks=[0, 1, 2, 3])
    try:
        outs = rt.get([r.run.remote(data[i]) for i, r in enumerate(ranks)],
                      timeout=60)
        rt.get([r.leave.remote() for r in ranks], timeout=30)
    finally:
        col.destroy_collective_group(name)
    return data, outs


def test_collective_results_match_the_jax_package():
    (data, ref), (_, port) = _run(_collective_scenario,
                                  max_process_workers=4)
    for rank in range(4):
        for key, want in ref[rank].items():
            np.testing.assert_array_equal(port[rank][key], want, err_msg=key)
    np.testing.assert_allclose(port[0]["allreduce"], data.sum(0), rtol=1e-6)
    np.testing.assert_array_equal(port[1]["allreduce_max"], data.max(0))
    np.testing.assert_array_equal(port[3]["allgather"], data)
    np.testing.assert_array_equal(port[0]["broadcast"], data[2])
    np.testing.assert_allclose(port[2]["reducescatter"],
                               data.sum(0)[12:18], rtol=1e-6)


def _serve_scenario(rt, accel):
    """The tiny flagship's weights from seed 0 (the JAX package's
    ``init_params``) and seeded tokens go in as refs; an accelerator
    actor returns the logits."""
    import jax
    import jax.numpy as jnp

    jt = importlib.import_module("ray_tpu.models.transformer")
    jcfg = jt.TransformerConfig(**TINY, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray,
                        jt.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.RandomState(1).randint(0, 256, (1, 128)).astype(
        np.int32)

    if rt is ray_tpu:
        @rt.remote(num_tpus=1)
        class Replica:
            def __init__(self, weights):
                self.params = jax.tree.map(jnp.asarray, weights)

            def answer(self, toks):
                return np.asarray(jt.forward(self.params, jnp.asarray(toks),
                                             jcfg))
        tokens_ref = rt.put(tokens)
    else:
        from ray_tpu_torch.models import TransformerConfig, params_from_jax
        from ray_tpu_torch.models.transformer import forward

        pcfg = TransformerConfig(**TINY, dtype=torch.float32)

        @rt.remote(num_gpus=1)
        class Replica:
            def __init__(self, weights):
                self.params = params_from_jax(weights, device="cpu")

            def answer(self, toks):
                with torch.no_grad():
                    return forward(self.params, toks, pcfg).numpy()
        tokens_ref = rt.put(torch.from_numpy(tokens))

    replica = Replica.remote(rt.put(tree))
    logits = rt.get(replica.answer.remote(tokens_ref), timeout=120)
    rt.kill(replica)
    return logits


def test_served_flagship_matches_the_jax_package():
    ref, port = _run(_serve_scenario, max_process_workers=1)
    assert port.shape == ref.shape == (1, 128, 256)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, atol=LOGITS_TOL, rtol=0)
