"""The port's scheduling program against the JAX package's on 20 seeded
random clusters (N 8-300, K 1-8, R 4), on the CPU: packed outputs and the
new availability equal element for element. A file of its own, beside
``tests/test_torch_scheduler.py``, so that each file's JAX compiles stay
within the port's CPU-cost budget.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private.scheduler.tpu_policy import _schedule_classes_kernel

tp = importlib.import_module("ray_tpu_torch._private.scheduler.tpu_policy")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _assert_programs_equal(avail, total, alive, demands, counts, prefs,
                           threshold=0.5):
    arrays = (np.asarray(avail, np.float32), np.asarray(total, np.float32),
              np.asarray(alive, bool), np.asarray(demands, np.float32),
              np.asarray(counts, np.int32), np.asarray(prefs, np.int32))
    want, want_avail = _schedule_classes_kernel(
        *(jnp.asarray(a) for a in arrays), jnp.float32(threshold),
        num_classes=len(arrays[4]))
    got, got_avail = tp.schedule_classes_plain(
        *(torch.from_numpy(a.copy()) for a in arrays), threshold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_avail.numpy(), np.asarray(want_avail))


def _random_cluster(seed):
    rs = np.random.RandomState(seed)
    n, k = int(rs.randint(8, 301)), int(rs.randint(1, 9))
    total = np.zeros((n, 4), np.float32)
    total[:, 0] = rs.choice([4, 8, 16, 32], n)
    total[:, 1] = rs.choice([0, 0, 4, 8], n)
    total[:, 2] = rs.choice([16, 64, 128], n)
    total[:, 3] = rs.choice([0, 0, 0, 1], n)
    avail = np.maximum(total * (1 - rs.uniform(0, 0.6, (n, 1))), 0)
    alive = rs.rand(n) > 0.1
    demands = np.zeros((k, 4), np.float32)
    demands[:, 0] = rs.choice([0.5, 1, 2, 3], k)
    demands[:, 1] = rs.choice([0, 0, 1], k)
    demands[:, 2] = rs.choice([0, 1, 4], k)
    demands[:, 3] = rs.choice([0, 0, 0, 1], k)
    counts = rs.randint(0, 400, k)
    prefs = np.where(rs.rand(k) < 0.5, rs.randint(0, n, k), -1)
    # padded as the policy pads them: nodes to a power of two (dead, empty
    # rows), classes to a power of two (zero counts)
    n_pad, k_pad = tp._bucket(n) - n, tp._bucket(k, minimum=1) - k
    return (np.pad(avail, ((0, n_pad), (0, 0))),
            np.pad(total, ((0, n_pad), (0, 0))), np.pad(alive, (0, n_pad)),
            np.pad(demands, ((0, k_pad), (0, 0))), np.pad(counts, (0, k_pad)),
            np.pad(prefs, (0, k_pad), constant_values=-1))


@pytest.mark.parametrize("seed", range(20))
def test_random_clusters(seed):
    """Seeded random clusters: N 8-300, K 1-8, R 4, dead nodes, preferred
    nodes, fractional demands; padded as ``schedule_batch`` pads them."""
    _assert_programs_equal(*_random_cluster(seed))


