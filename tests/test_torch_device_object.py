"""Device tier of the port's object plane
(``ray_tpu_torch/_private/device_object.py``): the cases of the JAX
package's ``test_device_object.py`` on torch tensors. A tensor put into
the store stays where it lives; same-process ``get`` returns the
identical object; a host copy is made only when the object crosses a
process boundary, and arrives there as a CPU tensor; the reference count
frees it. Tensors on the CPU take the tier as a ``jax.Array`` on JAX's
CPU backend does, which is what lets these cases run here; the cases on
CUDA tensors are marked ``cuda`` and skip without a card."""

import gc
import importlib

import numpy as np
import pytest
import torch

import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    w = ray_tpu_torch.init(num_cpus=4, max_process_workers=2)
    # the scheduling policy's device probe allocates on the card from a
    # thread of its own: let it finish before memory is counted
    tp = importlib.import_module("ray_tpu_torch._private.scheduler.tpu_policy")
    for thread in list(tp._device_rt_threads.values()):
        thread.join(timeout=60)
    yield w
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def _total(x):
    import torch as _torch
    return (float(x.double().sum()), type(x).__name__, x.device.type,
            _torch.cuda.is_available())


def test_put_get_zero_copy(ray_start_regular):
    w = ray_start_regular
    t = torch.arange(1024, dtype=torch.float32)
    ref = ray_tpu_torch.put(t)
    got = ray_tpu_torch.get(ref)
    assert got is t  # the SAME tensor — no host round-trip
    stats = w.device_store.stats()
    assert stats["num_objects"] == 1
    assert stats["num_spilled_to_host"] == 0
    assert stats["hbm_bytes"] == t.nbytes


def test_view_layout_preserved(ray_start_regular):
    """A strided view round-trips as itself: its storage, offset and
    strides untouched (the reference's sharded-array case: the object
    plane never gathers the value into a new buffer)."""
    base = torch.arange(4096.0).reshape(8, 512)
    view = base[1::2, 3:]
    got = ray_tpu_torch.get(ray_tpu_torch.put(view))
    assert got is view
    assert got.stride() == (1024, 1) and got.storage_offset() == 515
    assert got.untyped_storage().data_ptr() == \
        base.untyped_storage().data_ptr()


def test_device_object_crosses_process_via_host_copy(ray_start_regular):
    """A worker-process consumer forces a one-time host materialization;
    the device copy stays primary."""
    w = ray_start_regular
    t = torch.arange(100_000, dtype=torch.float32)
    ref = ray_tpu_torch.put(t)
    total, kind, device, cuda = ray_tpu_torch.get(_total.remote(ref))
    assert total == float(np.arange(100_000, dtype=np.float64).sum())
    assert (kind, device, cuda) == ("Tensor", "cpu", False)
    assert w.device_store.stats()["num_spilled_to_host"] == 1
    assert ray_tpu_torch.get(ref) is t          # still the primary


def test_refcount_frees_device_object(ray_start_regular):
    w = ray_start_regular
    ref = ray_tpu_torch.put(torch.ones(1000))
    oid = ref.id()
    assert w.device_store.contains(oid)
    del ref
    gc.collect()
    assert not w.device_store.contains(oid)


def test_mutation_after_put_is_seen(ray_start_regular):
    """The one difference from the reference that mutability forces: the
    store holds the tensor itself, so an in-place change after ``put`` is
    seen by a same-process ``get`` and by a host copy made afterwards,
    while ``put(t.clone())`` keeps a snapshot."""
    t = torch.zeros(4)
    ref = ray_tpu_torch.put(t)
    snap = ray_tpu_torch.put(t.clone())
    t.add_(3)
    assert torch.equal(ray_tpu_torch.get(ref), torch.full((4,), 3.0))
    assert torch.equal(ray_tpu_torch.get(snap), torch.zeros(4))
    assert ray_tpu_torch.get(_total.remote(ref))[0] == 12.0


def test_gpu_actor_on_a_thread_gets_the_identical_tensor(ray_start_regular):
    """Work that demands GPU runs on a thread of the driver: a device
    object reaches it as the very tensor that was put, with no host
    copy (the reference's in-process workers get a host copy)."""
    w = ray_start_regular

    @ray_tpu_torch.remote(num_gpus=1)
    class Holder:
        def __init__(self, t):
            self.t = t

        def same(self, t):
            return t is self.t, t.data_ptr()

    t = torch.arange(64.0)
    ref = ray_tpu_torch.put(t)
    holder = Holder.remote(ref)
    assert ray_tpu_torch.get(holder.same.remote(ref)) == (True, t.data_ptr())
    assert w.device_store.stats()["num_spilled_to_host"] == 0
    ray_tpu_torch.kill(holder)


def test_gpu_consumer_mutating_its_argument_changes_the_object(
        ray_start_regular):
    """Because a GPU-demand consumer receives the stored tensor itself, an
    in-place change it makes is seen by every later ``get``, by the next
    consumer of the same ref, by a retry of the task and by the caller's
    own handle. A CPU task in a process worker changes only its host
    copy. Consumers must not mutate their arguments."""
    @ray_tpu_torch.remote(num_gpus=1, max_retries=1, retry_exceptions=True)
    def bump(x, fail_first):
        x.add_(1)
        if fail_first and float(x.sum()) == 4.0:
            raise ValueError("the first attempt fails after its mutation")
        return float(x.sum())

    @ray_tpu_torch.remote
    def bump_in_a_process(x):
        x.add_(100)
        return float(x.sum())

    t = torch.zeros(4)
    ref = ray_tpu_torch.put(t)
    # the retry starts from what the failed attempt left behind
    assert ray_tpu_torch.get(bump.remote(ref, True)) == 8.0
    assert torch.equal(t, torch.full((4,), 2.0))
    assert ray_tpu_torch.get(bump.remote(ref, False)) == 12.0
    assert ray_tpu_torch.get(ref) is t
    assert torch.equal(t, torch.full((4,), 3.0))
    assert ray_tpu_torch.get(bump_in_a_process.remote(ref)) == 412.0
    assert torch.equal(ray_tpu_torch.get(ref), torch.full((4,), 3.0))


@pytest.mark.cuda
def test_cuda_put_get_zero_copy_and_free(ray_on_card):
    w = ray_on_card
    t = torch.ones(1 << 20, device="cuda")
    nbytes = t.nbytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ref = ray_tpu_torch.put(t)
    assert ray_tpu_torch.get(ref) is t
    assert w.device_store.stats()["hbm_bytes"] == nbytes
    del t, ref
    gc.collect()
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated() == nbytes


@pytest.mark.cuda
def test_cuda_tensor_reaches_a_process_worker_on_the_cpu(ray_on_card):
    w = ray_on_card
    t = torch.arange(100_000, dtype=torch.float32, device="cuda")
    ref = ray_tpu_torch.put(t)
    total, kind, device, cuda = ray_tpu_torch.get(_total.remote(ref))
    assert total == float(t.double().sum())
    assert (kind, device, cuda) == ("Tensor", "cpu", False)
    assert w.device_store.stats()["num_spilled_to_host"] == 1
    assert ray_tpu_torch.get(ref) is t
