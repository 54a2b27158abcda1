"""The port's ViT family (ray_tpu_torch.models.vit) against the JAX
package's, from the same parameters and images, on the CPU.

Parameters come from the JAX package's ``init_vit_params`` through
``params_from_jax``; the config is tests/test_vit.py's (16 x 16 images,
patch 4, d64, 2 layers, 4 heads, d_ff 128, fp32). Bounds are
tests/test_torch_transformer.py's: logits, loss and every gradient
element within 1e-4 (abs) of JAX's. The bright-quadrant task of
tests/test_vit.py:45 is learned with the same steps, batches and
thresholds (Adam at 1e-2, 150 steps of 32 images; loss below 0.5, accuracy
above 0.8).

The sharded loss (``vit_loss_fn_shard``, each rank's program on (fsdp 2,
tp 2)) runs on 4 spawned gloo ranks (``LocalRanks``) against JAX's GSPMD
``value_and_grad`` on 4 CPU devices, from the same parameters and batch:
the global loss within 1e-5 relative (the bound of the sharded training
tests), each rank's gradient blocks within 1e-4 of the blocks JAX puts on
that device.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.launch import LocalRanks

WORLD = 4
CFG = dict(image_size=16, patch_size=4, channels=3, num_classes=4,
           d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128)
TOL = 1e-4
LOSS_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _bright_quadrant_batch(rng, n):
    """tests/test_vit.py's batch: label = which quadrant holds the bright
    blob."""
    images = rng.rand(n, 16, 16, 3).astype(np.float32) * 0.1
    labels = rng.randint(0, 4, n)
    for i, lab in enumerate(labels):
        r, c = divmod(lab, 2)
        images[i, r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] += 1.0
    return images, labels.astype(np.int32)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _flat(v, path + (i,)).items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {path: np.asarray(tree)}


def _port_cfg():
    from ray_tpu_torch.models import ViTConfig
    return ViTConfig(**CFG, dtype=torch.float32)


def _jax_cfg():
    import jax.numpy as jnp
    from ray_tpu.models.vit import ViTConfig
    return ViTConfig(**CFG, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax
    from ray_tpu.models.vit import init_vit_params
    return jax.tree.map(np.asarray, init_vit_params(jax.random.PRNGKey(0),
                                                    _jax_cfg()))


def _port_params(params):
    from ray_tpu_torch.models import params_from_jax
    return params_from_jax(params, device="cpu")


def test_vit_forward_shape_and_patchify():
    import jax.numpy as jnp
    from ray_tpu.models.vit import patchify as jax_patchify
    from ray_tpu_torch.models import init_vit_params, vit_forward
    from ray_tpu_torch.models.vit import patchify
    cfg = _port_cfg()
    params = init_vit_params(cfg, seed=0, device="cpu")
    with torch.no_grad():
        logits = vit_forward(params, torch.zeros((2, 16, 16, 3)), cfg)
    assert logits.shape == (2, 4) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    images = np.random.RandomState(2).rand(3, 16, 16, 3).astype(np.float32)
    np.testing.assert_array_equal(
        patchify(torch.from_numpy(images), cfg).numpy(),
        np.asarray(jax_patchify(jnp.asarray(images), _jax_cfg())))
    shapes = {p: x.shape for p, x in _flat(params).items()}
    assert shapes == {p: x.shape for p, x in _flat(_jax_params()).items()}


def test_vit_logits_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.vit import vit_forward as jax_forward
    from ray_tpu.models.vit import vit_loss_fn as jax_loss_fn
    from ray_tpu_torch.models import vit_forward, vit_loss_fn
    from ray_tpu_torch.models.training import param_leaves
    params = _jax_params()
    images, labels = _bright_quadrant_batch(np.random.RandomState(3), 8)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    j_logits = np.asarray(jax_forward(jax.tree.map(jnp.asarray, params),
                                      jbatch["images"], _jax_cfg()))
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jbatch, _jax_cfg())))(params)

    pparams = _port_params(params)
    leaves = param_leaves(pparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    logits = vit_forward(pparams, batch["images"], _port_cfg())
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, atol=TOL,
                               rtol=0)
    loss = vit_loss_fn(pparams, batch, _port_cfg())
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=TOL, rtol=0)
    grads = dict(zip(_flat(pparams), torch.autograd.grad(loss, leaves)))
    want = _flat(j_grads)
    assert grads.keys() == want.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], atol=TOL, rtol=0,
                                   err_msg=str(path))


def test_vit_learns_bright_quadrant():
    from ray_tpu_torch.models import vit_forward, vit_loss_fn
    from ray_tpu_torch.models.training import param_leaves
    cfg = _port_cfg()
    params = _port_params(_jax_params())
    leaves = param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-2)   # optax.adam(1e-2)
    rng = np.random.RandomState(0)
    for _ in range(150):
        images, labels = _bright_quadrant_batch(rng, 32)
        loss = vit_loss_fn(params, {"images": torch.from_numpy(images),
                                    "labels": torch.from_numpy(labels)}, cfg)
        opt.zero_grad()
        loss.backward()
        opt.step()
    images, labels = _bright_quadrant_batch(rng, 64)
    with torch.no_grad():
        logits = vit_forward(params, torch.from_numpy(images), cfg)
    acc = (logits.argmax(-1).numpy() == labels).mean()
    assert loss.item() < 0.5, loss.item()
    assert acc > 0.8, acc


# ------------------------------------------------------------ sharded

def _port_sharded(params, images, labels):
    """On each rank of (fsdp 2, tp 2): the global loss and this rank's
    gradient blocks, by path."""
    from ray_tpu_torch.models import shard_params_from_jax, vit_param_specs
    from ray_tpu_torch.models.sharded import vit_loss_fn_shard
    from ray_tpu_torch.models.training import (
        param_leaves, sharded_value_and_grad)
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    cfg = _port_cfg()
    mesh = make_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    specs = vit_param_specs(cfg)
    p = shard_params_from_jax(params, mesh, specs, device="cpu")
    for leaf in param_leaves(p):
        leaf.requires_grad_(True)
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    loss, grads, _ = sharded_value_and_grad(vit_loss_fn_shard, p, specs,
                                            mesh, batch, cfg)
    return loss.item(), {path: g.numpy()
                         for path, g in zip(_flat(p), grads)}


def test_vit_sharded_loss_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from ray_tpu.models.vit import vit_loss_fn, vit_param_specs
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh, tree_shardings
    params = _jax_params()
    images, labels = _bright_quadrant_batch(np.random.RandomState(1), 16)
    mesh = make_mesh(MeshSpec(fsdp=2, tp=2), jax.devices()[:WORLD])
    jparams = jax.device_put(jax.tree.map(jnp.asarray, params),
                             tree_shardings(mesh, vit_param_specs(_jax_cfg())))
    batch = {"images": jax.device_put(jnp.asarray(images), NamedSharding(
                 mesh, JP(("dp", "fsdp"), None, None, None))),
             "labels": jax.device_put(jnp.asarray(labels), NamedSharding(
                 mesh, JP(("dp", "fsdp"))))}
    with mesh:
        j_loss, j_grads = jax.jit(jax.value_and_grad(
            lambda p, b: vit_loss_fn(p, b, _jax_cfg())))(jparams, batch)
    specs = vit_param_specs(_jax_cfg())
    with LocalRanks(WORLD, device="cpu") as ranks:
        results = ranks.run(_port_sharded, params, images, labels)
    for rank, (loss, grads) in enumerate(results):
        np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_REL)
        assert grads.keys() == _flat(params).keys()
        for path, g in grads.items():
            leaf, spec = j_grads, specs
            for key in path:
                leaf, spec = leaf[key], spec[key]
            arr = jax.device_put(leaf, NamedSharding(mesh, spec))
            want = np.asarray(next(s for s in arr.addressable_shards
                                   if s.device.id == rank).data)
            np.testing.assert_allclose(g, want, atol=TOL, rtol=0,
                                       err_msg=f"rank {rank} {path}")
