"""The port's flagship transformer (ray_tpu_torch.models) against the JAX
package's, from the same parameters and tokens, on the CPU.

Parameters come from the JAX package's ``init_params`` through
``params_from_jax``. Both sides run the flash path: JAX through its
Pallas kernel in interpret mode, the port through the kernel's plain
version. The config is the tiny one of ``__graft_entry__.py`` (GQA 8/4).

Bounds on logits: fp32 1e-4 (JAX's own flash-vs-dense gap there is
~4e-6 at |logit| <= 4.3); bf16 1e-1 (JAX's own flash-vs-dense gap at
bf16 is ~5e-2 to 6e-2 on these inputs; the bound allows about twice it).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jt = importlib.import_module("ray_tpu.models.transformer")
pt = importlib.import_module("ray_tpu_torch.models.transformer")
from ray_tpu_torch.models import params_from_jax  # noqa: E402

TINY = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=8,
            n_kv_heads=4, d_ff=352, max_seq_len=128, use_flash=True)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _configs(dtype="float32", **kw):
    jdt, tdt = DTYPES[dtype]
    return (jt.TransformerConfig(**TINY, dtype=jdt, **kw),
            pt.TransformerConfig(**TINY, dtype=tdt, **kw))


def _params(jcfg):
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(tree, device="cpu")


def _tokens(seed=1):
    return np.random.RandomState(seed).randint(0, 256, (2, 128)).astype(
        np.int32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-1)])
def test_forward_matches_jax(dtype, tol):
    jcfg, pcfg = _configs(dtype)
    jparams, pparams = _params(jcfg)
    tokens = _tokens()
    ref = np.asarray(jt.forward(jparams, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        out = pt.forward(pparams, torch.from_numpy(tokens), pcfg)
    assert out.dtype == torch.float32 and out.shape == (2, 128, 256)
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=0)


def test_moe_forward_matches_jax():
    jcfg, pcfg = _configs(use_moe=True)
    jparams, pparams = _params(jcfg)
    tokens = _tokens(2)
    ref = np.asarray(jt.forward(jparams, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        out = pt.forward(pparams, torch.from_numpy(tokens), pcfg)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_loss_fn_matches_jax():
    jcfg, pcfg = _configs()
    jparams, pparams = _params(jcfg)
    tokens = _tokens(3)
    mask = (np.random.RandomState(4).rand(2, 128) > 0.3).astype(np.float32)
    ref = jt.loss_fn(jparams, {"tokens": jnp.asarray(tokens),
                               "loss_mask": jnp.asarray(mask)}, jcfg)
    with torch.no_grad():
        out = pt.loss_fn(pparams, {"tokens": torch.from_numpy(tokens),
                                   "loss_mask": torch.from_numpy(mask)}, pcfg)
    np.testing.assert_allclose(out.item(), float(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_moe", [False, True])
def test_init_params_layout_matches_jax(use_moe):
    jcfg, pcfg = _configs(use_moe=use_moe)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = pt.init_params(pcfg, seed=0, device="cpu")
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jparams)
    pshapes = jax.tree.map(lambda x: tuple(x.shape), pparams)
    assert pshapes == jshapes
    assert all(x.dtype == torch.float32
               for x in jax.tree.leaves(pparams))
    # same distributions: unit-variance rows over fan-in, 0.02 embedding
    assert abs(pparams["embed"].std().item() - 0.02) < 1e-3
    wi = pparams["blocks"][0]["wi"]
    fan_in = wi.shape[-2]
    assert abs(wi.std().item() * np.sqrt(fan_in) - 1.0) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_rms_norm_match_jax(dtype):
    """Interleaved RoPE pairs and the fp32-promoting RMSNorm."""
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(5)
    x = rs.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.tile(np.arange(16, dtype=np.int32) + 3, (2, 1))
    scale = rs.standard_normal(32).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    ref_r = np.asarray(jt.rope(jx, jnp.asarray(pos), 10_000.0), np.float32)
    out_r = pt.rope(tx, torch.from_numpy(pos), 10_000.0).float().numpy()
    ref_n = np.asarray(jt.rms_norm(jx, jnp.asarray(scale)), np.float32)
    out_n = pt.rms_norm(tx, torch.from_numpy(scale)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out_r, ref_r, atol=tol, rtol=tol)
    np.testing.assert_allclose(out_n, ref_n, atol=tol, rtol=tol)


def test_dense_attention_keeps_bottom_right_causal_mask():
    """``_attention`` aligns its causal mask to the bottom right (Sq < Sk
    here), unlike the flash path; the port keeps the JAX package's
    behaviour."""
    rs = np.random.RandomState(6)
    q = rs.standard_normal((1, 8, 2, 16)).astype(np.float32)
    k, v = (rs.standard_normal((1, 12, 2, 16)).astype(np.float32)
            for _ in range(2))
    ref = np.asarray(jt._attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v)))
    out = pt._attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_params_from_jax_rejects_unknown_layout():
    jcfg, _ = _configs()
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    tree["blocks"][1]["extra"] = tree["blocks"][1]["wq"]
    with pytest.raises(ValueError, match="block 1"):
        params_from_jax(tree, device="cpu")
