"""The port's flash attention (ray_tpu_torch.ops.flash_attention) against
the JAX package's, on the same numpy inputs, on the CPU.

The JAX side runs as its own tests run it: the Pallas kernel in interpret
mode (``_flash_fwd`` for the LSE). The port's side is the plain version,
which is what a CPU tensor goes through. Bound: 2e-5 on O and LSE, the
JAX package's forward tolerance (tests/test_attention.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("ray_tpu.ops.flash_attention")
pfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TOL = 2e-5
GRAD_TOL = 2e-4   # the JAX package's gradient tolerance


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(s, b=2, n=2, h=64, s_k=None, seed=0):
    rs = np.random.RandomState(seed)
    s_k = s if s_k is None else s_k
    return (rs.standard_normal((b, s, n, h)).astype(np.float32),
            rs.standard_normal((b, s_k, n, h)).astype(np.float32),
            rs.standard_normal((b, s_k, n, h)).astype(np.float32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("s", [96, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_kernel(causal, s, block):
    q, k, v = _qkv(s)
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, scale, block, block, True)
    po, plse = pfa.flash_attention_plain(*_torch(q, k, v), causal)
    assert po.dtype == torch.float32 and plse.shape == (4, s)
    np.testing.assert_allclose(po.numpy(), np.asarray(o), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse)[:, :s],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_cpu_matches_jax(causal):
    """The public entry point on CPU tensors, ragged S and Sq != Sk."""
    q, k, v = _qkv(96, s_k=160, n=3, seed=1)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, None, 64, 64, True)
    out = pfa.flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal,q_offset,kv_offset",
                         [(True, 0, 0), (True, 64, 0), (True, 0, 32),
                          (False, 0, 0)])
def test_mha_reference_matches_jax(causal, q_offset, kv_offset):
    q, k, v = _qkv(64, s_k=96, seed=2)
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, q_offset=q_offset,
                            kv_offset=kv_offset)
    out = pfa.mha_reference(*_torch(q, k, v), causal=causal,
                            q_offset=q_offset, kv_offset=kv_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


def test_backward_is_the_training_slice():
    """The backward of a CPU tensor is the plain backward, from the
    forward's saved (q, k, v, O, LSE); its gradients are mha_reference's
    (tests/test_torch_flash_attention_bwd.py holds them against JAX)."""
    q, k, v = (t.requires_grad_() for t in _torch(*_qkv(32)))
    out = pfa.flash_attention(q, k, v)
    do = torch.ones_like(out)
    grads = torch.autograd.grad(out, (q, k, v), grad_outputs=do)
    o, lse = pfa.flash_attention_plain(q.detach(), k.detach(), v.detach())
    plain = pfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                          o, lse, do)
    for g, p in zip(grads, plain):
        torch.testing.assert_close(g, p, atol=0, rtol=0)
    ref = torch.autograd.grad(pfa.mha_reference(q, k, v), (q, k, v),
                              grad_outputs=do)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, atol=2e-4, rtol=2e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrappers never compute on the CPU in the kernels' place."""
    q, k, v = _torch(*_qkv(32))
    with pytest.raises(ValueError, match="CUDA device"):
        pfa.flash_attention_cuda(q, k, v)
    o, lse = pfa.flash_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        pfa.flash_attention_bwd_cuda(q, k, v, o, lse, torch.ones_like(o))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_takes_the_reference_signature(causal):
    """All eight arguments positionally, as tests/test_attention.py calls
    the JAX package's ``flash_attention``; ``interpret`` changes
    nothing."""
    q, k, v = _qkv(96, n=3, seed=3)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, None, 64, 64, True)
    out = pfa.flash_attention(*_torch(q, k, v), causal, None, 64, 64, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("h", [16, 32, 96])
def test_plain_matches_jax_at_other_head_dims(h):
    """Head dims other than 64 and 128, which the Pallas kernels pad to
    128 lanes (``_pad_head``): the plain forward against ``_flash_fwd``
    (O and LSE, 2e-5) and the plain backward against ``jax.grad`` through
    the kernels (2e-4), ragged S, causal."""
    q, k, v = _qkv(96, b=1, n=2, h=h, seed=4)
    scale = 1.0 / np.sqrt(h)
    o, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            True, scale, 64, 64, True)
    po, plse = pfa.flash_attention_plain(*_torch(q, k, v), True)
    np.testing.assert_allclose(po.numpy(), np.asarray(o), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse)[:, :96],
                               atol=TOL, rtol=TOL)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, True, None, 64, 64, True)
        return jnp.sum(out ** 2)
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    do = 2 * po
    got = pfa.flash_attention_bwd_plain(*_torch(q, k, v), po, plse, do, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _worst_tile_rel(got, want, rows=64):
    """Largest relative norm of got - want over the ``rows``-row tiles of
    each (b, n) head of two [B, S, N, H] arrays."""
    worst = 0.0
    for r0 in range(0, got.shape[1], rows):
        num = np.linalg.norm((got - want)[:, r0:r0 + rows], axis=(1, 3))
        den = np.maximum(np.linalg.norm(want[:, r0:r0 + rows], axis=(1, 3)),
                         1e-30)
        worst = max(worst, float((num / den).max()))
    return worst


@pytest.mark.parametrize("h,dtype", [(160, "float32"), (20, "bfloat16")])
def test_plain_matches_jax_at_wide_and_odd_head_dims(h, dtype):
    """A head dim above 128 (fp32) and a bf16 head dim that is not a
    multiple of 8: the reference takes both through ``_pad_head``, and the
    port's kernels through a 256-column instance or a padded copy. The
    plain path, which pins what those kernels are held to, against
    ``_flash_fwd`` (O, LSE) and ``jax.grad`` through the Pallas kernels in
    interpret mode, ragged S, causal. fp32: 2e-5 on O and LSE, 2e-4 on
    gradients; bf16: relative norm 1e-2 as a whole and 2e-2 in the worst
    64-row tile of any head, |dLSE| 1e-4."""
    q, k, v = _qkv(96, b=1, n=2, h=h, seed=5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    o, lse = jfa._flash_fwd(jq, jk, jv, True, 1.0 / np.sqrt(h), 64, 64, True)
    o = np.asarray(o.astype(jnp.float32))
    lse = np.asarray(lse)[:, :96]
    tq, tk, tv = (t.to(tdt) for t in _torch(q, k, v))
    po, plse = pfa.flash_attention_plain(tq, tk, tv, True)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, True, None, 64, 64, True)
        return jnp.sum(out.astype(jnp.float32) ** 2)
    want = [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    got = [g.float().numpy() for g in pfa.flash_attention_bwd_plain(
        tq, tk, tv, po, plse, (2 * po.float()).to(tdt), True)]
    po = po.float().numpy()
    assert po.shape == q.shape and all(g.shape == q.shape for g in got)
    if dtype == "float32":
        np.testing.assert_allclose(po, o, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(plse.numpy(), lse, atol=TOL, rtol=TOL)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)
    else:
        assert np.abs(plse.numpy() - lse).max() <= 1e-4
        for g, w in zip([po, *got], [o, *want]):
            assert _rel(g, w) <= 1e-2 and _worst_tile_rel(g, w) <= 2e-2, (
                _rel(g, w), _worst_tile_rel(g, w))
