"""The port's flash attention (ray_tpu_torch.ops.flash_attention) against
the JAX package's, on the same numpy inputs, on the CPU.

The JAX side runs as its own tests run it: the Pallas kernel in interpret
mode (``_flash_fwd`` for the LSE). The port's side is the plain version,
which is what a CPU tensor goes through. Bound: 2e-5 on O and LSE, the
JAX package's forward tolerance (tests/test_attention.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("ray_tpu.ops.flash_attention")
pfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TOL = 2e-5


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
