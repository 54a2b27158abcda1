"""The port's flash attention backward (ray_tpu_torch.ops.flash_attention)
against the JAX package's, on the same numpy inputs, on the CPU.

The JAX side runs as its own tests run it: ``jax.grad`` through the
Pallas kernels in interpret mode (tests/test_attention.py:35-67). The
port's side is what a CPU tensor goes through: the plain forward and the
plain backward, ``flash_attention_bwd_plain``, which recomputes P from
the forward's LSE without autograd. Bound at fp32: 2e-4 abs/rel, the JAX
package's own gradient tolerance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("ray_tpu.ops.flash_attention")
pfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(s, b=2, n=4, h=64, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((b, s, n, h)).astype(np.float32)
            for _ in range(3)]


def _jax_grads(q, k, v, causal, dtype=jnp.float32):
    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, None, 64, 64, True)
        return jnp.sum(out.astype(jnp.float32) ** 2)
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, causal, dtype=torch.float32, fn=None):
    fn = fn or (lambda q, k, v: pfa.flash_attention(q, k, v, causal=causal))
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    loss = (fn(*ts).float() ** 2).sum()
    return [g.float().numpy() for g in torch.autograd.grad(loss, ts)]


@pytest.mark.parametrize("s,causal,n", [(128, True, 4), (96, True, 2),
                                        (96, False, 2), (160, True, 2),
                                        (160, False, 2)])
def test_gradients_match_jax(s, causal, n):
    """Whole tiles (S=128) and ragged ones (96, 160: not multiples of 64),
    causal and not."""
    q, k, v = _qkv(s, n=n)
    want = _jax_grads(q, k, v, causal)
    got = _port_grads(q, k, v, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_autograd_of_reference(causal):
    """The plain backward against torch autograd through ``mha_reference``:
    two independent statements of the same gradients."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(80, n=2, seed=1))
    do = torch.from_numpy(np.random.RandomState(2).standard_normal(
        q.shape).astype(np.float32))
    o, lse = pfa.flash_attention_plain(q, k, v, causal)
    got = pfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = pfa.mha_reference(*ts, causal=causal)
    want = torch.autograd.grad(ref, ts, grad_outputs=do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_bf16_gradients_within_twice_jax_own_gap():
    """bf16 inputs: the port's flash gradients against JAX's, bounded by
    twice JAX's own flash-vs-``mha_reference`` gradient gap on the same
    inputs (relative norm per gradient)."""
    q, k, v = _qkv(128, n=2, seed=3)
    want = _jax_grads(q, k, v, True, jnp.bfloat16)

    def jax_ref_loss(q, k, v):
        out = jfa.mha_reference(q, k, v, causal=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)
    ref = [np.asarray(g.astype(jnp.float32)) for g in jax.grad(
        jax_ref_loss, argnums=(0, 1, 2))(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))]
    got = _port_grads(q, k, v, True, torch.bfloat16)
    for g, w, r in zip(got, want, ref):
        gap = np.linalg.norm(r - w) / np.linalg.norm(w)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert gap > 0
        assert err <= 2 * gap, (err, gap)


def _bwd_unrounded(q, k, v, o, lse, do, causal, sm_scale):
    """The plain backward with no bf16 rounding of P or dS: the dense
    formula as it stood before the bf16 kernels' operand rounding."""
    b, s_q, n, _ = q.shape
    s_k = k.shape[1]
    s = torch.einsum("bqnh,bknh->bnqk", q, k) * sm_scale
    p = torch.exp(s - lse.reshape(b, n, s_q, 1))
    if causal:
        q_pos = torch.arange(s_q)
        k_pos = torch.arange(s_k)
        p = p.masked_fill(q_pos[:, None] < k_pos[None, :], 0.0)
    delta = pfa.flash_attention_bwd_delta(o, do).reshape(b, n, s_q, 1)
    dp = torch.einsum("bqnh,bknh->bnqk", do, v)
    ds = p * (dp - delta) * sm_scale
    return (torch.einsum("bnqk,bknh->bqnh", ds, k),
            torch.einsum("bnqk,bqnh->bknh", ds, q),
            torch.einsum("bnqk,bqnh->bknh", p, do))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_rounds_only_bf16(causal):
    """fp32 inputs: the plain backward is bit for bit the unrounded dense
    formula. bf16 inputs: it departs from that formula, by the rounding
    of P and dS to bf16 that the bf16 kernels make."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(96, n=2, seed=4))
    do = torch.from_numpy(np.random.RandomState(5).standard_normal(
        q.shape).astype(np.float32))
    o, lse = pfa.flash_attention_plain(q, k, v, causal)
    scale = 1.0 / np.sqrt(q.shape[-1])
    got = pfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    want = _bwd_unrounded(q, k, v, o, lse, do, causal, scale)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    qb, kb, vb, ob, dob = (t.bfloat16() for t in (q, k, v, o, do))
    _, lse_b = pfa.flash_attention_plain(qb, kb, vb, causal)
    got = pfa.flash_attention_bwd_plain(qb, kb, vb, ob, lse_b, dob, causal)
    unrounded = _bwd_unrounded(*(t.float() for t in (qb, kb, vb, ob)), lse_b,
                               dob.float(), causal, scale)
    for g, w in zip(got, unrounded):
        assert g.dtype == torch.bfloat16
        assert not torch.equal(g, w.bfloat16())
        rel = (g.float() - w).norm() / w.norm()
        assert rel.item() < 1e-2


def test_backward_dispatch_returns_no_grad_for_options():
    """``causal`` and ``sm_scale`` get no gradient; q, k and v get theirs
    in their own dtype and shape."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(32, b=1, n=1))
    out = pfa.flash_attention(q, k, v, True, 0.3)
    out.sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and t.grad.shape == t.shape
        assert t.grad.dtype == torch.float32
