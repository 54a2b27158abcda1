"""The port's CUDA flash-attention kernels (forward, dQ, dK/dV) against
their plain versions, on the card. Marked ``cuda``: each test skips
without an NVIDIA GPU.

This file imports torch only, so it also runs where JAX is absent:
``python -m pytest --noconftest -q tests/test_torch_flash_attention_cuda.py``.
"""

import dataclasses
import importlib

import pytest
import torch

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
tfm = importlib.import_module("ray_tpu_torch.models.transformer")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, shape, dtype):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("s", [96, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_fp32(cuda, causal, s, h):
    q, k, v = _qkv(cuda, (2, s, 3, h), torch.float32)
    o, lse = fa.flash_attention_cuda(q, k, v, causal)
    ro, rlse = fa.flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(o, ro, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


def test_kernel_matches_plain_bf16_strided(cuda):
    """bf16, read by strides: q/k/v are views of one fused [B,S,3,N,H]."""
    qkv = torch.randn((2, 200, 3, 4, 128), generator=cuda,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    o, lse = fa.flash_attention_cuda(q, k, v, True)
    ro, rlse = fa.flash_attention_plain(q, k, v, True)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, (1, 64, 2, 32), torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _qkv(cuda, (1, 64, 2, 64), torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q, k, v)


def test_forward_goes_through_kernel(cuda):
    cfg = tfm.TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                                n_heads=2, n_kv_heads=1, d_ff=352,
                                max_seq_len=128, dtype=torch.float32,
                                use_flash=True)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, 256, (2, 128), generator=cuda, device="cuda")
    before = fa.launches
    with torch.inference_mode():
        flash = tfm.forward(params, tokens, cfg)
        plain = tfm.forward(params, tokens,
                            dataclasses.replace(cfg, use_flash=False))
    assert fa.launches - before == cfg.n_layers
    torch.testing.assert_close(flash, plain, atol=1e-4, rtol=0)


def _bwd_inputs(gen, shape, dtype, causal):
    q, k, v = _qkv(gen, shape, dtype)
    o, lse = fa.flash_attention_plain(q, k, v, causal)
    do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("s", [96, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_kernels_match_plain_fp32(cuda, causal, s, h):
    """Bound 2e-4 abs/rel: the JAX package's gradient tolerance."""
    args = _bwd_inputs(cuda, (2, s, 3, h), torch.float32, causal)
    got = fa.flash_attention_bwd_cuda(*args, causal)
    want = fa.flash_attention_bwd_plain(*args, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-4)


BF16_GRAD_REL = 1e-2   # |dg| / |g_plain| per gradient, compared in fp32
BF16_TILE_REL = 2e-2   # the same, for the worst 64-row tile of any head


def _worst_tile_rel(g, w, rows=64):
    """Largest |g - w| / |w| over the 64-row tiles of each (b, n) head."""
    d, w = g.float() - w.float(), w.float()
    worst = 0.0
    for r0 in range(0, g.shape[1], rows):
        num = d[:, r0:r0 + rows].norm(dim=(1, 3))
        den = w[:, r0:r0 + rows].norm(dim=(1, 3)).clamp_min(1e-30)
        worst = max(worst, (num / den).max().item())
    return worst


def _assert_bf16_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g).all())
        rel = (g.float() - w.float()).norm() / w.float().norm()
        assert rel.item() <= BF16_GRAD_REL
        assert _worst_tile_rel(g, w) <= BF16_TILE_REL


@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("s", [96, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_kernels_match_plain_bf16(cuda, causal, s, h):
    """The wgmma kernels against the plain backward, which rounds P and dS
    to bf16 where they do: relative norm per gradient and per 64-row tile
    of each head, compared in fp32."""
    args = _bwd_inputs(cuda, (2, s, 3, h), torch.bfloat16, causal)
    _assert_bf16_close(fa.flash_attention_bwd_cuda(*args, causal),
                       fa.flash_attention_bwd_plain(*args, causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k", [(160, 96), (96, 200)])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_kernels_match_plain_unequal_lengths(cuda, causal, s_q, s_k,
                                                      dtype):
    """Sq != Sk, ragged both ways; with Sk > Sq and the top-left causal
    mask the last key tiles see no query and get zero gradients."""
    gen = cuda
    q, do = (torch.randn((2, s_q, 3, 128), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((2, s_k, 3, 128), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    o, lse = fa.flash_attention_plain(q, k, v, causal)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    if causal and s_k > s_q:
        for g in got[1:]:
            assert not g[:, s_q:].any()
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-4)
    else:
        _assert_bf16_close(got, want)


def test_backward_kernels_bf16_repeat_bit_identical(cuda):
    """No atomics: two bf16 runs at the flagship shape agree bit for bit."""
    args = _bwd_inputs(cuda, (4, 2048, 16, 128), torch.bfloat16, True)
    first = fa.flash_attention_bwd_cuda(*args, True)
    second = fa.flash_attention_bwd_cuda(*args, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_backward_kernels_reject_what_tma_cannot_load(cuda):
    """bf16 operands go in by TMA: a base off 16 bytes, or a stride that
    is not a multiple of 8 elements, raises; nothing is copied."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, (1, 64, 2, 64), torch.bfloat16,
                                      True)
    padded = torch.zeros((1, 64, 2, 72), device="cuda", dtype=torch.bfloat16)
    shifted = padded[..., 1:65]           # strides fine, base off 2 bytes
    shifted.copy_(q)
    with pytest.raises(ValueError, match="base % 16 = 2"):
        fa.flash_attention_bwd_cuda(shifted, k, v, o, lse, do)
    odd = torch.zeros((1, 64, 2, 65), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"strides \(8320, 130, 65, 1\)"):
        fa.flash_attention_bwd_cuda(q, k, odd[..., :64], o, lse, do)


def test_backward_kernels_match_plain_bf16_strided(cuda):
    """bf16, ragged S, q/k/v views of one fused [B,S,3,N,H] and a dO whose
    head axis is not contiguous. Bound: relative norm 1e-2 per gradient
    and 2e-2 per 64-row tile, compared in fp32 (both sides see the same
    bf16 inputs)."""
    qkv = torch.randn((2, 200, 3, 4, 128), generator=cuda,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    o, lse = fa.flash_attention_plain(q, k, v, True)
    do = torch.randn((2, 200, 4, 128), generator=cuda,
                     device="cuda").to(torch.bfloat16)
    do_strided = do.transpose(-1, -2).contiguous().transpose(-1, -2)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do_strided, True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    _assert_bf16_close(got, want)


def test_backward_goes_through_kernels(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, (1, 128, 2, 64),
                                                  torch.float32))
    before = (fa.launches_bwd_dq, fa.launches_bwd_dkv)
    out = fa.flash_attention(q, k, v)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    assert (fa.launches_bwd_dq, fa.launches_bwd_dkv) == (before[0] + 1,
                                                          before[1] + 1)
    ref = torch.autograd.grad(
        (fa.mha_reference(q, k, v) ** 2).sum(), (q, k, v))
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, atol=2e-4, rtol=2e-4)


def test_backward_kernels_reject_what_they_do_not_take(cuda):
    args = _bwd_inputs(cuda, (1, 64, 2, 64), torch.float32, True)
    q, k, v, o, lse, do = args
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="do is"):
        fa.flash_attention_bwd_cuda(q, k, v, o, lse, do.bfloat16())


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_goes_through_kernels(cuda, remat):
    """One fp32 training step of a small model on the card launches each
    backward kernel once per layer and the forward once more per layer
    under remat, and its loss and grad norm match the same step on the
    CPU (plain forward and backward) to 1e-4 relative."""
    trn = importlib.import_module("ray_tpu_torch.models.training")
    cfg = tfm.TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                                n_heads=2, n_kv_heads=1, d_ff=352,
                                max_seq_len=128, dtype=torch.float32,
                                use_flash=True, remat=remat)
    tokens = torch.randint(0, 256, (2, 128), generator=cuda, device="cuda")
    metrics = {}
    for device in ("cuda", "cpu"):
        tx = trn.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
        state = trn.init_state(cfg, tx, seed=0, device="cpu")
        state.params = {k: (v.to(device) if k != "blocks" else
                            [{n: t.to(device) for n, t in b.items()}
                             for b in v])
                        for k, v in state.params.items()}
        state.opt_state = tx.init(state.params)
        before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
        _, metrics[device] = trn.make_train_step(cfg, tx)(
            state, {"tokens": tokens.to(device)})
        after = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
        if device == "cuda":
            fwd = 4 if remat else 2
            assert tuple(a - b for a, b in zip(after, before)) == (fwd, 2, 2)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(metrics["cuda"][key].cpu(),
                                   metrics["cpu"][key], atol=0, rtol=1e-4)
