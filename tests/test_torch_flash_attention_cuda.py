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


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


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


BF16_O_TOL = 2e-2     # |dO| abs, compared in fp32: about one bf16 step
BF16_REL = 1e-2       # |dx| / |x_plain| per output or gradient, in fp32
BF16_TILE_REL = 2e-2  # the same, for the worst 64-row tile of any head
LSE_TOL = 1e-4


def _worst_tile_rel(g, w, rows=64):
    """Largest |g - w| / |w| over the 64-row tiles of each (b, n) head."""
    d, w = g.float() - w.float(), w.float()
    worst = 0.0
    for r0 in range(0, g.shape[1], rows):
        num = d[:, r0:r0 + rows].norm(dim=(1, 3))
        den = w[:, r0:r0 + rows].norm(dim=(1, 3)).clamp_min(1e-30)
        worst = max(worst, (num / den).max().item())
    return worst


def _assert_bf16_forward_close(got, want):
    """The bf16 kernel (which rounds P to bf16 for P V) against the plain
    forward (which does not): O by max abs, relative norm and worst
    64-row tile; LSE by max abs."""
    (o, lse), (ro, rlse) = got, want
    assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all())
    d = o.float() - ro.float()
    assert d.abs().max().item() <= BF16_O_TOL
    assert (d.norm() / ro.float().norm()).item() <= BF16_REL
    assert _worst_tile_rel(o, ro) <= BF16_TILE_REL
    assert (lse - rlse).abs().max().item() <= LSE_TOL


def test_kernel_matches_plain_bf16_strided(cuda):
    """bf16, read by strides: q/k/v are views of one fused [B,S,3,N,H]."""
    qkv = torch.randn((2, 200, 3, 4, 128), generator=cuda,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    _assert_bf16_forward_close(fa.flash_attention_cuda(q, k, v, True),
                               fa.flash_attention_plain(q, k, v, True))


@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("s", [96, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_bf16(cuda, causal, s, h):
    """The wgmma forward against the plain forward, ragged and whole
    tiles, causal and not."""
    q, k, v = _qkv(cuda, (2, s, 3, h), torch.bfloat16)
    _assert_bf16_forward_close(fa.flash_attention_cuda(q, k, v, causal),
                               fa.flash_attention_plain(q, k, v, causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k", [(160, 96), (96, 200)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_unequal_lengths(cuda, causal, s_q, s_k, dtype):
    """Sq != Sk, ragged both ways, top-left causal mask."""
    q = torch.randn((2, s_q, 3, 128), generator=cuda, device="cuda").to(dtype)
    k, v = (torch.randn((2, s_k, 3, 128), generator=cuda, device="cuda")
            .to(dtype) for _ in range(2))
    got = fa.flash_attention_cuda(q, k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal)
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(got[1], want[1], atol=LSE_TOL, rtol=0)
    else:
        _assert_bf16_forward_close(got, want)


def test_kernel_bf16_repeat_bit_identical(cuda):
    """Two bf16 forwards at the flagship shape agree bit for bit."""
    q, k, v = _qkv(cuda, (4, 2048, 16, 128), torch.bfloat16)
    first = fa.flash_attention_cuda(q, k, v, True)
    second = fa.flash_attention_cuda(q, k, v, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_kernel_rejects_what_tma_cannot_load(cuda):
    """bf16 operands of the forward go in by TMA: a base off 16 bytes or a
    stride that is not a multiple of 8 elements raises; nothing is copied.
    A head dim that is not a multiple of 8 is padded to one (the reference
    pads every head by ``_pad_head``), and O comes back at the true H,
    under the bf16 bounds, with the scale of the true H."""
    q, k, v = _qkv(cuda, (1, 64, 2, 64), torch.bfloat16)
    padded = torch.zeros((1, 64, 2, 72), device="cuda", dtype=torch.bfloat16)
    shifted = padded[..., 1:65]           # strides fine, base off 2 bytes
    shifted.copy_(q)
    with pytest.raises(ValueError, match="base % 16 = 2"):
        fa.flash_attention_cuda(shifted, k, v)
    odd = torch.zeros((1, 64, 2, 65), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"strides \(8320, 130, 65, 1\)"):
        fa.flash_attention_cuda(q, k, odd[..., :64])
    q, k, v = _qkv(cuda, (1, 64, 2, 20), torch.bfloat16)
    got = fa.flash_attention_cuda(q, k, v)
    assert got[0].shape == q.shape
    _assert_bf16_forward_close(got, fa.flash_attention_plain(q, k, v))


def test_kernel_rejects_what_it_does_not_take(cuda):
    """Every head dim runs: H = 160 on the 256-column instance (the columns
    past H masked), H = 320 and 512 in output windows over the head's
    pieces, forward and backward, under each dtype's bounds; float16 and
    H = 0 raise."""
    q, k, v = _qkv(cuda, (1, 64, 2, 160), torch.float32)
    o, lse = fa.flash_attention_cuda(q, k, v)
    ro, rlse = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(o, ro, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, rlse, atol=LSE_TOL, rtol=0)
    for h in (320, 512):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(cuda, (1, 160, 2, h), dtype)
            got = fa.flash_attention_cuda(q, k, v)
            want = fa.flash_attention_plain(q, k, v)
            assert got[0].shape == q.shape
            o, lse = want
            do = torch.randn(q.shape, generator=cuda, device="cuda").to(dtype)
            grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
            ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
            if dtype == torch.float32:
                torch.testing.assert_close(got[0], want[0], atol=2e-5,
                                           rtol=2e-5)
                torch.testing.assert_close(got[1], want[1], atol=LSE_TOL,
                                           rtol=0)
                for g, w in zip(grads, ref):
                    torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-4)
            else:
                _assert_bf16_forward_close(got, want)
                _assert_bf16_close(grads, ref)
    q, k, v = _qkv(cuda, (1, 64, 2, 64), torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q, k, v)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(cuda, (1, 64, 2, 0), dtype)
        lse = torch.zeros((2, 64), device="cuda")
        with pytest.raises(ValueError, match="non-empty sequences and heads"):
            fa.flash_attention_cuda(q, k, v)
        with pytest.raises(ValueError, match="non-empty sequences and heads"):
            fa.flash_attention_bwd_cuda(q, k, v, q, lse, q)


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


def _assert_bf16_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g).all())
        rel = (g.float() - w.float()).norm() / w.float().norm()
        assert rel.item() <= BF16_REL
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [16, 32, 96, 160, 256, 320, 512])
def test_head_dims_forward_and_backward(cuda, h, dtype):
    """Head dims other than 64 and 128 run on the kernel instance of the
    next width up, with the columns past H masked: forward and backward
    against the plain versions, ragged S, causal, under each dtype's
    bounds."""
    q, k, v = _qkv(cuda, (2, 160, 3, h), dtype)
    got = fa.flash_attention_cuda(q, k, v, True)
    want = fa.flash_attention_plain(q, k, v, True)
    assert got[0].shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(got[1], want[1], atol=LSE_TOL, rtol=0)
    else:
        _assert_bf16_forward_close(got, want)
    o, lse = want
    do = torch.randn(q.shape, generator=cuda, device="cuda").to(dtype)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    if dtype == torch.float32:
        for g, w in zip(grads, ref):
            torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-4)
    else:
        _assert_bf16_close(grads, ref)


def test_flagship_head_dim_takes_no_padding_copy(cuda, monkeypatch):
    """H = 128 (and every bf16 multiple of 8) goes to the kernels as it
    is: the padded copy is never made."""
    def no_copy(*tensors):
        raise AssertionError("padded a head dim that needs no padding")

    monkeypatch.setattr(fa, "_pad_head", no_copy)
    q, k, v = _qkv(cuda, (1, 128, 2, 128), torch.bfloat16)
    o, lse = fa.flash_attention_cuda(q, k, v, True)
    fa.flash_attention_bwd_cuda(q, k, v, o, lse, torch.ones_like(o), True)


@pytest.mark.parametrize("h", [20, 40, 300])
def test_bf16_head_dims_off_the_tma_multiple(cuda, h):
    """bf16 head dims that are not multiples of 8 run on a copy padded to
    one: forward and backward against the plain versions at the true H,
    under the bf16 bounds, and the kernels launched once each."""
    q, k, v = _qkv(cuda, (2, 160, 3, h), torch.bfloat16)
    before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    got = fa.flash_attention_cuda(q, k, v, True)
    _assert_bf16_forward_close(got, fa.flash_attention_plain(q, k, v, True))
    o, lse = got
    do = torch.randn(q.shape, generator=cuda, device="cuda").to(q.dtype)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    assert all(g.shape == q.shape for g in grads)
    _assert_bf16_close(grads,
                       fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True))
    after = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_config_goes_through_kernels(cuda, dtype):
    """The tiny config of tests/test_torch_transformer.py (d_model 128, 8
    heads, so H = 16; GQA 8/4): logits and the gradient of the loss
    through the kernels (remat on, the config's default) against the plain
    attention path. fp32: 1e-4 abs
    on logits, 1e-4 relative norm on the gradient; bf16: at most twice the
    plain path's own bf16-vs-fp32 gap."""
    trn = importlib.import_module("ray_tpu_torch.models.training")
    cfg = tfm.TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                                n_heads=8, n_kv_heads=4, d_ff=352,
                                max_seq_len=128, use_flash=True, dtype=dtype)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    leaves = trn.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, 256, (2, 128), generator=cuda, device="cuda")

    def run(c):
        logits = tfm.forward(params, tokens, c)
        loss = tfm.loss_fn(params, {"tokens": tokens}, c)
        return logits.detach(), torch.autograd.grad(loss, leaves)

    before = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    logits, grads = run(cfg)
    after = (fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    # forward, the loss's forward and, under remat, its recomputation
    fwd = (3 if cfg.remat else 2) * cfg.n_layers
    assert tuple(a - b for a, b in zip(after, before)) == (fwd, 2, 2)
    plain = dataclasses.replace(cfg, use_flash=False)
    p_logits, p_grads = run(plain)

    def rel(a, b):
        num = sum((x.float() - y.float()).square().sum() for x, y in zip(a, b))
        den = sum(y.float().square().sum() for y in b)
        return (num / den).sqrt().item()

    if dtype == torch.float32:
        torch.testing.assert_close(logits, p_logits, atol=1e-4, rtol=0)
        assert rel(grads, p_grads) <= 1e-4
    else:
        f_logits, f_grads = run(dataclasses.replace(plain,
                                                    dtype=torch.float32))
        gap = (p_logits - f_logits).abs().max().item()
        assert (logits - p_logits).abs().max().item() <= 2 * gap
        assert rel(grads, p_grads) <= 2 * rel(p_grads, f_grads)
