"""Flash attention: CUDA kernels for Hopper and their plain versions.

Counterpart of ``ray_tpu/ops/flash_attention.py``, written by hand for
``sm_90a`` in place of its Pallas kernels:

- the forward kernel, ``ray_tpu_torch/csrc/flash_attention.cu``, for
  ``_flash_fwd_kernel``: on bf16 inputs a ``wgmma`` kernel fed by TMA, on
  fp32 inputs a CUDA-core FMA kernel; ``flash_attention_plain`` computes
  the same function, O and LSE, densely in fp32;
- the backward kernels, ``ray_tpu_torch/csrc/flash_attention_bwd.cu``,
  dQ for ``_flash_bwd_dq_kernel`` and dK/dV for ``_flash_bwd_dkv_kernel``:
  on bf16 inputs ``wgmma`` kernels fed by TMA, on fp32 inputs CUDA-core
  FMA kernels; ``flash_attention_bwd_plain`` computes the same gradients
  densely in fp32, recomputing P from LSE and rounding P and dS to bf16
  where the bf16 kernels do.

Dispatch is by where the tensors lie: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, which launches or raises. Nothing
falls back from the one to the other. The kernels take every head dim up
to 256, as the JAX package takes every head dim by padding it: they mask
the columns past it and make no padded copy, except for a bf16 head dim
that is not a multiple of 8, which TMA cannot load; its q, k, v (and O, dO
for the backward) are copied once into a head axis zero-padded to the next
multiple of 8, and the outputs sliced back.

Layout everywhere: [B, S, N, H].
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch._private import native_loader

# Kernel launches since the last reset, one count per kernel: a run reads
# them to show that its attention went through the kernels.
launches = 0            # forward
launches_bwd_dq = 0     # backward, dQ
launches_bwd_dkv = 0    # backward, dK and dV

MAX_KERNEL_HEAD_DIM = 256
_TMA_HEAD_MULTIPLE = 8   # a bf16 head dim the kernels load by TMA
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535   # each kernel's grid is (tiles of S, B*N)
_NEG = -1e30          # the masked logit, as in the JAX package

_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def mha_reference(q, k, v, *, causal: bool = True,
                  sm_scale: Optional[float] = None,
                  q_offset: int = 0, kv_offset: int = 0):
    """Dense attention, [B,S,N,H]. Offsets shift absolute positions for
    cross-shard causal masking (ring/ulysses callers)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * sm_scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        q_pos = q_offset + torch.arange(s_q, device=q.device)
        k_pos = kv_offset + torch.arange(s_k, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = logits.masked_fill(~mask, _NEG)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", probs.to(v.dtype), v)


def flash_attention_plain(q, k, v, causal: bool = True,
                          sm_scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, densely: (O [B,Sq,N,H] in q's dtype,
    LSE [B*N, Sq] fp32). LSE is the logsumexp of the scaled, masked
    logits; q is scaled before the product and all math is fp32. The
    causal mask is top-left: q_pos >= k_pos, both counted from 0."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, s_q, n, _ = q.shape
    s_k = k.shape[1]
    s = torch.einsum("bqnh,bknh->bnqk", q.float() * sm_scale, k.float())
    if causal:
        q_pos = torch.arange(s_q, device=q.device)
        k_pos = torch.arange(s_k, device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG)
    lse = torch.logsumexp(s, dim=-1)                           # [B,N,Sq]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bnqk,bknh->bqnh", p, v.float()).to(q.dtype)
    return out, lse.reshape(b * n, s_q)


def flash_attention_bwd_delta(o, do) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32 as [B*N, Sq], the layout of LSE. The
    JAX package also takes it outside its kernels."""
    b, s_q, n, _ = o.shape
    delta = (do.float() * o.float()).sum(dim=-1)              # [B,Sq,N]
    return delta.permute(0, 2, 1).reshape(b * n, s_q).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """What the backward kernels compute, densely in fp32 and without
    autograd: (dQ, dK, dV) in the dtypes of q, k and v. P is recomputed
    from LSE as exp(q k^T * scale - LSE), masked to 0 where the forward
    masked it; dS = P * (dO V^T - D) * scale; dQ = dS K, dK = dS^T Q,
    dV = P^T dO.

    For bf16 inputs, P and dS are rounded to bf16 before the three
    products that take them, as the bf16 kernels round them for their
    tensor-core operands; dS itself is formed from the fp32 P. The dtype
    of the inputs decides this, with no parameter. For fp32 inputs
    nothing is rounded."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, s_q, n, _ = q.shape
    s_k = k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqnh,bknh->bnqk", qf, kf) * sm_scale
    p = torch.exp(s - lse.reshape(b, n, s_q, 1))
    if causal:
        q_pos = torch.arange(s_q, device=q.device)
        k_pos = torch.arange(s_k, device=q.device)
        p = p.masked_fill(q_pos[:, None] < k_pos[None, :], 0.0)
    delta = flash_attention_bwd_delta(o, do).reshape(b, n, s_q, 1)
    dp = torch.einsum("bqnh,bknh->bnqk", dof, vf)
    ds = p * (dp - delta) * sm_scale
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    dq = torch.einsum("bnqk,bknh->bqnh", ds, kf)
    dk = torch.einsum("bnqk,bqnh->bknh", ds, qf)
    dv = torch.einsum("bnqk,bqnh->bknh", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native_loader.load_library("flash_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_fwd.argtypes = (
            [ptr] * 5 + [i32] * 6 + [i64] * 12
            + [ctypes.c_float, i32, ptr])
        lib.flash_attention_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_kernel_lib() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = native_loader.load_library("flash_attention_bwd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_bwd_dq.argtypes = (
            [ptr] * 7 + [i32] * 6 + [i64] * 15
            + [ctypes.c_float, i32, ptr])
        lib.flash_attention_bwd_dkv.argtypes = (
            [ptr] * 8 + [i32] * 6 + [i64] * 18
            + [ctypes.c_float, i32, ptr])
        lib.flash_attention_bwd_dq.restype = ctypes.c_int
        lib.flash_attention_bwd_dkv.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def _check_kernel_inputs(q, k, v, **same_as_q) -> None:
    """Raise on what the kernels do not take: q, k, v and every tensor in
    ``same_as_q`` (shaped like q) must be [B, S, N, H] on q's CUDA device,
    of q's dtype (fp32 or bf16), with a contiguous head axis."""
    named = {"q": q, "k": k, "v": v, **same_as_q}
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, N, H], got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head axis must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    b, s_q, n, h = q.shape
    s_k = k.shape[1]
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, n, h):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, t in same_as_q.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
    if not 1 <= h <= MAX_KERNEL_HEAD_DIM:
        raise ValueError(f"the kernels take head dims up to "
                         f"{MAX_KERNEL_HEAD_DIM}, got {h}")
    if min(b, s_q, s_k, n) == 0 or b * n > _MAX_GRID_Y:
        raise ValueError(f"the kernel needs 1 <= B*N <= {_MAX_GRID_Y} and "
                         f"non-empty sequences, got {tuple(q.shape)}, "
                         f"Sk={s_k}")


def _check_tma_operands(**tensors) -> None:
    """Raise on a bf16 operand that TMA cannot load: its base must be
    16-byte aligned, its (batch, sequence, head) strides multiples of 8
    elements (16 bytes), and its head dim a multiple of 8 (whole 16-byte
    pieces of a row, which the kernels store in pairs). Nothing is copied
    to make it so."""
    for name, t in tensors.items():
        if t.shape[-1] % 8:
            raise ValueError(
                f"{name} has head dim {t.shape[-1]}; the bf16 kernels take "
                f"head dims that are multiples of 8")
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(
                f"{name} must have a 16-byte aligned base and strides that "
                f"are multiples of 8 elements for the bf16 kernels' TMA "
                f"loads, got base % 16 = {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride())}")


def _strides(*tensors):
    return [st for t in tensors for st in t.stride()[:3]]


def _needs_head_pad(q) -> bool:
    return (q.dtype == torch.bfloat16 and q.dim() == 4
            and q.shape[-1] % _TMA_HEAD_MULTIPLE != 0)


def _pad_head(*tensors):
    """Copies of bf16 [B, S, N, H] tensors with the head axis zero-padded
    to the next multiple of 8, as the reference's ``_pad_head`` pads every
    head. Zero columns add nothing to q k^T, dO v^T or any product over H."""
    h = tensors[0].shape[-1]
    pad = -h % _TMA_HEAD_MULTIPLE
    return [torch.nn.functional.pad(t, (0, pad)) for t in tensors]


def flash_attention_cuda(q, k, v, causal: bool = True,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) from the CUDA kernel, same contract as
    ``flash_attention_plain``: the ``wgmma`` kernel for bf16, which rounds
    P to bf16 for P V, the CUDA-core kernel for fp32. Raises on what the
    kernel does not take; nothing is copied, except a bf16 head dim that is
    not a multiple of 8, which is padded to one (the scale stays that of
    the true head dim) and O sliced back."""
    global launches
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _needs_head_pad(q):
        out, lse = flash_attention_cuda(*_pad_head(q, k, v), causal, sm_scale)
        return out[..., :q.shape[-1]], lse
    _check_kernel_inputs(q, k, v)
    if q.dtype == torch.bfloat16:
        _check_tma_operands(q=q, k=k, v=v)
    b, s_q, n, h = q.shape
    s_k = k.shape[1]
    out = torch.empty((b, s_q, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * n, s_q), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], b, n, s_q, s_k, h,
            *_strides(q, k, v, out), float(sm_scale), int(bool(causal)),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out, lse


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale,
                                dq) -> None:
    """Launch the dQ kernel into ``dq`` (q's shape and dtype). The
    arguments are those ``flash_attention_bwd_cuda`` has checked; LSE and
    D are contiguous fp32 [B*N, Sq]."""
    global launches_bwd_dq
    b, s_q, n, h = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bwd_kernel_lib().flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _DTYPE_CODES[q.dtype], b, n, s_q, k.shape[1], h,
            *_strides(q, k, v, do, dq), float(sm_scale), int(bool(causal)),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash attention dQ kernel launch failed: CUDA "
                           f"error {rc}")
    launches_bwd_dq += 1


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, sm_scale,
                                 dk, dv) -> None:
    """Launch the dK/dV kernel into ``dk`` and ``dv`` (k's shape and
    dtype), with the arguments of ``flash_attention_bwd_dq_cuda``."""
    global launches_bwd_dkv
    b, s_q, n, h = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bwd_kernel_lib().flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], b, n, s_q, k.shape[1], h,
            *_strides(q, k, v, do, dk, dv), float(sm_scale),
            int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention dK/dV kernel launch failed: "
                           f"CUDA error {rc}")
    launches_bwd_dkv += 1


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = True,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dQ, dK, dV) from the CUDA kernels, same contract as
    ``flash_attention_bwd_plain``: the ``wgmma`` kernels for bf16, the
    CUDA-core kernels for fp32. Raises on what the kernels do not take;
    a dO whose head axis is not contiguous is copied once, and a bf16 head
    dim that is not a multiple of 8 is padded as in the forward, with the
    gradients sliced back."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _needs_head_pad(q):
        h = q.shape[-1]
        grads = flash_attention_bwd_cuda(*_pad_head(q, k, v, o), lse,
                                         *_pad_head(do), causal, sm_scale)
        return tuple(g[..., :h] for g in grads)
    if do.dim() == 4 and do.stride(-1) != 1:
        do = do.contiguous()
    _check_kernel_inputs(q, k, v, o=o, do=do)
    b, s_q, n, _ = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b * n, s_q) or not lse.is_contiguous()
            or lse.data_ptr() % 16):
        raise ValueError(f"lse must be contiguous, 16-byte aligned float32 "
                         f"[B*N, Sq] = {(b * n, s_q)} on q's device, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if q.dtype == torch.bfloat16:
        _check_tma_operands(q=q, k=k, v=v, do=do)
        if b * n * s_q >= 2 ** 31:
            raise ValueError(f"the bf16 kernels index LSE and D with 32-bit "
                             f"coordinates: B*N*Sq = {b * n * s_q}")
    delta = flash_attention_bwd_delta(o, do)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale, dq)
    flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, sm_scale,
                                 dk, dv)
    return dq, dk, dv


def _on_device(cpu_fn, cuda_fn, *args):
    device = args[0].device
    if device.type == "cpu":
        return cpu_fn(*args)
    if device.type == "cuda":
        return cuda_fn(*args)
    raise ValueError(f"flash attention runs on cuda or cpu, got {device}")


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = _on_device(flash_attention_plain, flash_attention_cuda,
                              q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _on_device(
            flash_attention_bwd_plain, flash_attention_bwd_cuda,
            q, k, v, out, lse, grad_out, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    interpret: Optional[bool] = None):
    """Fused attention. [B,S,N,H] -> [B,S,N,H].

    ``block_q``, ``block_k`` and ``interpret`` keep the JAX package's
    signature. They do not change the result: the Hopper kernels' tiles are
    fixed by their shared-memory layout, the plain version has no blocks,
    and where the tensors lie decides between kernel and plain version.
    """
    del block_q, block_k, interpret
    return _FlashAttention.apply(q, k, v, causal, sm_scale)
