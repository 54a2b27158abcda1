#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the ``ray_tpu_torch`` package beside this file;
without them it exits non-zero and prints no result. It imports nothing of
JAX and nothing of ``ray_tpu``.

Phases, each fatal on failure:

1. Device: name, count and power limit; every kernel in
   ``ray_tpu_torch/csrc`` built from source, with the build time.
2. Forward kernel: held against its plain PyTorch version on the card.
   fp32 (the CUDA-core kernel) at ragged and whole-tile lengths, causal
   and not; bf16 (the wgmma kernel) at the same shapes, at Sq != Sk, on
   strided views of a fused qkv tensor and at the flagship shape, O held
   by max abs, as a whole and per 64-row tile of each head, LSE by max
   abs; two bf16 runs at the flagship shape must agree bit for bit. Then
   timed with CUDA events beside the plain version and one library call
   that computes the same function, with TFLOP/s and share of its bound.
3. Backward kernels (dQ, dK/dV): held against the plain backward on the
   same (q, k, v, O, LSE, dO). fp32 (the CUDA-core kernels) at ragged and
   whole-tile lengths, causal and not; bf16 (the wgmma kernels) at the
   same shapes, on strided views of a fused qkv tensor, and at the
   flagship shape, each gradient held both as a whole and per 64-row tile
   of each head; two bf16 runs at the flagship shape must agree bit for
   bit. Then timed with the D computation, the plain backward and the
   library's backward, with each kernel's TFLOP/s and share of its bound.
4. Head dims: forward and backward kernels at H = 16, 32 and 96 (run on
   the instance of the next width up, columns past H masked), fp32 and
   bf16, against the plain versions under the same bounds.
5. Memory: peak device memory of a kernel-path attention forward and
   backward grows linearly in S (no S x S tensor).
6. Serving: the flagship transformer (671M parameters, random weights from
   a seed) at full width answers 8 requests of 2048 tokens in 2 batches
   of 4, each answer the greedy next token and the head of the
   last-position logits. The launch counts show that the attention went
   through the forward kernel; the logits are held against the plain
   attention path. One more batch is traced with torch.profiler.
7. Training: the flagship at full width takes 6 optimizer steps on batches
   of 4 x 2048 tokens. The launch counts show that every step's attention
   went through the three kernels, 8 launches each. One more step is
   traced with torch.profiler.
8. Training parity: one gradient of the loss at batch 1 x 2048 through the
   kernels, held against the plain attention path in bf16 and in fp32.

Each trace prints the device operations that took the most time and the
share that the attention kernels took. Then ``{"serving": ...}``,
``{"training": ...}`` and ``{"kernels": [...]}`` lines, and last the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# ``ray_tpu_torch.ops.flash_attention`` is shadowed by the function of the
# same name in ``ray_tpu_torch.ops``; import the modules by path.
native_loader = importlib.import_module("ray_tpu_torch._private.native_loader")
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
tfm = importlib.import_module("ray_tpu_torch.models.transformer")
trn = importlib.import_module("ray_tpu_torch.models.training")

# Tolerances, fixed before the first run on the card.
FP32_O_TOL = 2e-5     # abs and rel: the JAX package's forward bound; TF32 off
BF16_O_TOL = 2e-2     # abs, compared in fp32: about one bf16 step at |o| < 4
BF16_O_REL = 1e-2     # |dO| / |O_plain|, compared in fp32
LSE_TOL = 1e-4        # abs
LOGITS_GAP_FACTOR = 2.0  # kernel path vs plain path, over plain bf16 vs fp32
FP32_GRAD_TOL = 2e-4  # abs and rel: the JAX package's gradient bound; TF32 off
BF16_GRAD_REL = 1e-2  # |dg| / |g_plain| per gradient, compared in fp32
BF16_TILE_REL = 2e-2  # the same (O or a gradient), for the worst 64-row
                      # tile of any (b, n) head
GRAD_GAP_FACTOR = 2.0    # model gradient and loss, kernel vs plain bf16, over
LOSS_GAP_FLOOR = 1e-3    # plain bf16 vs fp32 (the loss bound has this floor)
MEM_DOUBLING_MAX = 2.2   # peak memory growth per doubling of S (linear: 2)

# Published H100 SXM peaks (dense): used only for the bound, never measured.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

SEED = 0
DEVICE = "cuda"
FLAGSHIP_ATTN = (4, 2048, 16, 128)   # B, S, N, H at the flagship width
N_REQUESTS, BATCH, SEQ = 8, 4, 2048
TRAIN_STEPS = 6
MEM_SEQS = (1024, 2048, 4096)        # B1 N16 H128 bf16
OTHER_HEAD_DIMS = (16, 32, 96)
TOP_OPS = 12                         # device operations listed per trace
# Kinds of device operation in a trace, by a piece of the kernel's name
# in lower case; the first kind that matches takes it. Every kernel of
# ops/flash_attention.py has "flash_" in its name; cuBLAS's have "nvjet"
# or "gemm".
OP_KINDS = (("attention kernels", ("flash_",)),
            ("matmuls", ("nvjet", "gemm", "xmma")),
            ("casts and copies", ("copy",)),
            ("reductions", ("reduce",)),
            ("softmax", ("softmax",)),
            ("other elementwise", ("elementwise",)))


def flagship_config():
    """The flagship of bench.py:1289-1293 at full width and depth."""
    return tfm.TransformerConfig(
        vocab_size=32_768, d_model=2048, n_layers=8, n_heads=16,
        n_kv_heads=16, d_ff=8192, max_seq_len=SEQ, remat=False,
        use_flash=True, dtype=torch.bfloat16)


def launch_counts():
    return fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv


def reset_launch_counts():
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attended_pairs(s_q, s_k, causal):
    """(query, key) pairs the mask keeps: k_pos <= q_pos, top-left."""
    if causal:
        return sum(min(i + 1, s_k) for i in range(s_q))
    return s_q * s_k


def flash_fwd_flops(b, s_q, s_k, n, h, causal):
    """Operations of the forward over the unmasked pairs: q k^T and p v."""
    return 4 * b * n * h * attended_pairs(s_q, s_k, causal)


def flash_bound_ms(b, s_q, s_k, n, h, causal, dtype_name, itemsize):
    """Least time for the flash forward on the card: the larger of its
    products at the peak rate of the input type and its bytes (q, k, v
    read once, o and the fp32 LSE written once) at the memory rate."""
    flops = flash_fwd_flops(b, s_q, s_k, n, h, causal)
    nbytes = (2 * b * s_q * n * h + 2 * b * s_k * n * h) * itemsize \
        + 4 * b * n * s_q
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                        else "bytes")


def flash_bwd_flops(kernel, b, s_q, s_k, n, h, causal):
    """Operations of a backward kernel over the unmasked pairs: dQ takes
    three products (q k^T, dO v^T, dS k), dK/dV four (q k^T, dO v^T,
    P^T dO, dS^T q)."""
    return (2 * {"dq": 3, "dkv": 4}[kernel] * b * n * h
            * attended_pairs(s_q, s_k, causal))


def flash_bwd_bound_ms(kernel, b, s_q, s_k, n, h, causal, dtype_name,
                       itemsize):
    """Least time for a backward kernel on the card, as for the forward:
    its products (``flash_bwd_flops``) at the peak rate of the input
    type, or its bytes: dQ moves q, k, v, dO and dQ once with the fp32
    LSE and D, dK/dV q, k, v, dO, dK and dV once with LSE and D."""
    n_q_tensors, n_k_tensors = {"dq": (3, 2), "dkv": (2, 4)}[kernel]
    flops = flash_bwd_flops(kernel, b, s_q, s_k, n, h, causal)
    nbytes = (n_q_tensors * b * s_q + n_k_tensors * b * s_k) * n * h \
        * itemsize + 2 * 4 * b * n * s_q
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                        else "bytes")


def worst_tile_rel(g, w, rows=64):
    """Largest |g - w| / |w| over the ``rows``-row tiles of each (b, n)
    head of two [B, S, N, H] tensors, in fp32."""
    d, w = g.float() - w.float(), w.float()
    worst = 0.0
    for r0 in range(0, g.shape[1], rows):
        num = d[:, r0:r0 + rows].norm(dim=(1, 3))
        den = w[:, r0:r0 + rows].norm(dim=(1, 3)).clamp_min(1e-30)
        worst = max(worst, (num / den).max().item())
    return worst


GRAD_NAMES = ("dQ", "dK", "dV")


def check_fp32_forward(got, want, what):
    """fp32 O within FP32_O_TOL abs and rel, LSE within LSE_TOL."""
    (o, lse), (ro, rlse) = got, want
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o).all()), f"non-finite O at {what}")
    excess = ((o - ro).abs() - (FP32_O_TOL + FP32_O_TOL * ro.abs())).max()
    err_o = (o - ro).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    print(f"flash fp32 {what}: |dO| {err_o:.3g} |dLSE| {err_lse:.3g}")
    check(excess.item() <= 0.0,
          f"fp32 O off by more than {FP32_O_TOL} abs/rel at {what}")
    check(err_lse <= LSE_TOL, f"LSE off by {err_lse} at {what}")


def check_bf16_forward(got, want, what):
    """bf16 O against the plain forward (the wgmma kernel rounds P to bf16
    for P V, the plain version does not): max abs, relative norm and
    worst 64-row tile of any head, in fp32; LSE by max abs. Returns the
    four errors."""
    (o, lse), (ro, rlse) = got, want
    check(o.dtype == torch.bfloat16, f"O is {o.dtype} at {what}")
    check(bool(torch.isfinite(o).all()), f"non-finite bf16 O at {what}")
    diff = o.float() - ro.float()
    err = {"max_abs_err": diff.abs().max().item(),
           "rel_err": (diff.norm() / ro.float().norm()).item(),
           "tile_rel_err": worst_tile_rel(o, ro),
           "lse_err": (lse - rlse).abs().max().item()}
    print(f"flash bf16 {what}: |dO| {err['max_abs_err']:.3g}, rel norm "
          f"{err['rel_err']:.3g} (worst tile {err['tile_rel_err']:.3g}), "
          f"|dLSE| {err['lse_err']:.3g}")
    check(err["max_abs_err"] <= BF16_O_TOL,
          f"bf16 O off by {err['max_abs_err']} at {what}")
    check(err["rel_err"] <= BF16_O_REL,
          f"bf16 O off by {err['rel_err']:.3g} in relative norm at {what}")
    check(err["tile_rel_err"] <= BF16_TILE_REL,
          f"bf16 O off by {err['tile_rel_err']:.3g} in relative norm in one "
          f"64-row tile at {what}")
    check(err["lse_err"] <= LSE_TOL, f"bf16 LSE off by {err['lse_err']} at "
          f"{what}")
    return err


def check_fp32_grads(got, want, what):
    """fp32 gradients within FP32_GRAD_TOL abs and rel."""
    torch.cuda.synchronize()
    errs = []
    for name, g, w in zip(GRAD_NAMES, got, want):
        check(bool(torch.isfinite(g).all()), f"non-finite {name} at {what}")
        excess = ((g - w).abs()
                  - (FP32_GRAD_TOL + FP32_GRAD_TOL * w.abs())).max()
        check(excess.item() <= 0.0,
              f"fp32 {name} off by more than {FP32_GRAD_TOL} abs/rel at "
              f"{what}")
        errs.append((g - w).abs().max().item())
    print(f"flash bwd fp32 {what}: max abs err " + " ".join(
        f"{n} {e:.3g}" for n, e in zip(GRAD_NAMES, errs)))


def check_bf16_grads(got, want, what):
    """Whole-tensor and worst-tile relative norms and the max abs error
    of each bf16 gradient; fails past BF16_GRAD_REL or BF16_TILE_REL."""
    rel, tile, abs_err = {}, {}, {}
    for name, g, w in zip(GRAD_NAMES, got, want):
        check(g.dtype == torch.bfloat16, f"{name} is {g.dtype}")
        check(bool(torch.isfinite(g).all()), f"non-finite bf16 {name} "
              f"at {what}")
        diff = g.float() - w.float()
        rel[name] = (diff.norm() / w.float().norm()).item()
        abs_err[name] = diff.abs().max().item()
        tile[name] = worst_tile_rel(g, w)
        check(rel[name] <= BF16_GRAD_REL,
              f"bf16 {name} off by {rel[name]:.3g} in relative norm at "
              f"{what}")
        check(tile[name] <= BF16_TILE_REL,
              f"bf16 {name} off by {tile[name]:.3g} in relative norm in "
              f"one 64-row tile at {what}")
    print(f"flash bwd bf16 {what}: rel norm " + " ".join(
        f"{n_} {rel[n_]:.3g} (worst tile {tile[n_]:.3g}, max abs "
        f"{abs_err[n_]:.3g})" for n_ in GRAD_NAMES))
    return rel, tile, abs_err


def profile_device(fn, label):
    """Run ``fn`` once under torch.profiler and print the device
    operations that took the most time, the time of each kind in
    ``OP_KINDS`` with its share, and the share of the window in which the
    device was idle."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    totals, counts = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            totals[e.name] = totals.get(e.name, 0.0) + e.device_time_total / 1e3
            counts[e.name] = counts.get(e.name, 0) + 1
    device_ms = sum(totals.values())
    if device_ms == 0.0:
        print(f"profile {label}: the profiler saw no device operation; "
              f"breakdown not measured")
        return {"wall_ms": wall_ms, "device_ms": None}
    kinds = {kind: 0.0 for kind, _ in OP_KINDS}
    kinds["other"] = 0.0
    for name, t in totals.items():
        kind = next((kind for kind, keys in OP_KINDS
                     if any(key in name.lower() for key in keys)), "other")
        kinds[kind] += t
    attention_ms = kinds["attention kernels"]
    top = sorted(totals, key=totals.get, reverse=True)[:TOP_OPS]
    print(f"profile {label}: window {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms (idle share {1 - device_ms / wall_ms:.3f}), "
          f"attention kernels {attention_ms:.3f} ms "
          f"({attention_ms / device_ms:.3f} of device time), "
          f"{len(totals)} distinct operations")
    print(f"profile {label} by kind: " + ", ".join(
        f"{kind} {t:.3f} ms ({t / device_ms:.3f})"
        for kind, t in kinds.items()))
    for name in top:
        print(f"  {totals[name]:9.3f} ms {totals[name] / device_ms:6.3f} "
              f"x{counts[name]:<5d} {name[:110]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms,
            "attention_ms": attention_ms,
            "attention_share": attention_ms / device_ms, "by_kind_ms": kinds,
            "top": [[name[:110], counts[name], totals[name]] for name in top]}


def phase_device():
    count = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"device: {name} (count {count})")
    print(smi.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reports = native_loader.build()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {sorted(reports) or 'cached'} in {build_s:.2f} s")
    for src, report in sorted(reports.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    return name, count


def phase_kernels():
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    for causal in (True, False):
        for s in (96, 160, 256):
            for h in (64, 128):
                what = f"causal={causal} S={s} H={h}"
                q, k, v = (randn((2, s, 3, h), torch.float32) for _ in range(3))
                check_fp32_forward(fa.flash_attention_cuda(q, k, v, causal),
                                   fa.flash_attention_plain(q, k, v, causal),
                                   what)
                q, k, v = (randn((2, s, 3, h), torch.bfloat16)
                           for _ in range(3))
                check_bf16_forward(fa.flash_attention_cuda(q, k, v, causal),
                                   fa.flash_attention_plain(q, k, v, causal),
                                   what)
        for s_q, s_k in ((160, 96), (96, 200)):
            q = randn((2, s_q, 3, 128), torch.bfloat16)
            k, v = (randn((2, s_k, 3, 128), torch.bfloat16) for _ in range(2))
            check_bf16_forward(fa.flash_attention_cuda(q, k, v, causal),
                               fa.flash_attention_plain(q, k, v, causal),
                               f"causal={causal} Sq={s_q} Sk={s_k}")

    # q, k, v: strided views of one fused [B, S, 3, N, H] tensor.
    q, k, v = randn((2, 200, 3, 4, 128), torch.bfloat16).unbind(dim=2)
    check_bf16_forward(fa.flash_attention_cuda(q, k, v, True),
                       fa.flash_attention_plain(q, k, v, True),
                       "fused qkv views, S=200")

    b, s, n, h = FLAGSHIP_ATTN
    q, k, v = (randn((b, s, n, h), torch.bfloat16) for _ in range(3))
    got = fa.flash_attention_cuda(q, k, v, True)
    err = check_bf16_forward(got, fa.flash_attention_plain(q, k, v, True),
                             f"causal flagship {FLAGSHIP_ATTN}")
    again = fa.flash_attention_cuda(q, k, v, True)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    print(f"flash bf16 flagship repeat run bit-identical: {repeat}")
    check(repeat, "two bf16 forward runs at the flagship shape differ")
    del got, again

    kernel_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, True),
                        iters=20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                       iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=20)
    bound_ms, bound_by = flash_bound_ms(b, s, s, n, h, True, "bfloat16",
                                        q.element_size())
    tflops = flash_fwd_flops(b, s, s, n, h, True) / (kernel_ms * 1e-3) / 1e12
    print(f"flash timing at {FLAGSHIP_ATTN} bf16 causal: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    print(f"flash fwd: {tflops:.1f} TFLOP/s, {bound_ms / kernel_ms:.3f} of "
          f"its bound, {kernel_ms / library_ms:.3f}x sdpa's time")
    return {**err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "tflops": tflops,
            "share_of_bound": bound_ms / kernel_ms}


def phase_head_dims():
    """Forward and backward kernels at head dims other than 64 and 128,
    against the plain versions, fp32 and bf16, causal and not."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    for h in OTHER_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v, do = (torch.randn((2, 160, 3, h), generator=gen,
                                           device=DEVICE).to(dtype)
                               for _ in range(4))
                what = f"H={h} causal={causal} S=160"
                got = fa.flash_attention_cuda(q, k, v, causal)
                want = fa.flash_attention_plain(q, k, v, causal)
                check(got[0].shape == q.shape, f"O is {tuple(got[0].shape)} "
                      f"at {what}")
                if dtype == torch.float32:
                    check_fp32_forward(got, want, what)
                else:
                    check_bf16_forward(got, want, what)
                o, lse = want
                grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
                ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
                if dtype == torch.float32:
                    check_fp32_grads(grads, ref, what)
                else:
                    check_bf16_grads(grads, ref, what)


def phase_backward_kernels():
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)

    def inputs(shape, dtype, causal):
        q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE)
                       .to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_plain(q, k, v, causal)
        return q, k, v, o, lse, do

    for causal in (True, False):
        for s in (96, 160, 256):
            for h in (64, 128):
                what = f"causal={causal} S={s} H={h}"
                args = inputs((2, s, 3, h), torch.float32, causal)
                check_fp32_grads(fa.flash_attention_bwd_cuda(*args, causal),
                                 fa.flash_attention_bwd_plain(*args, causal),
                                 what)
                args = inputs((2, s, 3, h), torch.bfloat16, causal)
                check_bf16_grads(fa.flash_attention_bwd_cuda(*args, causal),
                                 fa.flash_attention_bwd_plain(*args, causal),
                                 what)

    # q, k, v: strided views of one fused [B, S, 3, N, H] tensor; dO with
    # a head axis that is not contiguous (the wrapper copies it once).
    qkv = torch.randn((2, 200, 3, 4, 128), generator=gen,
                      device=DEVICE).to(torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    o, lse = fa.flash_attention_plain(q, k, v, True)
    do = torch.randn((2, 200, 4, 128), generator=gen,
                     device=DEVICE).to(torch.bfloat16)
    do_strided = do.transpose(-1, -2).contiguous().transpose(-1, -2)
    check_bf16_grads(
        fa.flash_attention_bwd_cuda(q, k, v, o, lse, do_strided, True),
        fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True),
        "fused qkv views, S=200")
    del qkv, q, k, v, o, lse, do, do_strided

    b, s, n, h = FLAGSHIP_ATTN
    q, k, v, o, lse, do = inputs((b, s, n, h), torch.bfloat16, True)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    rel_err, tile_err, abs_err = check_bf16_grads(got, want, f"causal "
                                                  f"flagship {FLAGSHIP_ATTN}")
    del want
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    print(f"flash bwd bf16 flagship repeat run bit-identical: {repeat}")
    check(repeat, "two bf16 backward runs at the flagship shape differ")
    del got, again

    scale = 1.0 / math.sqrt(h)
    delta = fa.flash_attention_bwd_delta(o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, do, lse, delta, True, scale, dq), iters=20)
    dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
        q, k, v, do, lse, delta, True, scale, dk, dv), iters=20)
    delta_ms = time_ms(lambda: fa.flash_attention_bwd_delta(o, do), iters=20)
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, True), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        out = sdpa(qt, kt, vt, is_causal=True)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    sdpa_fwd_ms = time_ms(sdpa_fwd, iters=20)
    sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd, iters=20)
    library_ms = sdpa_fwd_bwd_ms - sdpa_fwd_ms
    bounds = {kern: flash_bwd_bound_ms(kern, b, s, s, n, h, True, "bfloat16",
                                       q.element_size())
              for kern in ("dq", "dkv")}
    times = {"dq": dq_ms, "dkv": dkv_ms}
    tflops = {kern: flash_bwd_flops(kern, b, s, s, n, h, True)
              / (times[kern] * 1e-3) / 1e12 for kern in times}
    pair_ms = dq_ms + dkv_ms + delta_ms
    print(f"flash bwd timing at {FLAGSHIP_ATTN} bf16 causal: dQ kernel "
          f"{dq_ms:.4f} ms (bound {bounds['dq'][0]:.4f} ms, "
          f"{bounds['dq'][1]}), dK/dV kernel {dkv_ms:.4f} ms (bound "
          f"{bounds['dkv'][0]:.4f} ms, {bounds['dkv'][1]}), D "
          f"{delta_ms:.4f} ms, plain backward {plain_ms:.4f} ms, sdpa "
          f"backward {library_ms:.4f} ms (fwd+bwd {sdpa_fwd_bwd_ms:.4f} "
          f"- fwd {sdpa_fwd_ms:.4f})")
    for kern, label in (("dq", "dQ"), ("dkv", "dK/dV")):
        print(f"flash bwd {label}: {tflops[kern]:.1f} TFLOP/s, "
              f"{bounds[kern][0] / times[kern]:.3f} of its bound")
    print(f"flash bwd dQ + dK/dV + D {pair_ms:.4f} ms against sdpa backward "
          f"{library_ms:.4f} ms: {pair_ms / library_ms:.3f}x")
    return {"dq": {"max_abs_err": abs_err["dQ"], "rel_err": rel_err["dQ"],
                   "tile_rel_err": tile_err["dQ"],
                   "ms": dq_ms, "tflops": tflops["dq"],
                   "bound_ms": bounds["dq"][0],
                   "bound_by": bounds["dq"][1]},
            "dkv": {"max_abs_err": max(abs_err["dK"], abs_err["dV"]),
                    "rel_err": max(rel_err["dK"], rel_err["dV"]),
                    "tile_rel_err": max(tile_err["dK"], tile_err["dV"]),
                    "ms": dkv_ms, "tflops": tflops["dkv"],
                    "bound_ms": bounds["dkv"][0],
                    "bound_by": bounds["dkv"][1]},
            "delta_ms": delta_ms, "plain_ms": plain_ms,
            "library_ms": library_ms}


def phase_memory():
    """Peak memory of a kernel-path attention forward and backward, above
    what was allocated before its inputs, at B1 N16 H128 bf16."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    peaks = []
    for s in MEM_SEQS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        q, k, v = (torch.randn((1, s, 16, 128), generator=gen, device=DEVICE,
                               dtype=torch.bfloat16).requires_grad_()
                   for _ in range(3))
        do = torch.randn((1, s, 16, 128), generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
        out = fa.flash_attention(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        check(tuple(a - b for a, b in zip(launch_counts(), before))
              == (1, 1, 1), "memory check did not run the kernels")
        del q, k, v, do, out, grads
    ratios = [b / a for a, b in zip(peaks, peaks[1:])]
    print(f"attention fwd+bwd peak memory at S={MEM_SEQS}: {peaks} bytes, "
          f"ratio per doubling {[round(r, 4) for r in ratios]}")
    check(all(r <= MEM_DOUBLING_MAX for r in ratios),
          f"peak memory grows faster than linear in S: {ratios}")
    return {"seqs": list(MEM_SEQS), "peak_bytes": peaks,
            "ratio_per_doubling": ratios}


def phase_training():
    cfg = flagship_config()
    tx = trn.make_optimizer(total_steps=1000)
    t0 = time.perf_counter()
    state = trn.init_state(cfg, tx, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = trn.make_train_step(cfg, tx)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (BATCH, SEQ))).to(DEVICE)
    probes = [state.params["blocks"][0]["wq"], state.params["final_norm"]]
    before = [p.detach().clone() for p in probes]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses, norms = [], [], []
    for i in range(TRAIN_STEPS):
        counts = launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step = tuple(a - b for a, b in zip(launch_counts(), counts))
        check(per_step == (cfg.n_layers,) * 3,
              f"step {i}: (fwd, dQ, dK/dV) launches {per_step}, expected "
              f"{cfg.n_layers} each")
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        check(metrics["step"] == i, f"step {i} reported {metrics['step']}")
        if i == 0:   # lr is 0 at step 0: nothing moves
            check(all(torch.equal(p.detach(), b)
                      for p, b in zip(probes, before)),
                  "parameters moved on step 0, where lr is 0")
        elif i == 1:
            check(all(not torch.equal(p.detach(), b)
                      for p, b in zip(probes, before)),
                  "parameters did not move on step 1")
    launches = launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses + norms),
          f"non-finite loss or grad norm: {losses}, {norms}")
    check(state.step == TRAIN_STEPS, f"state at step {state.step}")
    profile = profile_device(lambda: step(state, {"tokens": tokens}),
                             "one training step")
    step_s = sum(times[1:]) / len(times[1:])
    print(f"training: init {init_s:.2f} s; step times {times} s; losses "
          f"{losses}; grad norms {norms}")
    print(f"training: {step_s:.5f} s per step over steps 2-{TRAIN_STEPS}, "
          f"{BATCH * SEQ / step_s:.1f} tokens/s, peak {peak_bytes} bytes, "
          f"launches (fwd, dQ, dK/dV) {launches}")
    del state, probes, before
    return {"config": (f"d{cfg.d_model} L{cfg.n_layers} H{cfg.n_heads}/"
                       f"{cfg.n_kv_heads} ff{cfg.d_ff} V{cfg.vocab_size} "
                       f"bf16, flash, remat off, AdamW total_steps 1000"),
            "batch": BATCH, "seq": SEQ, "steps": TRAIN_STEPS,
            "step_time_s": times, "mean_step_s_2_to_last": step_s,
            "tokens_per_s": BATCH * SEQ / step_s, "peak_mem_bytes": peak_bytes,
            "losses": losses, "grad_norms": norms, "init_s": init_s,
            "profile": profile,
            "launches": {"flash_fwd": launches[0],
                         "flash_bwd_dq": launches[1],
                         "flash_bwd_dkv": launches[2]}}, tokens


def phase_training_parity(tokens):
    """One gradient of the loss at batch 1 through the kernels and through
    the plain attention path in bf16 and fp32, from the same parameters."""
    cfg = flagship_config()
    params = tfm.init_params(cfg, seed=SEED + 4, device=DEVICE)
    leaves = trn.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": tokens[:1]}

    def loss_and_grads(c):
        loss = tfm.loss_fn(params, batch, c)
        return loss.item(), torch.autograd.grad(loss, leaves)

    before = launch_counts()
    loss_k, g_k = loss_and_grads(cfg)
    check(tuple(a - b for a, b in zip(launch_counts(), before))
          == (cfg.n_layers,) * 3, "kernel-path gradient missed a kernel")
    loss_pb, g_pb = loss_and_grads(dataclasses.replace(cfg, use_flash=False))
    loss_pf, g_pf = loss_and_grads(dataclasses.replace(
        cfg, use_flash=False, dtype=torch.float32))

    def dist(a, b):
        return math.sqrt(sum((x - y).double().square().sum().item()
                             for x, y in zip(a, b)))

    ref = math.sqrt(sum(x.double().square().sum().item() for x in g_pf))
    err = dist(g_k, g_pb) / ref
    gap = dist(g_pb, g_pf) / ref
    err_fp32 = dist(g_k, g_pf) / ref
    loss_err, loss_gap = abs(loss_k - loss_pb), abs(loss_pb - loss_pf)
    loss_bound = max(GRAD_GAP_FACTOR * loss_gap, LOSS_GAP_FLOOR)
    print(f"training parity (B1 x {SEQ}): |g_kernel - g_plain_bf16| / "
          f"|g_plain_fp32| {err:.4g}, plain bf16-vs-fp32 gap {gap:.4g}, "
          f"kernel vs fp32 {err_fp32:.4g}; losses kernel {loss_k:.6f}, "
          f"plain bf16 {loss_pb:.6f}, plain fp32 {loss_pf:.6f}")
    check(all(math.isfinite(x) for x in (loss_k, err, gap)),
          "non-finite parity numbers")
    check(gap > 0 and err <= GRAD_GAP_FACTOR * gap,
          f"kernel-path gradient off by {err:.4g}, over "
          f"{GRAD_GAP_FACTOR} x the bf16/fp32 gap {gap:.4g}")
    check(loss_err <= loss_bound,
          f"kernel-path loss off by {loss_err:.4g}, over {loss_bound:.4g}")
    return {"grad_rel_err": err, "grad_rel_gap_bf16_fp32": gap,
            "grad_rel_err_vs_fp32": err_fp32, "loss_kernel": loss_k,
            "loss_plain_bf16": loss_pb, "loss_plain_fp32": loss_pf}


class Replica:
    """Plays a Serve replica of the flagship model: builds the forward
    once, runs it at construction, and answers each batch of requests
    with the greedy next token and the head of the last-position logits
    (the JAX package's serving test returns that head)."""

    def __init__(self, cfg, params, batch, seq):
        self.cfg, self.params = cfg, params
        warm = torch.zeros((batch, seq), dtype=torch.long, device=DEVICE)
        with torch.inference_mode():
            tfm.forward(params, warm, cfg)
        torch.cuda.synchronize()
        self.last_logits = None

    def __call__(self, tokens):
        with torch.inference_mode():
            logits = tfm.forward(self.params, tokens, self.cfg)
        last = logits[:, -1]
        next_tokens = last.argmax(dim=-1).tolist()
        heads = last[:, :4].tolist()
        self.last_logits = logits
        return [{"next_token": t, "logits_head": hd}
                for t, hd in zip(next_tokens, heads)]


def phase_serving():
    cfg = flagship_config()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    leaves = [params["embed"], params["final_norm"], params["unembed"],
              *(t for blk in params["blocks"] for t in blk.values())]
    n_params = sum(t.numel() for t in leaves)
    print(f"init_params: {n_params / 1e6:.1f}M params in "
          f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    requests = torch.randint(0, cfg.vocab_size, (N_REQUESTS, SEQ),
                             generator=gen, device=DEVICE)
    replica = Replica(cfg, params, BATCH, SEQ)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    latencies, answers, first_logits = [], [], None
    for i in range(N_REQUESTS // BATCH):
        batch = requests[i * BATCH:(i + 1) * BATCH]
        before = fa.launches
        t0 = time.perf_counter()
        answers += replica(batch)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        check(fa.launches - before == cfg.n_layers,
              f"batch {i}: {fa.launches - before} flash launches, expected "
              f"{cfg.n_layers}")
        if first_logits is None:
            first_logits = replica.last_logits
    launches = fa.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    check(launches == cfg.n_layers * (N_REQUESTS // BATCH),
          f"{launches} flash launches in the serving run")
    check(launch_counts()[1:] == (0, 0), "serving launched a backward kernel")
    check(len(answers) == N_REQUESTS, f"{len(answers)} answers")
    check(all(0 <= a["next_token"] < cfg.vocab_size
              and all(math.isfinite(x) for x in a["logits_head"])
              for a in answers), "malformed answer")
    check(tuple(first_logits.shape) == (BATCH, SEQ, cfg.vocab_size),
          f"logits shape {tuple(first_logits.shape)}")
    check(bool(torch.isfinite(first_logits).all()), "non-finite logits")

    batch0 = requests[:BATCH]
    with torch.inference_mode():
        plain_bf16 = tfm.forward(params, batch0,
                                 dataclasses.replace(cfg, use_flash=False))
        plain_fp32 = tfm.forward(params, batch0, dataclasses.replace(
            cfg, use_flash=False, dtype=torch.float32))
    err = (first_logits - plain_bf16).abs().max().item()
    gap = (plain_bf16 - plain_fp32).abs().max().item()
    err_fp32 = (first_logits - plain_fp32).abs().max().item()
    agree = (first_logits[:, -1].argmax(-1)
             == plain_fp32[:, -1].argmax(-1)).float().mean().item()
    print(f"logits: |kernel - plain bf16| {err:.4g}, |plain bf16 - plain "
          f"fp32| {gap:.4g}, |kernel - plain fp32| {err_fp32:.4g}, greedy "
          f"agreement with fp32 {agree:.3f}")
    check(gap > 0 and err <= LOGITS_GAP_FACTOR * gap,
          f"kernel-path logits off by {err}, over {LOGITS_GAP_FACTOR} x the "
          f"bf16/fp32 gap {gap}")
    profile = profile_device(lambda: replica(batch0), "one served batch")
    serving = {
        "config": (f"d{cfg.d_model} L{cfg.n_layers} H{cfg.n_heads}/"
                   f"{cfg.n_kv_heads} ff{cfg.d_ff} V{cfg.vocab_size} "
                   f"{str(cfg.dtype).removeprefix('torch.')}, flash"),
        "params": n_params,
        "requests": N_REQUESTS, "batch": BATCH, "seq": SEQ,
        "batch_latency_s": latencies,
        "tokens_per_s": [BATCH * SEQ / t for t in latencies],
        "peak_mem_bytes": peak_bytes,
        "flash_launches": launches,
        "logits_err": err, "logits_gap_bf16_fp32": gap,
        "answers_head": answers[:2],
        "profile": profile,
    }
    return serving, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    name, count = phase_device()
    flash = phase_kernels()
    bwd = phase_backward_kernels()
    phase_head_dims()
    memory = phase_memory()
    serving, serving_launches = phase_serving()
    torch.cuda.empty_cache()
    training, tokens = phase_training()
    torch.cuda.empty_cache()
    training["parity"] = phase_training_parity(tokens)
    training["memory_linear_in_s"] = memory
    train_launches = training["launches"]

    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    src = "ray_tpu/ops/flash_attention.py"
    bwd_src = "ray_tpu_torch/csrc/flash_attention_bwd.cu"
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"{src}:83", "replaces_fn": f"{src}::_flash_fwd_kernel",
        "launches": serving_launches + train_launches["flash_fwd"],
        "launches_by_path": {"serving": serving_launches,
                             "training": train_launches["flash_fwd"]},
        "max_abs_err": flash["max_abs_err"], "max_err": flash["max_abs_err"],
        "rel_err": flash["rel_err"], "tile_rel_err": flash["tile_rel_err"],
        "lse_err": flash["lse_err"],
        "ms": flash["ms"], "kernel_ms": flash["ms"], "tflops": flash["tflops"],
        "share_of_bound": flash["share_of_bound"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "library_is": "SDPA causal forward",
        "variant": "bf16: wgmma + TMA; fp32: CUDA-core FMA",
    }]
    for key, line, fn in (("dq", 227, "_flash_bwd_dq_kernel"),
                          ("dkv", 273, "_flash_bwd_dkv_kernel")):
        k = bwd[key]
        kernels.append({
            "name": f"flash_bwd_{key}", "route": "cuda", "source": bwd_src,
            "replaces": f"{src}:{line}", "replaces_fn": f"{src}::{fn}",
            "launches": train_launches[f"flash_bwd_{key}"],
            "launches_by_path": {"serving": 0, "training":
                                 train_launches[f"flash_bwd_{key}"]},
            "max_abs_err": k["max_abs_err"], "max_err": k["max_abs_err"],
            "rel_err": k["rel_err"], "tile_rel_err": k["tile_rel_err"],
            "ms": k["ms"], "kernel_ms": k["ms"], "tflops": k["tflops"],
            "share_of_bound": k["bound_ms"] / k["ms"],
            "plain_ms": bwd["plain_ms"],
            "plain_is": "the whole plain backward (dQ, dK, dV)",
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": bwd["library_ms"],
            "library_is": "SDPA causal fwd+bwd minus fwd (dQ, dK, dV)",
            "delta_ms": bwd["delta_ms"],
            "variant": "bf16: wgmma + TMA; fp32: CUDA-core FMA",
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
