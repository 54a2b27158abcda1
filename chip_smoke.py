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
4. Head dims: forward and backward kernels at H = 16, 32, 96, 160 and
   256 (run on the instance of the next width up, 64, 128 or 256 columns,
   columns past H masked) and at H = 320 and 512 (output windows that sum
   q k^T over the head's pieces), fp32 and bf16, and bf16 at H = 20, 40
   and 300 (a copy padded to a multiple of 8), against the plain versions
   under the same bounds. Then the kernels timed at the flagship's B and
   S with 8 heads of H = 256, 320 and 512.
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
9. Mesh: a process group over NCCL at world size 1 and the mesh of
   ``MeshSpec.auto(1)``; the flagship at full width and depth takes 6
   steps of ``make_train_step(cfg, tx, mesh)`` (the sharded SPMD step,
   with its fsdp gathers, tp sums and gradient sums as NCCL collectives)
   from the seed-0 weights on phase 7's batch, 8/8/8 launches a step, each
   step's loss and grad norm held against phase 7's ``mesh=None`` step;
   step time, tokens/s and peak memory beside it; one more step traced
   with torch.profiler (NCCL kernels a kind of their own). Then
   ``make_attention_fn(mesh, impl="flash")``, Ulysses with
   ``inner="flash"`` (forward and backward) and ring attention at sp = 1
   on bf16 tensors at the flagship's attention shape, against the plain
   attention, with their launches.
10. Pipeline: on the same world-size-1 mesh (S = 1 stage, T = M = 4
   steps, the exchange a copy), ``forward_pipelined`` of the flagship at
   full width and depth with ``attn_fn=flash_attention`` on phase 7's
   batch: 32 forward launches a call, its logits held against ``forward``
   on the same weights under the serving phase's bound; then one gradient
   of the next-token loss through it, 32 launches of each kernel, held
   against the ``mesh=None`` gradient, whole and leaf by leaf, under
   bounds from this comparison's own readings, its loss within
   MESH_FIRST_LOSS_REL. The first forward, dQ and dK/dV calls of that
   gradient, at the microbatch's shape, are kept and held against the
   plain attention on their own inputs under the kernel phases' bf16
   bounds. Forward and gradient times and peak memory; one more gradient
   traced with torch.profiler.
11. ViT: ViT-B/16 at its published widths (224 x 224, patch 16, d_model
   768, 12 layers, 12 heads, d_ff 3072, 1000 classes), bf16, seed-0
   weights, 64 random images: ``vit_loss_fn``'s gradients held against
   the same in fp32, whole under phase 8's bound and leaf by leaf, its
   loss by phase 8's rule on its own reading, and ``vit_loss_fn_shard``
   on the world-size-1 mesh against ``vit_loss_fn``, loss and every leaf
   within MESH_FIRST_LOSS_REL. Attention is dense, as in the reference:
   no kernel launch. Step time (forward and backward) and peak memory;
   one more step traced with torch.profiler.
12. Scheduler: the device programs of ``ray_tpu_torch._private.scheduler``
   at the scheduling benchmark's shape (bench.py:20-47: 10,000 nodes x 4
   resources, 8 classes, 1,000,000 tasks; 512 bundles; 64 groups x 8
   bundles with k = 128). Each kernel (schedule_classes, pg_pack,
   pg_pack_batch) held against its plain version exactly, then timed by
   CUDA events beside the plain version on the card and the launch floor;
   every edge shape of ``workload``'s three sets exactly against plain;
   pg_pack_batch and its ranking alone also at 40,000 nodes and at
   ``solve_many``'s recorded 16,384-row view, beside
   ``torch.sort(stable=True)`` of the same keys into outputs allocated
   once (``torch.argsort``'s own call), each the least of three passes.
   Then the main path,
   with the launch counts set to 0 just before it:
   ``TpuSchedulingPolicy.schedule_dense`` with the host expansion to
   per-task nodes (tasks/s), ``schedule_batch`` of 4,096 requests over a
   ClusterResourceManager of 1,000 nodes through
   ``CompositeSchedulingPolicy(default_policy())``, and
   ``PgKernelSolver.solve`` / ``solve_many`` over the 10,000-node cluster
   (bundles/s). No node oversubscribed; placed equals admitted.
13. Runtime: ``ray_tpu_torch.init()`` on the card (its ``GPU`` resource
   equals the card count; the node manager schedules through
   ``default_policy("cuda")``). (b) The device tier on CUDA tensors:
   ``put`` then ``get`` returns the identical tensor, ``hbm_bytes`` is its
   ``nbytes``, the card's memory falls by its bytes once the ref and the
   handle are gone, and a CPU task in a process worker consumes a 64 MB
   CUDA tensor's ref (one host copy; the worker gets a CPU tensor and
   sees no card; the card-side tensor stays primary). (c) A
   ``num_gpus=1`` Replica actor builds the flagship from seed 0 on the
   card and answers phase 6's 8 requests in 2 batches, each a ``put``
   ref: 8 forward launches a batch and no backward, the logits within
   phase 6's bound against the plain path, whether they equal phase 6's
   bit for bit, latency beside phase 6's. (d) A ``num_gpus=1`` Trainer
   actor takes 3 steps on phase 7's batch: 8/8/8 launches a step, each
   step's loss and grad norm within MESH_FIRST_LOSS_REL of phase 7's.
   Each actor is killed before the next part and its card memory must
   come back. (e) Two ``num_gpus=0.5`` actors form a collective group and
   run allreduce, allgather and broadcast of seeded CUDA tensors, equal
   to numpy's. (f) A burst of 4,096 ``num_cpus=0.001`` no-op tasks:
   tasks/s and the scheduler kernels' launches it took. (g) A nested
   call: a ``num_cpus=1`` task in a process worker, which sees no card,
   ``get``s a driver ``put`` of a CUDA tensor (its host copy) and
   ``put``s its sum; the driver's ``get`` of that ref equals the sum on
   the card.
14. Serve: a fresh ``init()``; the flagship deployed with
   ``ray_actor_options={"num_gpus": 1}`` through ``serve.run`` (the
   replica builds it from seed 0 on the card and warms one forward).
   (a) Phase 6's 2 batches of 4 token lists through the handle: answers,
   the first batch's last-position logits and its logits sum bit for bit
   equal to phase 6's, 8 forward launches a batch. (b) The 8 sequences
   as 8 concurrent calls of a ``@serve.batch(max_batch_size=4)`` method:
   greedy tokens equal to phase 6's, logits heads within phase 6's bound,
   the gathered batch sizes and the ``ray_tpu_serve_batch_size`` gauge.
   (c) ``serve.start(http=True, proxy_location="driver")``: the 2 batches
   POSTed as JSON to the deployment's route, answers bit for bit equal.
   ``serve.delete`` must give the card's memory back. (d) Two
   ``num_gpus=0.5`` replicas of the card behind the router take 8
   concurrent calls: the calls each took, both right. (e)
   ``serve.shutdown()``: the card's memory back to its baseline, and no
   ``rtpt_`` segment of this run (named after its session or after the
   pid of the driver or of one of its process workers) left in
   ``/dev/shm`` after ``shutdown()``. Latencies beside phase 6's, Serve's
   overhead a batch, replica construction time, peak memory and the
   scheduler kernels' launches of the phase.
15. Train: a fresh ``init()``. (a) The flagship at full width and depth
   through ``DataParallelTrainer`` with ``ScalingConfig(num_workers=1,
   use_gpu=True)`` (the worker on a thread of the driver): the seed-0
   TrainState, 3 steps on phase 7's tokens (passed in
   ``train_loop_config``), one ``train.report`` a step; after step 2 the
   whole state (fp32 parameters and AdamW moments, 8.05 GB) through
   ``save_pytree`` as the reported Checkpoint, which ``report`` copies
   into the trial dir under this run's temporary directory (its free
   bytes printed first). Each step's loss and grad norm within
   MESH_FIRST_LOSS_REL of phase 7's, 8/8/8 launches a step, 3 entries in
   ``metrics_history``; a second ``fit`` with ``resume_from_checkpoint``
   runs step 3 again, its loss and grad norm bit for bit the first fit's;
   the checkpoint's bytes and its save, copy and load seconds. (b) Two
   ``{"GPU": 0.5}`` workers, both on threads of the driver: each sees its
   own rank (0 and 1) and world size 2, and the allreduce of its seeded 1M
   fp32 CUDA vector over the gang's collective group equals numpy's sum.
   After each fit the card's memory is back to its baseline.
16. Multi-slice: ViT-B/16 (``vit_b16_config``, 114.6M parameters, bf16
   compute, dense attention, no kernel) through ``MultiSliceTrainer``
   with ``{"GPU": 0.5}`` ranks, 3 steps, flat (1 slice of 2 ranks) and
   hierarchical (2 slices of 1 rank). The user functions are the
   reference's numpy contract: ``init_fn`` the seed-0 parameters as one
   flat fp32 vector, ``grad_fn`` the ViT loss gradient on the rank's 32
   of 64 seeded images (computed on the card, returned as flat fp32
   numpy), ``apply_fn`` a numpy SGD step whose metric is the synced
   gradient's norm. Flat, hierarchical and a direct loop of the same
   functions (``np.mean`` over the two shards' gradients) agree under the
   reference test's ``assert_allclose``; DCN ``bytes_tx`` is 2 x the
   gradient's bytes x 3 hierarchical and 0 flat, the
   ``ray_tpu_dcn_bytes`` gauge equal. Step times and the seconds a rank
   spends a step in host copies, the gradient, the ``shm`` plane
   (``hierarchical_allreduce``) and the per-call actor checkpoint;
   ``/dev/shm``'s free bytes printed first (the collective files go to a
   temporary directory on disk if it cannot hold them).
17. Cluster: the flagship at full width and depth served on a head that
   owns the card (``Cluster(head_num_cpus=4, num_gpus=1)``, the GCS in
   its own process under ``gcs_mode="process"``) with two remote raylet
   processes of 2 CPUs that see no card. ``df`` of ``TMPDIR`` and
   ``/dev/shm`` and whether pyarrow and pandas import come first. (a) 8
   CPUs and 1 GPU in ``cluster_resources()``; a task pinned to each remote
   node runs under that raylet with ``CUDA_VISIBLE_DEVICES`` empty; a
   remote node with a GPU is refused; spawn-to-registration and first-task
   times. (b) A seeded 64 MB int64 CUDA tensor ``put`` on the head and
   summed on node 1, and a seeded 64 MB int64 array made on node 2 and
   summed on the card by a ``num_gpus=1`` task: both sums exact, seconds,
   GB/s and the pull counters' bytes. (c) A ``num_gpus=1`` Replica actor
   answers phase 6's two batches, each cut on a remote node from phase
   6's requests (the card's generator stream cannot be drawn on a node
   without a card), the refs passed straight in: 8 forward launches a
   batch, answers bit for bit phase 6's. (d) 64 tasks of 0.1 s spread over
   the remote nodes, node 2's raylet killed after 16: all 64 right, node
   2's only copy of a 16 MB object rebuilt by lineage, the GCS's death
   notice, 2 CPUs fewer, and a batch sent during the recovery bit for bit.
   (e) The GCS killed and restarted on its port from its persisted state:
   node 1 reports again, the named replica is found, a task pinned to
   node 1 runs, a batch bit for bit. (f) The client server started with
   ``--num-gpus 1``; a thin ``rtpu://`` client in another interpreter runs
   a task on node 1, a ``num_gpus=1`` flash forward on the card in the
   client server (B1 x S2048 x N16 x H128 bf16, causal, seeded) whose O
   and LSE sums equal this process's bit for bit, and a detached counter
   found again after a reconnect. (g) Teardown: every process exited, the
   card's memory back, no segment of the run in ``/dev/shm`` and nothing
   of it in ``/tmp``.
18. Data, Tune and sharded checkpoints (``ray_tpu_torch.data``,
   ``ray_tpu_torch.tune``, ``train.array_checkpoint``), after a fresh
   ``init()``; it prints the free bytes of ``TMPDIR`` and ``/dev/shm`` and
   the pyarrow and pandas versions first. (a) Phase 6's 8 requests as a
   Dataset of 2 blocks of 4 rows, a CPU ``map_batches`` stage in process
   workers adding a checksum column, then ``map_batches(FlagshipPredictor,
   batch_size=4, concurrency=1, num_gpus=1)``: answers bit for bit phase
   6's, in order, 8 forward launches a batch and no backward, the actor
   on a thread of the driver, the checksums exact, 4 blocks produced and
   2 consumed, the card's memory back once the dataset is consumed; rows/s
   beside phase 6's direct batches. (b) Phase 7's batch three times as a
   12-row Dataset feeding a one-worker ``DataParallelTrainer`` with
   ``use_gpu=True``: 3 steps from the seed-0 state whose losses and grad
   norms are held to phase 15's (bit for bit, or within
   MESH_FIRST_LOSS_REL), 8/8/8 launches a step, the seconds the loop
   waited on the shard's iterator; then ``iter_device_batches`` gives
   CUDA tensors equal to phase 7's tokens. (c) ``range(8 << 20)`` (64 MB
   of int64) through ``random_shuffle(seed=0)`` and ``repartition(16)`` on
   process workers: count and sum exact, order changed, the queued-bytes
   gauge back to 0; seconds and GB/s. (d) A ``Tuner`` sweep of the
   flagship's peak learning rate over 4 values (warmup 1 step), 3 steps a
   trial on phase 7's batch, on ``{"GPU": 0.5}`` trials 2 at a time: each
   trial's losses held to a direct loop's at its learning rate (bit for
   bit, or within MESH_FIRST_LOSS_REL), every trial's reports its own, the
   best trial the direct loops' best, 96 launches of each kernel over the
   12 trial steps, the peak memory of two trials on the card; the card's
   memory back and no ``rtpt_trial`` directory left. (e) The seed-0
   TrainState as DTensors on a world-size-1 mesh (an NCCL process group;
   the save's collectives on a gloo group of their own) saved by
   ``save_sharded(..., async_save=True)``,
   one training step taken in place as soon as it returns, then
   ``wait()``: ``restore_sharded`` gives every leaf bit for bit the state
   at the call, and a step from it equals the step taken, bit for bit;
   staging, background-write and restore seconds and the bytes on disk
   beside phase 15's ``save_pytree`` and ``load_pytree``. (f) Teardown: the
   phase's tensors gone and the card's free bytes back to the phase's
   start (within RUNTIME_FREE_SLACK; read after each part too), no segment
   of the run in ``/dev/shm`` and nothing of it in ``/tmp``.
19. DAGs, workflows and tracing, then the cluster operations
   (``ray_tpu_torch.dag``, ``workflow``, ``util.tracing``, ``autoscaler``,
   ``dashboard``, ``job_submission``, the CLI), on the flagship from seed
   0. (a) Phase 6's two batches through ``compile_to_jit`` of prep ->
   forward -> next-token loss: logits bit for bit the direct forward's,
   the loss equal, answers bit for bit phase 6's, 8 flash launches a
   call; median seconds a call beside the direct call. (b) After
   ``init()``: a compiled DAG of a CPU process-worker actor cutting phase
   6's batches (it holds the requests: phase 6 draws them on the card)
   and a ``num_gpus=1`` ``Replica`` answering them: ``is_fast``, answers
   bit for bit phase 6's, 8 launches an execute; the median execute beside
   the same two calls chained by ``.remote``; a raising CPU stage's error
   reaches the caller through the channel. (c) A workflow cut -> forward
   (a ``num_gpus=1`` task) -> finish whose last step crashes on the first
   run: FAILED, then ``resume`` runs the last step alone (a counter file
   shows each step's runs) and gives the direct forward's next tokens and
   last logits bit for bit. (d) Two of (b)'s executes under
   ``tracing.trace``: the exported Chrome trace holds two
   ``Replica.answer [compiled]`` spans, each with 8 ``flash_fwd_wgmma``
   launches inside it, and ``timeline()`` both stages with ``exec_ms``.
   (e) A ``Cluster`` whose head has no GPU and ``AutoscalerV2`` with a
   logical ``{"CPU": 1, "GPU": 1}`` type: a remote GPU type refused; a
   pending ``num_gpus=1`` Replica launches one node and answers a batch
   bit for bit; killed, its node is terminated past the idle timeout, and
   ``ray_tpu_autoscaler_instances`` on the dashboard's ``/metrics`` shows
   RUNNING then TERMINATED. (f) In a ``TMPDIR`` of its own: ``python -m
   ray_tpu_torch start --head``, ``job submit`` of an entrypoint that
   joins, runs a CPU task and the flash forward at FLAGSHIP_ATTN on the
   card against its plain version (SUCCEEDED, its log line parsed), then
   ``status``, ``list actors`` and ``timeline`` with a driver of this
   process joined, and ``stop``: one process terminated, no segment left.
20. RL (``ray_tpu_torch.rl``), after a fresh ``init()``, every learner on
   the card (TF32 off) and its runners in CPU process workers. (a) PPO
   at the reference's learning-test settings (2 runners x 16 CartPole
   envs, rollout 128, lr 3e-3, 10 epochs, seed 1) in a placement group
   whose learner bundle asks for the GPU: each of its first 3 updates
   held against the same update on the CPU (``make_update(config,
   "cpu")``) on the same params and batch, every parameter within 1e-4;
   up to 30 more iterations must reach the reference's ``best >= 120``;
   update ms, iteration wall time, and the device idle share of one
   update traced with torch.profiler. (b) DQN, IMPALA and multi-agent
   PPO, 2 iterations each, every update held against the CPU path the
   same way, and IMPALA's V-trace targets of each batch computed on the
   card against the CPU function (rtol and atol 1e-4). (c) The learner
   gang (``make_dp_update``) at world size 1 on the card (``LocalRanks(1,
   "cuda")``, one NCCL rank sharing card 0 with this process) for PPO,
   IMPALA and multi-agent PPO on the last batch of (a) or (b): its first
   update held against the in-driver update on the same params and
   batch, every parameter within 1e-4; both ways' update times. The
   launches of every kernel over the phase are its ``rl`` path (all 0:
   RL runs none of the flash or scheduler kernels).
21. Static analysis and the sanitizer (``ray_tpu_torch.devtools``). (a)
   ``python -m ray_tpu_torch.devtools.analysis --ci`` over the port's
   tree on this host: exit 0, no unsuppressed finding, the per-pass
   timings; the committed ``contracts.json`` equal to what
   ``--emit-contracts`` makes of the tree. (b) A child process started
   with ``RTPU_SANITIZE=1`` (the gate acts at import) and its own
   ``RTPU_SANITIZE_LOG`` and ``RTPU_SANITIZE_OBSERVED``: ``init()`` with
   the card, the flagship deployed on a ``num_gpus=1`` Serve replica
   answers phase 6's 8 requests through the handle, its forward kernel
   built at first use under the loader's lock into a build directory of
   the child's own. Fatal: any violation in the child's ring or the log,
   an observed lock pair that inverts a declared ``# lock-order:``, no
   flash forward launch (8 a batch expected), answers or first-batch
   logits that are not phase 14's bit for bit. A request's wall time is
   printed beside phase 14's unsanitized one; ``--diff`` lists the
   observed pairs no declaration covers. Its launches are the
   ``sanitized_serve`` path.
22. The soak (``ray_tpu_torch.soak``): a child process started with
   ``RTPU_SANITIZE=1`` and its own ``RTPU_SANITIZE_LOG`` runs the port's
   composed chaos soak at the reference smoke's seed 600 x 14 s with the
   head on the card (``device="cuda"``), under a 600 s limit. Fatal: a
   non-zero exit, ``ok`` false, any of the six invariants failing or
   ``graftsan-clean`` skipped, counts under the reference test's floors
   (``tests/test_soak.py:206-219``), a live digest other than
   ``generate_schedule(600, 14.0).digest()``. Printed: the run's wall
   time, its counts, the calm and chaos p99 of the ingress. The child's
   launches are the ``soak`` path (0 expected: the lanes are an echo
   deployment, a numpy trainer and CPU tasks).

Each trace prints the device operations that took the most time and the
share that the attention kernels took. Then ``{"serving": ...}``,
``{"training": ...}``, ``{"mesh_training": ...}``, ``{"pipeline": ...}``,
``{"vit": ...}``, ``{"runtime": ...}``, ``{"serve": ...}``,
``{"train": ...}``, ``{"multislice": ...}``, ``{"cluster": ...}``,
``{"data": ...}``, ``{"tune": ...}``, ``{"dag_workflow_ops": ...}``,
``{"rl": ...}``, ``{"sanitize": ...}``, ``{"soak": ...}`` and
``{"kernels": [...]}`` lines (each kernel's ``launches_by_path`` has the
``data``, ``tune`` and ``checkpoint`` paths of phase 18, the ``dag``,
``workflow``, ``autoscaler`` and ``job`` paths of phase 19, the ``rl``
path of phase 20, the ``sanitized_serve`` path of phase 21 and the
``soak`` path of phase 22),
and last the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import importlib
import json
import math
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# ``ray_tpu_torch.ops.flash_attention`` is shadowed by the function of the
# same name in ``ray_tpu_torch.ops``; import the modules by path.
native_loader = importlib.import_module("ray_tpu_torch._private.native_loader")
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
tfm = importlib.import_module("ray_tpu_torch.models.transformer")
trn = importlib.import_module("ray_tpu_torch.models.training")
vit = importlib.import_module("ray_tpu_torch.models.vit")
tp = importlib.import_module("ray_tpu_torch._private.scheduler.tpu_policy")
pk = importlib.import_module("ray_tpu_torch._private.scheduler.pg_kernel")
spol = importlib.import_module("ray_tpu_torch._private.scheduler.policy")
sres = importlib.import_module("ray_tpu_torch._private.scheduler.resources")
swl = importlib.import_module("ray_tpu_torch._private.scheduler.workload")
sids = importlib.import_module("ray_tpu_torch._private.ids")
serve = importlib.import_module("ray_tpu_torch.serve")

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
# Mesh step vs mesh=None step, per step, relative. Steps 1 and 2 run at
# the initial weights (lr is 0 at step 0), where the loss is the same
# function summed anew. The two paths round the loss's gradient apart by
# an ulp, which a bf16 backward grows layer by layer (in fp32 their
# gradients agree to 1e-6), and Adam turns such differences into updates
# of order lr.
MESH_FIRST_LOSS_REL = 1e-5
# Leaf by leaf, |g - g_ref| / |g_ref| of each parameter's gradient, its
# largest over the leaves. Two same-precision paths are held to bounds from
# their own readings (chip_smoke.py on an H100 80GB HBM3, 700 W), by phase
# 8's rule: GRAD_GAP_FACTOR times the reading.
# - The pipeline (S = 1, M = 4) against mesh=None, both bf16 through the
#   kernels: only the matmuls' batch (1 x 2048 rows against 4 x 2048)
#   differs. Readings: the whole tree PIPE_GRAD_READING, the worst leaf
#   PIPE_LEAF_READING. Its loss at the same weights as the mesh step's,
#   within MESH_FIRST_LOSS_REL.
PIPE_GRAD_READING = 2.071e-3
PIPE_LEAF_READING = 2.433e-3    # blocks/4/attn_norm; embed, unembed 0
# - vit_loss_fn_shard at world size 1 against vit_loss_fn: the same
#   operations (readings 0 in the loss and in every leaf); loss and every
#   leaf within MESH_FIRST_LOSS_REL, as the mesh step's first losses.
# ViT-B/16 bf16 against fp32: the whole gradient under phase 8's bound
# (GRAD_GAP_FACTOR times the flagship's measured bf16-vs-fp32 gap); every
# leaf within GRAD_GAP_FACTOR times the worst leaf's reading; the loss (a
# mean over 64 images, not 8,188 tokens) within phase 8's loss rule on its
# own reading: the larger of GRAD_GAP_FACTOR times VIT_LOSS_READING and
# LOSS_GAP_FLOOR.
VIT_LEAF_READING = 6.006e-2     # blocks/11/wq
VIT_LOSS_READING = 1.4205e-3
MESH_LOSS_REL = 1e-3
MESH_NORM_REL = 1e-2

# Published H100 SXM peaks (dense): used only for the bound, never measured.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

SEED = 0
DEVICE = "cuda"
FLAGSHIP_ATTN = (4, 2048, 16, 128)   # B, S, N, H at the flagship width
N_REQUESTS, BATCH, SEQ = 8, 4, 2048
TRAIN_STEPS = 6
MEM_SEQS = (1024, 2048, 4096)        # B1 N16 H128 bf16
OTHER_HEAD_DIMS = (16, 32, 96, 160, 256, 320, 512)
ODD_BF16_HEAD_DIMS = (20, 40, 300)    # bf16 H % 8 != 0: padded copies
# B, S, N, H of the timed wide heads: the flagship's B and S, 8 heads (at
# H = 256 the flagship's d_model)
WIDE_HEAD_ATTNS = ((4, 2048, 8, 256), (4, 2048, 8, 320), (4, 2048, 8, 512))
SCHED_POLICY_NODES, SCHED_POLICY_REQUESTS = 1000, 4096
PIPE_MICROBATCHES = 4                # M; at world size 1, S = 1 and T = M
PIPE_TIMED = 3                       # timed calls after the checked one
VIT_IMAGES = 64
VIT_TIMED = 5
TOP_OPS = 12                         # device operations listed per trace
# Kinds of device operation in a trace, by a piece of the kernel's name
# in lower case; the first kind that matches takes it. Every kernel of
# ops/flash_attention.py has "flash_" in its name; cuBLAS's have "nvjet"
# or "gemm"; NCCL's "nccl".
OP_KINDS = (("attention kernels", ("flash_",)),
            ("collectives (NCCL)", ("nccl",)),
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


def vit_b16_config(dtype=torch.bfloat16):
    """ViT-B/16 at its published widths (Dosovitskiy et al., "An Image is
    Worth 16x16 Words", ICLR 2021, Table 1): 224 x 224 images in patches of
    16 (196 patches), d_model 768, 12 layers, 12 heads, MLP 3072, 1000
    classes. The block is the repo's (SwiGLU MLP, 1D RoPE over the patch
    index), as ray_tpu/models/vit.py defines it; remat off, as the
    flagship's phases run."""
    return vit.ViTConfig(image_size=224, patch_size=16, channels=3,
                         num_classes=1000, d_model=768, n_layers=12,
                         n_heads=12, n_kv_heads=12, d_ff=3072, dtype=dtype,
                         remat=False)


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
    worst 64-row tile of any head, in fp32; LSE by max abs, unless ``got``
    has no LSE (None: an entry point that returns O alone). Returns the
    errors."""
    (o, lse), (ro, rlse) = got, want
    check(o.dtype == torch.bfloat16, f"O is {o.dtype} at {what}")
    check(bool(torch.isfinite(o).all()), f"non-finite bf16 O at {what}")
    diff = o.float() - ro.float()
    err = {"max_abs_err": diff.abs().max().item(),
           "rel_err": (diff.norm() / ro.float().norm()).item(),
           "tile_rel_err": worst_tile_rel(o, ro)}
    if lse is not None:
        err["lse_err"] = (lse - rlse).abs().max().item()
    print(f"flash bf16 {what}: |dO| {err['max_abs_err']:.3g}, rel norm "
          f"{err['rel_err']:.3g} (worst tile {err['tile_rel_err']:.3g})"
          + (f", |dLSE| {err['lse_err']:.3g}" if lse is not None else ""))
    check(err["max_abs_err"] <= BF16_O_TOL,
          f"bf16 O off by {err['max_abs_err']} at {what}")
    check(err["rel_err"] <= BF16_O_REL,
          f"bf16 O off by {err['rel_err']:.3g} in relative norm at {what}")
    check(err["tile_rel_err"] <= BF16_TILE_REL,
          f"bf16 O off by {err['tile_rel_err']:.3g} in relative norm in one "
          f"64-row tile at {what}")
    if lse is not None:
        check(err["lse_err"] <= LSE_TOL, f"bf16 LSE off by {err['lse_err']} "
              f"at {what}")
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
    card = smi.strip().splitlines()[0]
    print(f"device: {name} (count {count})")
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reports = native_loader.build()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {sorted(reports) or 'cached'} in {build_s:.2f} s")
    for src, report in sorted(reports.items()):
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or (src == "scheduler" and "entry function" in line)):
                print(f"  {src}: {line.strip()}")
    return name, count, card


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
    against the plain versions, fp32 and bf16, causal and not; then the
    kernels timed at each of WIDE_HEAD_ATTNS, bf16, causal: the 256-column
    instances and, above 256, the output windows over the head's
    pieces."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    cases = [(h, dtype) for h in OTHER_HEAD_DIMS
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(h, torch.bfloat16) for h in ODD_BF16_HEAD_DIMS]
    for h, dtype in cases:
        for causal in (True, False):
            q, k, v, do = (torch.randn((2, 160, 3, h), generator=gen,
                                       device=DEVICE).to(dtype)
                           for _ in range(4))
            what = f"H={h} {str(dtype)[6:]} causal={causal} S=160"
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
            check(all(g.shape == q.shape for g in grads),
                  f"gradient shapes at {what}")
            ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
            if dtype == torch.float32:
                check_fp32_grads(grads, ref, what)
            else:
                check_bf16_grads(grads, ref, what)

    return {str(shape[3]): time_wide_head(gen, shape)
            for shape in WIDE_HEAD_ATTNS}


def time_wide_head(gen, shape):
    """The three kernels at ``shape`` (B, S, N, H), bf16, causal: held
    against the plain versions, then timed beside their bounds."""
    b, s, n, h = shape
    q, k, v, do = (torch.randn((b, s, n, h), generator=gen, device=DEVICE)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_cuda(q, k, v, True)
    check_bf16_forward((o, lse), fa.flash_attention_plain(q, k, v, True),
                       f"causal {shape}")
    check_bf16_grads(fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True),
                     fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True),
                     f"causal {shape}")
    scale = 1.0 / math.sqrt(h)
    delta = fa.flash_attention_bwd_delta(o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    times = {
        "fwd": time_ms(lambda: fa.flash_attention_cuda(q, k, v, True),
                       iters=10),
        "dq": time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
            q, k, v, do, lse, delta, True, scale, dq), iters=10),
        "dkv": time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
            q, k, v, do, lse, delta, True, scale, dk, dv), iters=10)}
    bounds = {"fwd": flash_bound_ms(b, s, s, n, h, True, "bfloat16", 2)[0]}
    for kern in ("dq", "dkv"):
        bounds[kern] = flash_bwd_bound_ms(kern, b, s, s, n, h, True,
                                          "bfloat16", 2)[0]
    print(f"head dim {h} at {shape} bf16 causal: " + ", ".join(
        f"{kern} {times[kern]:.4f} ms (bound {bounds[kern]:.4f} ms, "
        f"{bounds[kern] / times[kern]:.3f} of it)" for kern in times))
    return {"shape": list(shape), "ms": times, "bound_ms": bounds}


def phase_mesh(training, tokens):
    """The mesh paths at world size 1: a process group over NCCL, the mesh
    of ``MeshSpec.auto(1)``, the flagship's sharded train step from the
    seed-0 weights on the training phase's batch, each step's loss and
    grad norm held against the ``mesh=None`` step's (the training phase's
    numbers, from the same weights and batch), 8/8/8 launches a step; then
    the attention entry points of the mesh layer on CUDA bf16 tensors at
    the flagship's attention shape, each held against the plain
    attention; then the pipeline (``mesh_pipeline``) and ViT-B/16
    (``mesh_vit``). Returns the three results."""
    import tempfile
    import torch.distributed as dist
    pmesh = importlib.import_module("ray_tpu_torch.parallel.mesh")
    xla = importlib.import_module("ray_tpu_torch.collective.xla")
    ring = importlib.import_module("ray_tpu_torch.ops.ring_attention")

    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group(
        "nccl" if DEVICE == "cuda" else "gloo",
        init_method=f"file://{rendezvous}/pg", rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(pmesh.MeshSpec.auto(1), device=DEVICE)
        result = mesh_training(mesh, training, tokens)
        result["attention"] = mesh_attention(mesh, xla, ring)
        torch.cuda.empty_cache()
        pipeline = mesh_pipeline(mesh, tokens)
        torch.cuda.empty_cache()
        vit_result = mesh_vit(mesh, training["parity"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    return result, pipeline, vit_result


def mesh_training(mesh, training, tokens):
    cfg = flagship_config()
    tx = trn.make_optimizer(total_steps=1000)
    t0 = time.perf_counter()
    state = trn.init_state(cfg, tx, seed=SEED, device=DEVICE, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = trn.make_train_step(cfg, tx, mesh)
    batch = {"tokens": tokens}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses, norms = [], [], []
    for i in range(TRAIN_STEPS):
        counts = launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step = tuple(a - b for a, b in zip(launch_counts(), counts))
        check(per_step == (cfg.n_layers,) * 3,
              f"mesh step {i}: (fwd, dQ, dK/dV) launches {per_step}, "
              f"expected {cfg.n_layers} each")
        check(metrics["step"] == i, f"mesh step {i} reported "
              f"{metrics['step']}")
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    launches = launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                    training["losses"])]
    norm_err = [abs(a - b) / abs(b) for a, b in zip(norms,
                                                    training["grad_norms"])]
    check(all(math.isfinite(x) for x in losses + norms),
          f"non-finite mesh loss or grad norm: {losses}, {norms}")
    check(max(loss_err[:2]) <= MESH_FIRST_LOSS_REL,
          f"mesh losses at the initial weights off the mesh=None step's by "
          f"{loss_err[:2]} relative")
    check(max(loss_err) <= MESH_LOSS_REL,
          f"mesh losses {losses} off the mesh=None step's "
          f"{training['losses']} by up to {max(loss_err):.3g} relative")
    check(max(norm_err) <= MESH_NORM_REL,
          f"mesh grad norms {norms} off the mesh=None step's "
          f"{training['grad_norms']} by up to {max(norm_err):.3g} relative")
    profile = profile_device(lambda: step(state, batch),
                             "one mesh training step")
    step_s = sum(times[1:]) / len(times[1:])
    print(f"mesh training (world size 1, NCCL): init {init_s:.2f} s; step "
          f"times {times} s; losses {losses}; grad norms {norms}; relative "
          f"to mesh=None: losses {max(loss_err):.3g}, grad norms "
          f"{max(norm_err):.3g}")
    print(f"mesh training: {step_s:.5f} s per step over steps "
          f"2-{TRAIN_STEPS} ({BATCH * SEQ / step_s:.1f} tokens/s, peak "
          f"{peak_bytes} bytes) beside mesh=None "
          f"{training['mean_step_s_2_to_last']:.5f} s "
          f"({training['tokens_per_s']:.1f} tokens/s, peak "
          f"{training['peak_mem_bytes']} bytes); launches (fwd, dQ, dK/dV) "
          f"{launches}")
    del state
    return {"mesh": "MeshSpec.auto(1) over NCCL", "steps": TRAIN_STEPS,
            "step_time_s": times, "mean_step_s_2_to_last": step_s,
            "tokens_per_s": BATCH * SEQ / step_s,
            "peak_mem_bytes": peak_bytes, "losses": losses,
            "grad_norms": norms, "loss_rel_err": loss_err,
            "grad_norm_rel_err": norm_err, "init_s": init_s,
            "profile": profile,
            "mesh_none": {key: training[key] for key in (
                "mean_step_s_2_to_last", "tokens_per_s", "peak_mem_bytes")},
            "launches": {"flash_fwd": launches[0],
                         "flash_bwd_dq": launches[1],
                         "flash_bwd_dkv": launches[2]}}


def mesh_attention(mesh, xla, ring):
    """``make_attention_fn(mesh, impl="flash")``, Ulysses with
    ``inner="flash"`` (forward and backward) and ring attention at sp = 1,
    on bf16 CUDA tensors at FLAGSHIP_ATTN, each against the plain
    attention under the bf16 bounds, with their kernel launches."""
    pmesh = importlib.import_module("ray_tpu_torch.parallel.mesh")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    q, k, v, do = (torch.randn(FLAGSHIP_ATTN, generator=gen, device=DEVICE)
                   .to(torch.bfloat16) for _ in range(4))
    want = fa.flash_attention_plain(q, k, v, True)
    spec = pmesh.P(("dp", "fsdp"), "sp", "tp", None)
    flash = ring.make_attention_fn(mesh, impl="flash")
    ulysses = xla.shard_map_fn(mesh, (spec,) * 3, spec)(functools.partial(
        ring.ulysses_attention_shard, axis_name="sp", inner="flash"))
    ring_fn = xla.shard_map_fn(mesh, (spec,) * 3, spec)(functools.partial(
        ring.ring_attention_shard, axis_name="sp"))
    out = {}
    for name, fn, expected in (("flash", flash, (1, 0, 0)),
                               ("ulysses_flash", ulysses, (1, 1, 1)),
                               ("ring_sp1", ring_fn, (0, 0, 0))):
        leaves = [t.clone().requires_grad_(name == "ulysses_flash")
                  for t in (q, k, v)]
        before = launch_counts()
        o = fn(*leaves)
        o = o.to_local() if hasattr(o, "to_local") else o
        grads = (torch.autograd.grad(o, leaves, do)
                 if name == "ulysses_flash" else None)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(launch_counts(), before))
        check(launched == expected, f"{name}: (fwd, dQ, dK/dV) launches "
              f"{launched}, expected {expected}")
        err = check_bf16_forward((o.detach(), None), want,
                                 f"{name} on the mesh {FLAGSHIP_ATTN}")
        if grads is not None:
            rel, tile, _ = check_bf16_grads(grads, fa.flash_attention_bwd_plain(
                q, k, v, *want, do, True), f"{name} on the mesh "
                f"{FLAGSHIP_ATTN}")
            err["grad_rel_err"], err["grad_tile_rel_err"] = rel, tile
        out[name] = {**err, "launches": launched}
    return out


def next_token_loss(logits, tokens):
    """``transformer.loss_fn``'s loss on given logits: the mean negative
    log-likelihood of each next token."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:].long()[..., None]).mean()


def grad_dist(a, b):
    """The norm of the difference of two gradient lists, in fp64."""
    return math.sqrt(sum((x - y).double().square().sum().item()
                         for x, y in zip(a, b)))


def grad_norm(a):
    return math.sqrt(sum(x.double().square().sum().item() for x in a))


def mean_s(fn, n):
    """Mean host-clock time of ``n`` calls of ``fn``, each ended by a
    synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sum(times) / n, times


def leaf_names(tree, prefix=""):
    """Names of a parameter tree's leaves ("blocks/3/wq"), in the order of
    ``training.param_leaves``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix]
    return [name for key, value in items for name in leaf_names(
        value, f"{prefix}/{key}" if prefix else str(key))]


def leaf_rel_errs(got, want, names):
    """Each leaf's |got - want| / |want| in fp64, by name."""
    errs = {}
    for name, g, w in zip(names, got, want):
        w = w.double()
        errs[name] = ((g.double() - w).norm()
                      / w.norm().clamp_min(1e-300)).item()
    return errs


def worst_leaf(errs):
    name = max(errs, key=errs.get)
    return name, errs[name]


FLASH_PLAIN = {"flash_attention_cuda": (fa, "flash_attention_plain"),
               "flash_attention_bwd_cuda": (fa, "flash_attention_bwd_plain")}


def check_flash_calls(recorder, what):
    """The flash forward and backward calls that ``recorder`` kept on a
    main path (the forward's O and LSE; the backward's dQ from the dQ
    kernel, dK and dV from the dK/dV kernel), each held against its plain
    version on the same inputs under the kernel phases' bf16 bounds.
    Returns the errors of each call."""
    kept = [name for name, _, _ in recorder.calls]
    check(sorted(kept) == sorted(FLASH_PLAIN),
          f"{what}: kept flash calls {kept}, expected one of each of "
          f"{sorted(FLASH_PLAIN)}")
    out = []
    for name, inputs, outs in recorder.calls:
        mod, plain = FLASH_PLAIN[name]
        want = getattr(mod, plain)(*inputs)
        where = f"{what} {tuple(inputs[0].shape)}"
        if name == "flash_attention_cuda":
            err = check_bf16_forward(tuple(outs), want, where)
        else:
            rel, tile, abs_err = check_bf16_grads(outs, want, where)
            err = {"rel_err": rel, "tile_rel_err": tile,
                   "max_abs_err": abs_err}
        del want
        out.append({"wrapper": name, "shape": list(inputs[0].shape), **err})
    return out


def mesh_pipeline(mesh, tokens):
    """``forward_pipelined`` of the flagship on the world-size-1 mesh (one
    stage: T = M steps, each exchange a copy on the rank) through the flash
    kernels, with the launch counts from 0 for each call: the logits held
    against ``forward`` on the same weights (serving's bound: within
    LOGITS_GAP_FACTOR times the plain bf16-vs-fp32 gap of the same batch),
    one gradient of the next-token loss held against the ``mesh=None``
    gradient (whole and leaf by leaf, GRAD_GAP_FACTOR times this
    comparison's readings; the loss within MESH_FIRST_LOSS_REL). The first
    forward, dQ and dK/dV calls of that gradient (at the microbatch's
    shape) are kept and held against the plain attention on their own
    inputs under the kernel phases' bf16 bounds."""
    pipe = importlib.import_module("ray_tpu_torch.parallel.pipeline")
    pmesh = importlib.import_module("ray_tpu_torch.parallel.mesh")
    cfg = flagship_config()
    stages = pmesh.axis_size(mesh, "pp")
    m = PIPE_MICROBATCHES
    expected = cfg.n_layers * (m + stages - 1)
    params = tfm.init_params(cfg, seed=SEED, device=DEVICE)

    def pipelined():
        return pipe.forward_pipelined(params, tokens, cfg, mesh, m,
                                      attn_fn=fa.flash_attention)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = pipelined()
        torch.cuda.synchronize()
        first_fwd_s = time.perf_counter() - t0
        fwd_launches = launch_counts()
        fwd_peak = torch.cuda.max_memory_allocated()
        check(fwd_launches == (expected, 0, 0),
              f"forward_pipelined: (fwd, dQ, dK/dV) launches {fwd_launches},"
              f" expected ({expected}, 0, 0)")
        fwd_s, _ = mean_s(pipelined, PIPE_TIMED)
        want = tfm.forward(params, tokens, cfg)
        none_fwd_s, _ = mean_s(lambda: tfm.forward(params, tokens, cfg),
                               PIPE_TIMED)
        check(tuple(logits.shape) == (BATCH, SEQ, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"pipelined logits {tuple(logits.shape)} or non-finite")
        err = (logits - want).abs().max().item()
        del want
        plain_bf16 = tfm.forward(params, tokens,
                                 dataclasses.replace(cfg, use_flash=False))
        gap = (plain_bf16 - tfm.forward(params, tokens, dataclasses.replace(
            cfg, use_flash=False, dtype=torch.float32))).abs().max().item()
        del plain_bf16, logits
    print(f"pipeline forward (S={stages}, M={m}): |pipelined - forward| "
          f"{err:.4g}, |plain bf16 - plain fp32| {gap:.4g}; launches "
          f"{fwd_launches}")
    check(gap > 0 and err <= LOGITS_GAP_FACTOR * gap,
          f"pipelined logits off forward's by {err}, over "
          f"{LOGITS_GAP_FACTOR} x the bf16/fp32 gap {gap}")

    leaves = trn.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def gradient(fwd):
        loss = next_token_loss(fwd(), tokens)
        return loss.item(), torch.autograd.grad(loss, leaves)

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with KernelRecorder(FLASH_PLAIN) as recorder:
        loss_pp, g_pp = gradient(pipelined)
        torch.cuda.synchronize()
    first_grad_s = time.perf_counter() - t0
    grad_launches = launch_counts()
    grad_peak = torch.cuda.max_memory_allocated()
    check(grad_launches == (expected,) * 3,
          f"pipelined gradient: (fwd, dQ, dK/dV) launches {grad_launches}, "
          f"expected {expected} each")
    grad_s, _ = mean_s(lambda: gradient(pipelined), PIPE_TIMED)
    profile = profile_device(lambda: gradient(pipelined),
                             "one pipelined gradient")
    loss_none, g_none = gradient(lambda: tfm.forward(params, tokens, cfg))
    none_grad_s, _ = mean_s(
        lambda: gradient(lambda: tfm.forward(params, tokens, cfg)), PIPE_TIMED)
    grad_err = grad_dist(g_pp, g_none) / grad_norm(g_none)
    leaf_errs = leaf_rel_errs(g_pp, g_none, leaf_names(params))
    worst_name, worst = worst_leaf(leaf_errs)
    loss_err = abs(loss_pp - loss_none) / abs(loss_none)
    grad_bound = GRAD_GAP_FACTOR * PIPE_GRAD_READING
    leaf_bound = GRAD_GAP_FACTOR * PIPE_LEAF_READING
    del g_pp, g_none
    print(f"pipeline gradient: loss {loss_pp:.6f} vs mesh=None "
          f"{loss_none:.6f} (rel {loss_err:.4g}, bound "
          f"{MESH_FIRST_LOSS_REL:.4g}); |g_pp - g_none| / |g_none| "
          f"{grad_err:.4g} (bound {grad_bound:.4g}); worst leaf {worst_name}"
          f" {worst:.4g} (bound {leaf_bound:.4g}), embed "
          f"{leaf_errs['embed']:.4g}, unembed {leaf_errs['unembed']:.4g}, "
          f"final_norm {leaf_errs['final_norm']:.4g}; launches "
          f"{grad_launches}")
    check(all(math.isfinite(x) for x in (loss_pp, grad_err, worst)),
          "non-finite pipelined loss or gradient")
    kernel_calls = check_flash_calls(recorder, "pipeline main path")
    del recorder
    check(grad_err <= grad_bound, f"pipelined gradient off by {grad_err:.4g}"
          f", over {grad_bound:.4g}")
    check(worst <= leaf_bound, f"pipelined gradient of {worst_name} off by "
          f"{worst:.4g}, over {leaf_bound:.4g}")
    check(loss_err <= MESH_FIRST_LOSS_REL, f"pipelined loss off by "
          f"{loss_err:.4g} relative, over {MESH_FIRST_LOSS_REL}")
    print(f"pipeline timing (world size 1, S={stages}, M={m}, "
          f"{BATCH} x {SEQ}): forward {fwd_s:.5f} s (forward without the "
          f"pipeline {none_fwd_s:.5f} s), forward + backward {grad_s:.5f} s "
          f"(without {none_grad_s:.5f} s); peak {fwd_peak} bytes forward, "
          f"{grad_peak} bytes with the gradient")
    for p in leaves:
        p.requires_grad_(False)
    del params, leaves
    return {"mesh": "MeshSpec.auto(1) over NCCL", "stages": stages,
            "microbatches": m, "steps": m + stages - 1,
            "launches": {"forward": dict(zip(
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                fwd_launches)), "gradient": dict(zip(
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                grad_launches))},
            "logits_err": err, "logits_gap_bf16_fp32": gap,
            "loss": loss_pp, "loss_mesh_none": loss_none,
            "loss_rel_err": loss_err, "loss_bound": MESH_FIRST_LOSS_REL,
            "grad_rel_err": grad_err, "grad_bound": grad_bound,
            "grad_leaf_rel_err": leaf_errs, "grad_worst_leaf": worst_name,
            "grad_leaf_bound": leaf_bound,
            "kernel_calls_vs_plain": kernel_calls,
            "forward_s": fwd_s, "first_forward_s": first_fwd_s,
            "forward_mesh_none_s": none_fwd_s,
            "forward_backward_s": grad_s, "first_gradient_s": first_grad_s,
            "forward_backward_mesh_none_s": none_grad_s,
            "peak_mem_bytes_forward": fwd_peak,
            "peak_mem_bytes_gradient": grad_peak, "profile": profile}


def mesh_vit(mesh, parity):
    """ViT-B/16 (``vit_b16_config``), bf16, seed-0 weights, VIT_IMAGES
    random images and labels from RandomState(0): ``vit_loss_fn``'s loss
    and gradients against the same in fp32 (the whole gradient within
    GRAD_GAP_FACTOR times phase 8's bf16-vs-fp32 gap, each leaf within
    GRAD_GAP_FACTOR times VIT_LEAF_READING, the loss by phase 8's rule on
    VIT_LOSS_READING), and ``vit_loss_fn_shard`` on the world-size-1 mesh
    against ``vit_loss_fn`` (the loss and each leaf within
    MESH_FIRST_LOSS_REL). No kernel launches: the reference's ViT attends
    densely."""
    shd = importlib.import_module("ray_tpu_torch.models.sharded")
    cfg = vit_b16_config()
    params = vit.init_vit_params(cfg, seed=SEED, device=DEVICE)
    leaves = trn.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.RandomState(0)
    batch = {"images": torch.from_numpy(rng.rand(
                 VIT_IMAGES, cfg.image_size, cfg.image_size,
                 cfg.channels).astype(np.float32)).to(DEVICE),
             "labels": torch.from_numpy(rng.randint(
                 0, cfg.num_classes, VIT_IMAGES)).to(DEVICE)}

    def step(c):
        loss = vit.vit_loss_fn(params, batch, c)
        return loss.item(), torch.autograd.grad(loss, leaves)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    loss_b, g_b = step(cfg)
    torch.cuda.synchronize()
    launched = launch_counts()
    check(launched == (0, 0, 0), f"ViT launched attention kernels "
          f"{launched}; the reference's ViT attends densely")
    step_s, step_times = mean_s(lambda: step(cfg), VIT_TIMED)
    peak = torch.cuda.max_memory_allocated()
    profile = profile_device(lambda: step(cfg), "one ViT-B/16 step")
    with torch.no_grad():
        logits = vit.vit_forward(params, batch["images"], cfg)
    check(tuple(logits.shape) == (VIT_IMAGES, cfg.num_classes)
          and bool(torch.isfinite(logits).all()),
          f"ViT logits {tuple(logits.shape)} or non-finite")
    loss_f, g_f = step(dataclasses.replace(cfg, dtype=torch.float32))
    names = leaf_names(params)
    ref = grad_norm(g_f)
    gap = grad_dist(g_b, g_f) / ref
    leaf_gaps = leaf_rel_errs(g_b, g_f, names)
    worst_name, worst = worst_leaf(leaf_gaps)
    del g_f
    grad_bound = GRAD_GAP_FACTOR * parity["grad_rel_gap_bf16_fp32"]
    leaf_bound = GRAD_GAP_FACTOR * VIT_LEAF_READING
    loss_bound = max(GRAD_GAP_FACTOR * VIT_LOSS_READING, LOSS_GAP_FLOOR)
    loss_gap = abs(loss_b - loss_f)

    specs = vit.vit_param_specs(cfg)
    loss_s, g_s, _ = trn.sharded_value_and_grad(
        shd.vit_loss_fn_shard, params, specs, mesh, batch, cfg)
    loss_s = loss_s.item()
    shard_loss_err = abs(loss_s - loss_b) / abs(loss_b)
    shard_grad_err = grad_dist(g_s, g_b) / ref
    shard_leaf_errs = leaf_rel_errs(g_s, g_b, names)
    shard_worst_name, shard_worst = worst_leaf(shard_leaf_errs)
    del g_s, g_b
    shard_s, _ = mean_s(lambda: trn.sharded_value_and_grad(
        shd.vit_loss_fn_shard, params, specs, mesh, batch, cfg), VIT_TIMED)
    print(f"ViT-B/16 ({VIT_IMAGES} images, bf16): loss {loss_b:.6f}, fp32 "
          f"{loss_f:.6f} (|d| {loss_gap:.4g}, bound {loss_bound:.4g}); "
          f"|g_bf16 - g_fp32| / |g_fp32| {gap:.4g} (bound {grad_bound:.4g});"
          f" worst leaf {worst_name} {worst:.4g} (bound {leaf_bound:.4g}), "
          + ", ".join(f"{key} {leaf_gaps[key]:.4g}" for key in (
              "patch_embed", "patch_bias", "final_norm", "head"))
          + f"; sharded at world size 1: loss {loss_s:.6f} (rel "
          f"{shard_loss_err:.3g}), |g_shard - g| / |g_fp32| "
          f"{shard_grad_err:.4g}, worst leaf {shard_worst_name} "
          f"{shard_worst:.4g} (bound {MESH_FIRST_LOSS_REL}); no kernel "
          f"launch (dense attention, as in the reference)")
    print(f"ViT-B/16 timing: forward + backward {step_s:.5f} s "
          f"({VIT_IMAGES / step_s:.1f} images/s; steps {step_times}), "
          f"sharded at world size 1 {shard_s:.5f} s; peak {peak} bytes")
    check(all(math.isfinite(x) for x in (loss_b, loss_f, gap, worst, loss_s,
                                          shard_grad_err, shard_worst)),
          "non-finite ViT loss or gradient")
    check(gap <= grad_bound, f"ViT bf16 gradients off fp32 by {gap:.4g}, "
          f"over {grad_bound:.4g}")
    check(worst <= leaf_bound, f"ViT bf16 gradient of {worst_name} off "
          f"fp32 by {worst:.4g}, over {leaf_bound:.4g}")
    check(loss_gap <= loss_bound, f"ViT bf16 loss off fp32 by "
          f"{loss_gap:.4g}, over {loss_bound:.4g}")
    check(shard_loss_err <= MESH_FIRST_LOSS_REL,
          f"vit_loss_fn_shard off vit_loss_fn by {shard_loss_err:.3g} "
          f"relative")
    check(shard_worst <= MESH_FIRST_LOSS_REL,
          f"vit_loss_fn_shard's gradient of {shard_worst_name} off by "
          f"{shard_worst:.4g}, over {MESH_FIRST_LOSS_REL}")
    for p in leaves:
        p.requires_grad_(False)
    return {"config": "ViT-B/16: 224x224, patch 16, d768 L12 H12 ff3072, "
                      "1000 classes, SwiGLU, RoPE, bf16, remat off",
            "images": VIT_IMAGES, "loss": loss_b, "loss_fp32": loss_f,
            "loss_gap": loss_gap, "loss_bound": loss_bound,
            "grad_rel_gap_bf16_fp32": gap, "grad_bound": grad_bound,
            "grad_leaf_gap": leaf_gaps, "grad_worst_leaf": worst_name,
            "grad_leaf_bound": leaf_bound,
            "shard_loss": loss_s, "shard_loss_rel_err": shard_loss_err,
            "shard_grad_rel_err": shard_grad_err,
            "shard_grad_leaf_rel_err": shard_leaf_errs,
            "shard_bound": MESH_FIRST_LOSS_REL,
            "step_s": step_s, "step_times_s": step_times,
            "images_per_s": VIT_IMAGES / step_s, "shard_step_s": shard_s,
            "peak_mem_bytes": peak, "kernel_launches": list(launched),
            "profile": profile,
            "attention": "dense, as ray_tpu/models/vit.py:110"}


def sdpa_bwd_trace_ms(qt, kt, vt, dot, iters=10):
    """SDPA's backward alone: the device time of the kernels that
    ``torch.autograd.grad`` launches through SDPA's causal backward,
    summed from a torch.profiler trace that holds only the backward
    calls, per call. Fails when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    outs = [sdpa(qt, kt, vt, is_causal=True) for _ in range(iters + 1)]
    torch.autograd.grad(outs[0], (qt, kt, vt), dot)     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for out in outs[1:]:
            torch.autograd.grad(out, (qt, kt, vt), dot)
        torch.cuda.synchronize()
    device_ms = sum(e.device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    del outs
    check(device_ms > 0, "the profiler saw no device time in SDPA's "
          "backward")
    return device_ms / iters


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
    library_ms = sdpa_bwd_trace_ms(qt, kt, vt, dot)
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
          f"backward {library_ms:.4f} ms")
    for kern, label in (("dq", "dQ"), ("dkv", "dK/dV")):
        print(f"flash bwd {label}: {tflops[kern]:.1f} TFLOP/s, "
              f"{bounds[kern][0] / times[kern]:.3f} of its bound")
    print(f"flash bwd dQ + dK/dV + D {pair_ms:.4f} ms against sdpa backward "
          f"{library_ms:.4f} ms (its kernels alone, from the trace): "
          f"{pair_ms / library_ms:.3f}x")
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
            "library_ms": library_ms,
            "library_is": ("SDPA causal backward, its kernels alone from a "
                           "torch.profiler trace")}


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


def scheduler_launch_counts():
    return tp.launches, pk.launches_pack, pk.launches_pack_batch


def reset_scheduler_launch_counts():
    tp.launches = pk.launches_pack = pk.launches_pack_batch = 0


SCHEDULER_KERNELS = ("schedule_classes", "pg_pack", "pg_pack_batch")


def scheduler_launches_by_name():
    return dict(zip(SCHEDULER_KERNELS, scheduler_launch_counts()))


def launch_floor_ms(iters=200):
    """The least a launch costs here: the host round trip of one empty
    kernel launch and a synchronize (median), the device time of one empty
    launch among back-to-back ones (CUDA events), and the host's time to
    issue one of those launches (its clock over the same loop). Where the
    last two are close, the back-to-back floor is the host's issue rate,
    not the card's."""
    lib = pk._kernel_lib()
    lib.scheduler_empty.argtypes = [ctypes.c_void_p]
    lib.scheduler_empty.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        check(lib.scheduler_empty(stream) == 0, "empty launch failed")

    trips = []
    for _ in range(iters):
        t0 = time.perf_counter()
        empty()
        torch.cuda.synchronize()
        trips.append((time.perf_counter() - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        empty()
    issue_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return (float(np.median(trips)), start.elapsed_time(end) / iters,
            issue_ms)


SCHED_PLAIN = {"schedule_classes_cuda": (tp, "schedule_classes_plain"),
               "pack_cuda": (pk, "pack_plain"),
               "pack_batch_cuda": (pk, "pack_batch_plain")}


class KernelRecorder:
    """While active, keeps a copy of the inputs and the outputs of the
    first call of each kernel wrapper of ``targets`` ({wrapper name:
    (module, plain version's name)}) at each shape (the main path repeats
    its calls at one shape), so that the kernels can be held against their
    plain versions on the main path's own inputs. The wrappers themselves
    run and count as always."""

    def __init__(self, targets=SCHED_PLAIN):
        self.targets = targets
        self.calls = []
        self._seen = set()
        self._saved = {}

    def __enter__(self):
        for name, (mod, _) in self.targets.items():
            self._saved[name] = getattr(mod, name)
            setattr(mod, name, self._wrap(name, self._saved[name]))
        return self

    def __exit__(self, *exc):
        for name, (mod, _) in self.targets.items():
            setattr(mod, name, self._saved[name])

    def _wrap(self, name, fn):
        def recorded(*args):
            key = (name, tuple(tuple(a.shape) if torch.is_tensor(a) else a
                               for a in args))
            if key in self._seen:
                return fn(*args)
            self._seen.add(key)
            inputs = [a.clone() if torch.is_tensor(a) else a for a in args]
            out = fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            self.calls.append((name, inputs, [o.clone() for o in outs]))
            return out
        return recorded

    def check_against_plain(self):
        """Each recorded call's outputs equal its plain version's on the
        same inputs, element for element; returns what was compared."""
        compared = []
        for name, inputs, outs in self.calls:
            mod, plain_name = SCHED_PLAIN[name]
            want = getattr(mod, plain_name)(
                *(a.clone() if torch.is_tensor(a) else a for a in inputs))
            want = want if isinstance(want, tuple) else (want,)
            equal = all(torch.equal(o, w_) for o, w_ in zip(outs, want))
            shapes = [tuple(a.shape) for a in inputs[:1] + inputs[3:4]]
            print(f"main path {name} on its own inputs (avail, demands "
                  f"{shapes}): kernel == plain {equal}")
            check(equal, f"main-path {name} at {shapes} differs from its "
                  f"plain version")
            compared.append({"kernel": name, "shapes": shapes,
                             "equal": equal})
        return compared


def sched_cluster(w, n_nodes=None):
    """A ClusterResourceManager of the benchmark's nodes (the first
    ``n_nodes``), resources named as bench.py names them."""
    names = ("CPU", "TPU", "memory", "custom")
    cluster = sres.ClusterResourceManager()
    for i in range(len(w.total) if n_nodes is None else n_nodes):
        cluster.add_or_update_node(sids.NodeID.from_random(), sres.NodeResources(
            total={r: float(w.total[i, j]) for j, r in enumerate(names)
                   if w.total[i, j] > 0},
            available={r: float(w.avail[i, j]) for j, r in enumerate(names)
                       if w.total[i, j] > 0}))
    return cluster, names


def sched_requests(w, cluster):
    """``schedule_batch``'s requests: SCHED_POLICY_REQUESTS of the
    benchmark's classes drawn from SEED, every fourth preferring one of the
    cluster's first 16 nodes."""
    rng = np.random.RandomState(SEED)
    ids = [nid for nid, _ in cluster.nodes()]
    return [spol.SchedulingRequest(
        demand={"CPU": float(w.demands[c, 0]),
                "memory": float(w.demands[c, 2]),
                **({"TPU": float(w.demands[c, 1])} if w.demands[c, 1] else {})},
        preferred_node=ids[rng.randint(0, 16)] if i % 4 == 0 else None)
        for i, c in enumerate(rng.randint(0, len(w.counts),
                                          SCHED_POLICY_REQUESTS))]


def check_bundles_fit(cluster, assign, bundles, what):
    """No node takes more of a resource than it has available."""
    use = {}
    for nid, b in zip(assign, bundles):
        for r, v in b.items():
            use[(nid, r)] = use.get((nid, r), 0.0) + v
    over = [(nid, r) for (nid, r), v in use.items()
            if v > cluster.get_node(nid).available.get(r, 0.0) + 1e-6]
    check(not over, f"{what}: {len(over)} node resources oversubscribed")



def sched_launch_shape(program, n, r, b=0):
    """The launch shape ``scheduler.cu`` picks: program 0 schedule_classes
    at n x r, 1 pg_pack at n x r with b bundles."""
    lib = tp._kernel_lib()
    lib.scheduler_launch_shape.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.scheduler_launch_shape.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    check(lib.scheduler_launch_shape(program, n, r, b, out) == 0,
          "scheduler_launch_shape refused its arguments")
    keys = ("ctas", "threads", "smem_bytes", "slices_in_smem",
            "clusters_held")
    return dict(zip(keys, (int(x) for x in out)))


def s3_launch_shape(n, r, b, k, lib=None):
    """The launch shape ``scheduler.cu`` picks for pg_pack_batch at n x r,
    b bundles, k candidates a group."""
    lib = lib or pk._kernel_lib()
    lib.pg_pack_batch_shape.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pg_pack_batch_shape.restype = ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    check(lib.pg_pack_batch_shape(n, r, b, k, out) == 0,
          "pg_pack_batch_shape refused its arguments")
    keys = ("ctas", "threads", "smem_bytes", "slices_in_smem",
            "clusters_held", "keys_in_smem", "groups_in_smem")
    return dict(zip(keys, (int(x) for x in out)))


def sched_edge_sweep():
    """Every edge shape of ``workload.class_edge_cases``,
    ``pack_edge_cases`` and ``batch_edge_cases`` through the kernels on
    the card (``pg_pack_batch``'s ranking alone too), held exactly
    against the plain versions on the same inputs."""
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    compared = []
    for case in swl.class_edge_cases():
        args = [torch.as_tensor(a).to(dev) for a in (
            case.avail, case.total, case.alive, case.demands, case.counts,
            case.prefs)]
        want, want_avail = tp.schedule_classes_plain(
            *(a.clone() for a in args), 0.5)
        got, got_avail = tp.schedule_classes_cuda(*(a.clone() for a in args),
                                                  0.5)
        torch.cuda.synchronize()
        same = torch.equal(got, want) and torch.equal(got_avail, want_avail)
        compared.append({"kernel": "schedule_classes", "case": case.name,
                         "shape": [list(case.avail.shape),
                                   int(case.demands.shape[0])],
                         "equal": same})
    for case in swl.pack_edge_cases():
        args = [torch.as_tensor(a).to(dev) for a in (
            case.avail, case.total, case.alive, case.demands)]
        want = pk.pack_plain(*args, case.mode)
        got = pk.pack_cuda(*args, case.mode)
        torch.cuda.synchronize()
        compared.append({"kernel": "pg_pack", "case": case.name,
                         "shape": [list(case.avail.shape),
                                   int(case.demands.shape[0])],
                         "equal": torch.equal(got, want)})
    for case in swl.batch_edge_cases():
        args = [torch.as_tensor(a).to(dev) for a in (
            case.avail, case.total, case.alive, case.demands, case.valid)]
        want = pk.pack_batch_plain(*args, case.mode, case.k)
        got = pk.pack_batch_cuda(*args, case.mode, case.k)
        ranked = pk.rank_nodes_cuda(*args[:3], case.mode)
        torch.cuda.synchronize()
        compared.append({"kernel": "pg_pack_batch", "case": case.name,
                         "shape": [list(case.avail.shape),
                                   list(case.demands.shape[:2]), case.k],
                         "equal": torch.equal(got, want) and torch.equal(
                             ranked, pk.rank_nodes_plain(*args[:3],
                                                         case.mode))})
    for c in compared:
        print(f"edge {c['kernel']} {c['case']} {c['shape']}: kernel == plain "
              f"{c['equal']}")
    check(all(c["equal"] for c in compared),
          f"edge shapes differ: {[c['case'] for c in compared if not c['equal']]}")
    seconds = time.perf_counter() - t0
    print(f"edge sweep: {len(compared)} cases, all kernel == plain, "
          f"{seconds:.2f} s with the plain versions")
    return {"cases": compared, "s": seconds}


def s3_rank_runner(avail, total, alive, mode):
    """One launch of ``pg_pack_batch``'s ranking alone (``pg_pack_rank``)
    into scratch allocated once, for timing."""
    n, r = avail.shape
    ranked, _ = pk._batch_scratch(n, r, 0, 0, 1, avail.device)
    lib = pk._kernel_lib()

    def run():
        check(lib.pg_pack_rank(
            avail.data_ptr(), total.data_ptr(), alive.data_ptr(), n, r,
            pk.MODES[mode], ranked.data_ptr(),
            torch.cuda.current_stream().cuda_stream) == 0,
            "pg_pack_rank launch failed")
    return run


def s3_batch_runner(avail, total, alive, demands, valid, mode, k):
    """One ``pg_pack_batch`` entry into scratch and output allocated once,
    for timing the kernels without the wrapper's allocations."""
    n, r = avail.shape
    g, b = demands.shape[0], demands.shape[1]
    ranked, slots = pk._batch_scratch(n, r, g, b, k, avail.device)
    out = torch.empty((g, b + 1), dtype=torch.int32, device=avail.device)
    lib = pk._kernel_lib()

    def run():
        check(lib.pg_pack_batch(
            avail.data_ptr(), total.data_ptr(), alive.data_ptr(),
            demands.data_ptr(), valid.data_ptr(), n, r, g, b, k,
            pk.MODES[mode], ranked.data_ptr(), slots.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0,
            "pg_pack_batch launch failed")
    return run


def s3_rank_keys(avail, total, alive, mode):
    """The ranking's keys as the plain version sorts them: base score,
    INF for a dead row."""
    util = pk._util(avail, total)
    return torch.where(alive, -util if mode == "pack" else util,
                       torch.tensor(float("inf"), device=avail.device))


def s3_sort_runner(avail, total, alive, mode):
    """``torch.sort(stable=True)`` of the ranking's keys into outputs
    allocated once: the call ``torch.argsort(stable=True)`` makes, without
    its allocations, for timing beside the ranking's runner."""
    keys = s3_rank_keys(avail, total, alive, mode)
    values, order = torch.empty_like(keys), torch.empty(
        keys.shape, dtype=torch.long, device=keys.device)

    def run():
        torch.sort(keys, stable=True, out=(values, order))
    return run


def least_ms(fn, iters: int, passes: int = 3) -> float:
    """The least of ``passes`` readings of ``time_ms(fn, iters)``."""
    return min(time_ms(fn, iters) for _ in range(passes))


def s3_at(label, avail, total, alive, demands, valid, mode, k):
    """S3 on one input, on the card: the entry (``pack_batch_cuda``) and
    its ranking alone, each held exactly against the plain version, then
    their kernels timed with CUDA events (scratch allocated once) beside
    ``torch.sort(stable=True)`` of the same keys into outputs allocated
    once (the ranking only; the port never calls it), each the least of
    three passes."""
    got = pk.pack_batch_cuda(avail, total, alive, demands, valid, mode, k)
    ranked = pk.rank_nodes_cuda(avail, total, alive, mode)
    torch.cuda.synchronize()
    equal = (torch.equal(got, pk.pack_batch_plain(avail, total, alive,
                                                  demands, valid, mode, k))
             and torch.equal(ranked, pk.rank_nodes_plain(avail, total, alive,
                                                         mode)))
    check(equal, f"pg_pack_batch at {label} differs from its plain version")
    out = {"nodes": int(avail.shape[0]), "groups": int(demands.shape[0]),
           "bundles": int(demands.shape[1]), "k": k, "mode": mode,
           "equal": equal,
           "ms": least_ms(s3_batch_runner(avail, total, alive, demands,
                                          valid, mode, k), 20),
           "rank_ms": least_ms(s3_rank_runner(avail, total, alive, mode),
                               20),
           "argsort_ms": least_ms(s3_sort_runner(avail, total, alive, mode),
                                  20)}
    print(f"pg_pack_batch at {label} ({out['nodes']} nodes, "
          f"{out['groups']} x {out['bundles']} bundles, k {k}, {mode}): "
          f"kernel == plain {equal}; {out['ms'] * 1e3:.1f} us, its ranking "
          f"alone {out['rank_ms'] * 1e3:.1f} us, torch.sort(stable=True) "
          f"of the same keys {out['argsort_ms'] * 1e3:.1f} us (least of "
          f"three passes)")
    return out


def phase_scheduler():
    """The scheduler's device programs at the benchmark's shape: each
    kernel exactly against its plain version, timed; then the main path
    through the policy and the solver with the launch counts from 0."""
    w = swl.workload(np.random.RandomState(42))
    n, r = w.avail.shape
    k = len(w.counts)
    dev = torch.device(DEVICE)
    avail, total, alive, demands = (torch.as_tensor(a).to(dev) for a in (
        w.avail, w.total, w.alive, w.demands))
    counts = torch.as_tensor(w.counts).to(dev)
    prefs = torch.full((k,), -1, dtype=torch.int32, device=dev)
    thr = spol.get_config().scheduler_spread_threshold

    # S1 against its plain version, on the same inputs.
    want, want_avail = tp.schedule_classes_plain(avail.clone(), total, alive,
                                                 demands, counts, prefs, thr)
    got, got_avail = tp.schedule_classes_cuda(avail.clone(), total, alive,
                                              demands, counts, prefs, thr)
    torch.cuda.synchronize()
    s1_equal = torch.equal(got, want) and torch.equal(got_avail, want_avail)
    g = got.cpu().numpy()
    placed = g[:, 0] + g[:, 5 + n:5 + 2 * n].sum(1) + g[:, 5 + 3 * n:].sum(1)
    print(f"schedule_classes at {n} nodes x {r}, {k} classes, "
          f"{int(w.counts.sum())} tasks: kernel == plain {s1_equal}; placed "
          f"{int(placed.sum())}, admitted {int(g[:, 3].sum())}, fenced "
          f"{int(g[:, 2].sum())}; least new avail "
          f"{got_avail.min().item():.6g}")
    check(s1_equal, "schedule_classes kernel differs from its plain version")
    check(bool((got_avail >= -1e-6).all()), "a node is oversubscribed")
    check(np.array_equal(placed, g[:, 3]), "placed != admitted")

    # S2 and S3 against theirs.
    pg_demands = torch.as_tensor(w.pg_demands).to(dev)
    batch_demands = torch.as_tensor(w.batch_demands).to(dev)
    valid = torch.ones(batch_demands.shape[:2], dtype=torch.bool, device=dev)
    s2 = {mode: (pk.pack_cuda(avail, total, alive, pg_demands, mode),
                 pk.pack_plain(avail, total, alive, pg_demands, mode))
          for mode in pk.MODES}
    s3 = {mode: (pk.pack_batch_cuda(avail, total, alive, batch_demands, valid,
                                    mode, swl.PG_TOPK),
                 pk.pack_batch_plain(avail, total, alive, batch_demands, valid,
                                     mode, swl.PG_TOPK))
          for mode in pk.MODES}
    torch.cuda.synchronize()
    for name, runs in (("pg_pack", s2), ("pg_pack_batch", s3)):
        for mode, (kern, plain) in runs.items():
            print(f"{name} {mode}: kernel == plain {torch.equal(kern, plain)}"
                  f", all placed {bool(kern[..., -1].all())}")
            check(torch.equal(kern, plain),
                  f"{name} {mode} kernel differs from its plain version")
            check(bool(kern[..., -1].all()), f"{name} {mode} left a bundle")

    # The redesigned kernels' launch shapes (-Xptxas -v's registers and
    # shared memory are in phase 1's report), then every edge shape.
    shapes = {"schedule_classes": sched_launch_shape(0, n, r),
              "pg_pack": sched_launch_shape(1, tp._bucket(n), r,
                                            pg_demands.shape[0]),
              "pg_pack_batch": s3_launch_shape(
                  tp._bucket(n), r, batch_demands.shape[1], swl.PG_TOPK)}
    for key, shape in shapes.items():
        print(f"{key} launch shape: {shape}")
    edges = sched_edge_sweep()

    # S3 at the benchmark's shape and at 40,000 nodes (past 16,384 rows,
    # where a one-CTA sort would leave shared memory), with its ranking
    # alone.
    w40 = swl.workload(np.random.RandomState(42), 40_000, 1000)
    big = [torch.as_tensor(a).to(dev) for a in (w40.avail, w40.total,
                                                w40.alive)]
    big_demands = torch.as_tensor(w40.batch_demands).to(dev)
    for mode in pk.MODES:
        s3_big = pk.pack_batch_cuda(*big, big_demands, valid, mode,
                                    swl.PG_TOPK)
        check(torch.equal(s3_big, pk.pack_batch_plain(
            *big, big_demands, valid, mode, swl.PG_TOPK)),
            f"pg_pack_batch {mode} at 40,000 nodes differs from its plain "
            f"version")
    s3_shapes = {
        "bench": s3_at("the benchmark's shape", avail, total, alive,
                       batch_demands, valid, "spread", swl.PG_TOPK),
        "n40000": s3_at("40,000 nodes", *big, big_demands, valid, "spread",
                        swl.PG_TOPK)}

    # Times on the card: kernel (CUDA events, avail refreshed before each
    # schedule_classes launch, which updates it in place), plain version.
    work = avail.clone()

    def s1_kernel():
        work.copy_(avail)
        tp.schedule_classes_cuda(work, total, alive, demands, counts, prefs,
                                 thr)

    times = {
        "schedule_classes": (time_ms(s1_kernel, 10), time_ms(
            lambda: tp.schedule_classes_plain(avail.clone(), total, alive,
                                              demands, counts, prefs, thr),
            2, warmup=1)),
        "pg_pack": (time_ms(lambda: pk.pack_cuda(
            avail, total, alive, pg_demands, "spread"), 10), time_ms(
            lambda: pk.pack_plain(avail, total, alive, pg_demands, "spread"),
            2, warmup=1)),
        "pg_pack_batch": (s3_shapes["bench"]["ms"], time_ms(
            lambda: pk.pack_batch_plain(
                avail, total, alive, batch_demands, valid, "spread",
                swl.PG_TOPK), 2, warmup=1))}
    trip_ms, empty_ms, issue_ms = launch_floor_ms()
    f32 = 4
    base_bytes = 2 * n * r * f32 + n                # avail, total, alive
    nbytes = {
        "schedule_classes": base_bytes + k * r * f32 + 2 * k * 4
        + k * (4 * n + 5) * 4 + n * r * f32,        # + packed, new avail
        "pg_pack": base_bytes + pg_demands.numel() * f32
        + (pg_demands.shape[0] + 1) * 4,
        "pg_pack_batch": base_bytes + batch_demands.numel() * f32
        + valid.numel() + valid.shape[0] * (valid.shape[1] + 1) * 4}
    # The bound: the bytes, plus the device floor of each launch the entry
    # makes, measured as the kernel times are (back to back, CUDA events).
    launches_per_entry = {"schedule_classes": 1, "pg_pack": 1,
                          "pg_pack_batch": pk.BATCH_LAUNCHES}
    rows = {}
    for name, (kern_ms, plain_ms) in times.items():
        bytes_ms = nbytes[name] / PEAK_BYTES_PER_S * 1e3
        bound_ms = bytes_ms + launches_per_entry[name] * empty_ms
        rows[name] = {"ms": kern_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bytes_bound_ms": bytes_ms,
                      "launch_floor_ms": launches_per_entry[name] * empty_ms}
        print(f"{name}: kernel {kern_ms * 1e3:.1f} us, plain on the card "
              f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us (bytes "
              f"{bytes_ms * 1e3:.3f} us + {launches_per_entry[name]} x empty "
              f"launch {empty_ms * 1e3:.2f} us back to back), kernel / bound "
              f"{kern_ms / bound_ms:.1f}x")
    print(f"launch floor: {empty_ms * 1e3:.2f} us an empty launch back to "
          f"back (device, CUDA events; in the bounds), {issue_ms * 1e3:.2f} "
          f"us the host's time to issue each of them, {trip_ms * 1e3:.2f} us "
          f"its host round trip with a synchronize (median; not in the "
          f"bounds)")

    # The main path, counts from 0: the dense policy path with the host
    # expansion, schedule_batch through the production composite, the
    # placement-group solver.
    pol = tp.TpuSchedulingPolicy()
    composite = spol.default_policy()
    adaptive = composite._inner
    tp._device_rt_threads[adaptive.device].join(timeout=60)
    cluster_small, names = sched_cluster(w, SCHED_POLICY_NODES)
    requests = sched_requests(w, cluster_small)
    cluster_big, _ = sched_cluster(w)
    solver = pk.PgKernelSolver()
    pg_bundles = [{nm: float(v) for nm, v in zip(names, row) if v > 0}
                  for row in w.pg_demands]
    groups = [[{nm: float(v) for nm, v in zip(names, row) if v > 0}
               for row in grp] for grp in w.batch_demands]
    solver.solve(cluster_big, pg_bundles[:1], "SPREAD")   # builds the view
    torch.cuda.synchronize()

    with KernelRecorder() as recorder:
        reset_scheduler_launch_counts()
        expand_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            ds = pol.schedule_dense(w.avail, w.total, w.alive, w.demands,
                                    w.counts, np.full(k, -1, np.int32))
            assigned = [np.repeat(o[t > 0], t[t > 0]) for kk in range(k)
                        for o, t in ((ds.order[kk], ds.take_sorted[kk]),
                                     (ds.order2[kk], ds.take2[kk]))]
            n_assigned = sum(len(a) for a in assigned)
            expand_s.append(time.perf_counter() - t0)
        s1_before = tp.launches
        t0 = time.perf_counter()
        results = composite.schedule_batch(cluster_small, requests)
        batch_s = time.perf_counter() - t0
        batch_launches = tp.launches - s1_before
        solve_s, many_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            assign = solver.solve(cluster_big, pg_bundles, "SPREAD")
            solve_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            many = solver.solve_many(cluster_big, groups, "SPREAD")
            many_s.append(time.perf_counter() - t0)
        counts_run = scheduler_launch_counts()
    print(f"scheduler main path launches (schedule_classes, pg_pack, "
          f"pg_pack_batch; {pk.BATCH_LAUNCHES} a pack_batch_cuda call): "
          f"{counts_run}")
    check(all(c > 0 for c in counts_run),
          f"a scheduler kernel was not launched on the main path: "
          f"{counts_run}")
    check(batch_launches == 1, f"schedule_batch made {batch_launches} "
          f"schedule_classes launches, not 1")

    # Each kernel against its plain version on the main path's own inputs
    # (the dense path's, schedule_batch's padded view, the solver's
    # 16,384-row view sorted by node id), then schedule_batch node for
    # node against the kernel policy on the CPU.
    compared = recorder.check_against_plain()
    check({c["kernel"] for c in compared} == set(SCHED_PLAIN),
          f"the recorder missed a kernel: {compared}")
    view = [c for c in recorder.calls if c[0] == "pack_batch_cuda"]
    check(len(view) == 1, "solve_many's kernel call not recorded")
    s3_shapes["view"] = s3_at("solve_many's 16,384-row view", *view[0][1])
    cpu_results = tp.TpuSchedulingPolicy(device="cpu").schedule_batch(
        cluster_small, requests)
    same_nodes = ([res.node_id for res in results]
                  == [res.node_id for res in cpu_results])
    print(f"schedule_batch on the card == on the CPU, node for node: "
          f"{same_nodes}")
    check(same_nodes, "schedule_batch on the card places otherwise than "
          "the kernel policy on the CPU")

    # Where schedule_batch's time goes: its one kernel, timed on the
    # inputs it was given (CUDA events), against the call on the host
    # clock.
    batch_call = [c for c in recorder.calls
                  if c[0] == "schedule_classes_cuda"
                  and c[1][0].shape[0] == tp._bucket(SCHED_POLICY_NODES)]
    check(len(batch_call) == 1, "schedule_batch's kernel call not recorded")
    b_avail, *b_rest = batch_call[0][1]
    b_work = b_avail.clone()

    def batch_kernel():
        b_work.copy_(b_avail)
        tp.schedule_classes_cuda(b_work, *b_rest)

    batch_kernel_ms = time_ms(batch_kernel, 10)
    shapes["schedule_classes_batch"] = sched_launch_shape(
        0, b_avail.shape[0], b_avail.shape[1])
    print(f"schedule_classes launch shape at schedule_batch's "
          f"{tuple(b_avail.shape)}: {shapes['schedule_classes_batch']}")
    batch_classes = len({(tuple(sorted(q.demand.items())), q.preferred_node)
                         for q in requests})
    print(f"schedule_batch: {batch_s * 1e3:.3f} ms on the host clock; its "
          f"schedule_classes kernel at avail {tuple(b_avail.shape)}, "
          f"{b_rest[2].shape[0]} padded classes ({batch_classes} before "
          f"padding): {batch_kernel_ms:.4f} ms on the card (CUDA events, "
          f"with the copy of avail); the rest, "
          f"{batch_s * 1e3 - batch_kernel_ms:.3f} ms, host and transfers")

    check(n_assigned == int(ds.admitted.sum()),
          f"expanded {n_assigned} tasks, admitted {int(ds.admitted.sum())}")
    check(bool((ds.new_avail >= -1e-6).all()), "dense path oversubscribed")
    placed_batch = sum(res.node_id is not None for res in results)
    per_node = {}
    for req, res in zip(requests, results):
        if res.node_id is not None:
            use = per_node.setdefault(res.node_id, {})
            for rr, v in req.demand.items():
                use[rr] = use.get(rr, 0.0) + v
    check(all(v <= cluster_small.get_node(nid).available.get(rr, 0.0) + 1e-6
              for nid, use in per_node.items() for rr, v in use.items()),
          "schedule_batch oversubscribed a node")
    check(assign is not None, "solve left the 512 bundles unplaced")
    check_bundles_fit(cluster_big, assign, pg_bundles, "solve")
    check(all(a is not None for a in many), "solve_many left a group")
    for a, grp in zip(many, groups):
        check_bundles_fit(cluster_big, a, grp, "solve_many")
    tasks_s = n_assigned / min(expand_s)
    out = {
        "nodes": n, "resources": r, "classes": k,
        "tasks": int(w.counts.sum()), "tasks_placed": n_assigned,
        "tasks_per_s_with_expansion": tasks_s,
        "dense_path_s": expand_s,
        "schedule_batch": {"nodes": SCHED_POLICY_NODES,
                           "requests": SCHED_POLICY_REQUESTS,
                           "placed": placed_batch, "s": batch_s,
                           "kernel_ms": batch_kernel_ms,
                           "classes": batch_classes,
                           "kernel_shape": [list(b_avail.shape),
                                            b_rest[2].shape[0]],
                           "same_nodes_as_cpu": same_nodes,
                           "policy": type(adaptive).__name__},
        "main_path_vs_plain": compared,
        "pg_solve": {"bundles": len(pg_bundles), "s": solve_s,
                     "bundles_per_s": len(pg_bundles) / min(solve_s)},
        "pg_solve_many": {"groups": len(groups),
                          "bundles": sum(len(gg) for gg in groups),
                          "s": many_s, "bundles_per_s": sum(
                              len(gg) for gg in groups) / min(many_s)},
        "kernel_entry_bundles_per_s": {
            "pg_pack": len(pg_bundles) / (times["pg_pack"][0] * 1e-3),
            "pg_pack_batch": valid.numel() / (times["pg_pack_batch"][0]
                                              * 1e-3)},
        "launch_round_trip_ms": trip_ms, "empty_launch_ms": empty_ms,
        "empty_launch_issue_ms": issue_ms,
        "launch_shapes": shapes, "edge_sweep": edges,
        "pg_pack_batch_shapes": s3_shapes,
        "launches": dict(zip(SCHEDULER_KERNELS, counts_run)),
        "kernels": rows}
    print(f"scheduler: {tasks_s:.1f} tasks/s with the host expansion "
          f"({n_assigned} placed, best of {len(expand_s)}: "
          f"{min(expand_s) * 1e3:.3f} ms); schedule_batch of "
          f"{SCHED_POLICY_REQUESTS} over {SCHED_POLICY_NODES} nodes "
          f"({type(adaptive).__name__}) {batch_s * 1e3:.3f} ms, "
          f"{placed_batch} placed; solve {len(pg_bundles)} bundles "
          f"{out['pg_solve']['bundles_per_s']:.1f} bundles/s; solve_many "
          f"{len(groups)} x {len(groups[0])} "
          f"{out['pg_solve_many']['bundles_per_s']:.1f} bundles/s; kernel "
          f"entries {out['kernel_entry_bundles_per_s']['pg_pack']:.1f} and "
          f"{out['kernel_entry_bundles_per_s']['pg_pack_batch']:.1f} "
          f"bundles/s")
    return out


class Replica:
    """Plays a Serve replica of the flagship model: builds the forward
    once, runs it at construction, and answers each batch of requests
    with the greedy next token and the head of the last-position logits
    (the JAX package's serving test returns that head)."""

    def __init__(self, cfg=None, params=None, batch=None, seq=None):
        if params is None:      # a phase-19 actor: the phase's flagship
            cfg, params = flagship_config(), DAG_CONTEXT["params"]
        self.cfg, self.params = cfg, params
        warm = torch.zeros((batch or BATCH, seq or SEQ), dtype=torch.long,
                           device=DEVICE)
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

    def answer(self, rows):
        """Phase 19's actor method: a batch of token rows from a CPU stage
        (int64 numpy) answered on the card."""
        return self(torch.from_numpy(np.require(rows, requirements="W"))
                    .to(DEVICE))


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
    # What the runtime and serve phases are held to: the answers to these
    # requests, the first batch's last-position logits and the sum of its
    # logits.
    direct = {"requests": requests, "answers": answers, "latency_s": latencies,
              "last_logits": first_logits[:, -1].float().cpu(),
              "logits_sum": first_logits.sum(dtype=torch.float64).item(),
              "logits_gap_bf16_fp32": gap}
    return serving, launches, direct


# -- the runtime ---------------------------------------------------------

RUNTIME_SPILL_BYTES = 64 << 20        # the CUDA tensor a CPU task consumes
RUNTIME_TRAIN_STEPS = 3
RUNTIME_COLL_ELEMS = 1 << 20          # fp32 elements per rank
RUNTIME_BURST = 4096                  # no-op tasks of num_cpus=0.001
RUNTIME_FREE_SLACK = 16 << 20         # bytes a killed actor may leave
RUNTIME_PINGS = 50                    # empty actor calls timed
RUNTIME_FREE_WAIT_S = 30.0
RUNTIME_NESTED_ELEMS = 1 << 22         # int64 elements a nested get reads


def _spill_probe(x):
    """A CPU task, run in a process worker: what its argument arrived as,
    whether that worker sees a card, and the argument's sum."""
    import torch as worker_torch     # loaded already, by the unpickling
    return {"type": type(x).__name__, "device": str(x.device),
            "cuda_available": worker_torch.cuda.is_available(),
            "sum": float(x.double().sum())}


def _noop():
    return None


def _nested_sum(refs):
    """A CPU task, run in a process worker: ``get`` of the driver's ref
    that it was handed inside a list (a nested call to the driver, which
    answers with the tensor's host copy), and a ``put`` of its sum, owned
    by this worker."""
    import ray_tpu_torch as nested_rt
    import torch as worker_torch
    x = nested_rt.get(refs[0], timeout=300)
    return {"type": type(x).__name__, "device": str(x.device),
            "cuda_available": worker_torch.cuda.is_available(),
            "sum": nested_rt.put(x.sum())}


class ReplicaActor:
    """The serving phase's Replica as a GPU-demand actor of the runtime:
    it builds the flagship from the seed on the card and answers each
    batch, passed as an object ref, with the answers, the last-position
    logits and the sum of the logits."""

    def __init__(self):
        self.cfg = flagship_config()
        self.params = tfm.init_params(self.cfg, seed=SEED, device=DEVICE)
        self.replica = Replica(self.cfg, self.params, BATCH, SEQ)
        self.first_logits = None

    def ready(self):
        return True

    def answer(self, batch):
        """What the serving phase's Replica returns, and the time of that
        call in the actor (it ends in a host copy, so it is synced)."""
        t0 = time.perf_counter()
        answers = self.replica(batch)
        forward_s = time.perf_counter() - t0
        if self.first_logits is None:
            self.first_logits = self.replica.last_logits
        return {"answers": answers, "forward_s": forward_s}

    def first_logits_record(self):
        """The first batch's last-position logits and the sum of its
        logits, as the serving phase records them."""
        return {"last_logits": self.first_logits[:, -1].float().cpu(),
                "logits_sum": self.first_logits.sum(
                    dtype=torch.float64).item()}

    def plain_gap(self, batch):
        """The first batch's logits against the plain attention path on
        the same batch: |kernel - plain bf16| and |plain bf16 - plain
        fp32|, as the serving phase reads them."""
        with torch.inference_mode():
            plain_bf16 = tfm.forward(self.params, batch, dataclasses.replace(
                self.cfg, use_flash=False))
            plain_fp32 = tfm.forward(self.params, batch, dataclasses.replace(
                self.cfg, use_flash=False, dtype=torch.float32))
        return ((self.first_logits - plain_bf16).abs().max().item(),
                (plain_bf16 - plain_fp32).abs().max().item())


class TrainerActor:
    """The training phase's step as a GPU-demand actor: the seed-0 state
    on the card, one ``make_train_step`` step a call."""

    def __init__(self):
        cfg = flagship_config()
        tx = trn.make_optimizer(total_steps=1000)
        self.state = trn.init_state(cfg, tx, seed=SEED, device=DEVICE)
        self.step = trn.make_train_step(cfg, tx)
        torch.cuda.synchronize()

    def ready(self):
        return True

    def train_step(self, tokens):
        t0 = time.perf_counter()
        self.state, metrics = self.step(self.state, {"tokens": tokens})
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        return {"loss": metrics["loss"].item(),
                "grad_norm": metrics["grad_norm"].item(),
                "step": int(metrics["step"]), "step_s": step_s}


class CollectiveMember:
    """A rank of an actor collective group (the ``shm`` host plane)."""

    def _join_collective_group(self, world, rank, backend, name):
        col = importlib.import_module("ray_tpu_torch.collective")
        col.init_collective_group(world, rank, backend, name,
                                  timeout_s=60.0)
        self.group = name
        return rank

    def run(self, x):
        col = importlib.import_module("ray_tpu_torch.collective")
        t0 = time.perf_counter()
        out = {"allreduce": col.allreduce(x, self.group),
               "allgather": np.stack(col.allgather(x, self.group)),
               "broadcast": col.broadcast(x, 1, self.group)}
        out["s"] = time.perf_counter() - t0
        return out

    def leave(self):
        importlib.import_module("ray_tpu_torch.collective") \
            .destroy_collective_group(self.group)


def card_bytes_without_workspaces():
    """The card's allocated bytes after cuBLAS's per-thread workspaces
    are released: each thread that runs a matmul holds one (32 MiB on
    sm_90) through the caching allocator, library state rather than a
    tensor of the caller's."""
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def card_free_bytes():
    """The card's free bytes once cuBLAS's workspaces are released and
    torch's cache is emptied: what library state outside torch's
    allocator (NCCL's buffers, loaded modules) leaves free."""
    card_bytes_without_workspaces()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def wait_freed(baseline, what):
    """Wait until the card's allocated bytes fall back to ``baseline``
    (within RUNTIME_FREE_SLACK): what went away must take its tensors."""
    import gc
    deadline = time.perf_counter() + RUNTIME_FREE_WAIT_S
    while True:
        gc.collect()
        left = card_bytes_without_workspaces() - baseline
        if left <= RUNTIME_FREE_SLACK or time.perf_counter() > deadline:
            break
        time.sleep(0.1)
    check(left <= RUNTIME_FREE_SLACK,
          f"{what}: {left} bytes still allocated after it went away")
    return left


def kill_and_check_freed(rt, actor, baseline, what):
    """Kill ``actor``; the card's memory must come back."""
    rt.kill(actor)
    return wait_freed(baseline, what)


def runtime_device_tier(rt, w):
    """(b) CUDA tensors in the device tier: the identical object back,
    ``hbm_bytes``, the card's memory freed on the refcount's zero, and a
    64 MB tensor consumed by a CPU task in a process worker."""
    import gc
    # the policy's device probe allocates from a thread of its own: let
    # it finish before the card's memory is counted
    for thread in list(tp._device_rt_threads.values()):
        thread.join(timeout=60)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = torch.ones(RUNTIME_SPILL_BYTES // 4, device=DEVICE)
    nbytes = t.nbytes
    ref = rt.put(t)
    check(rt.get(ref) is t, "get of a put CUDA tensor is not the same object")
    hbm = w.device_store.stats()["hbm_bytes"]
    check(hbm == nbytes, f"hbm_bytes {hbm}, tensor {nbytes}")
    del t, ref
    gc.collect()
    torch.cuda.synchronize()
    freed = before + nbytes - torch.cuda.memory_allocated()
    check(freed == nbytes, f"{freed} bytes freed of a {nbytes}-byte tensor")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    t = torch.rand(RUNTIME_SPILL_BYTES // 4, generator=gen, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.cpu()
    d2h_s = time.perf_counter() - t0
    spills = []
    host_copy = w._ensure_host_copy

    def timed_host_copy(oid):
        t0 = time.perf_counter()
        out = host_copy(oid)
        spills.append(time.perf_counter() - t0)
        return out

    w._ensure_host_copy = w.node_group._ensure_host_copy_cb = timed_host_copy
    probe = rt.remote(num_cpus=1)(_spill_probe)
    ref = rt.put(t)
    rounds = []
    for _ in range(2):
        t0 = time.perf_counter()
        got = rt.get(probe.remote(ref), timeout=300)
        rounds.append(time.perf_counter() - t0)
    want = float(t.double().sum())
    stats = w.device_store.stats()
    print(f"runtime: 64 MB CUDA tensor to a process worker: {got}; spills "
          f"{stats['num_spilled_to_host']} ({spills} s), round trips "
          f"{rounds} s (the first starts a worker), device-to-host copy "
          f"{d2h_s:.5f} s")
    check(stats["num_spilled_to_host"] == 1,
          f"{stats['num_spilled_to_host']} host copies, expected 1")
    check(got["type"] == "Tensor" and got["device"] == "cpu",
          f"the worker received {got['type']} on {got['device']}")
    check(got["cuda_available"] is False, "the process worker sees a card")
    check(abs(got["sum"] - want) <= 1e-9 * abs(want),
          f"sum {got['sum']} in the worker, {want} on the card")
    check(rt.get(ref) is t, "the card-side tensor is no longer primary")
    del t, ref
    return {"put_get_identical": True, "hbm_bytes": hbm,
            "freed_bytes": freed, "spill_bytes": RUNTIME_SPILL_BYTES,
            "num_spilled_to_host": stats["num_spilled_to_host"],
            "host_copy_s": spills, "task_round_trip_s": rounds,
            "d2h_copy_s": d2h_s, "worker_saw": got}


def runtime_nested(rt):
    """(g) A nested call from a process worker that sees no card: it gets
    a driver ``put`` of a CUDA tensor (the host copy) and ``put``s its
    sum; the driver's ``get`` of that ref equals the sum on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    t = torch.randint(-1000, 1000, (RUNTIME_NESTED_ELEMS,), generator=gen,
                      device=DEVICE)
    want = t.sum()
    ref = rt.put(t)
    task = rt.remote(num_cpus=1)(_nested_sum)
    t0 = time.perf_counter()
    got = rt.get(task.remote([ref]), timeout=300)
    total = rt.get(got["sum"], timeout=60)
    seconds = time.perf_counter() - t0
    check(got["type"] == "Tensor" and got["device"] == "cpu",
          f"the nested get gave {got['type']} on {got['device']}")
    check(got["cuda_available"] is False, "the process worker sees a card")
    check(isinstance(total, torch.Tensor) and total.item() == want.item(),
          f"nested sum {total}, {want.item()} on the card")
    check(rt.get(ref) is t, "the card-side tensor is no longer primary")
    print(f"runtime: nested get of a {t.nbytes}-byte CUDA tensor from a "
          f"process worker and a put of its sum: {total.item()} (the "
          f"card's {want.item()}) in {seconds:.4f} s")
    del t, ref
    return {"elements": RUNTIME_NESTED_ELEMS, "sum": total.item(),
            "sum_on_card": want.item(), "seconds": seconds,
            "worker_saw": {k: got[k] for k in ("type", "device",
                                               "cuda_available")}}


def check_answers(answers, direct_answers, gap, what, bit_equal):
    """Every answer well formed, the greedy tokens equal to the direct
    run's, the logits heads within LOGITS_GAP_FACTOR x the bf16/fp32 gap
    (or bit for bit equal, where ``bit_equal``). Returns the heads' worst
    difference."""
    cfg = flagship_config()
    check(len(answers) == len(direct_answers),
          f"{what}: {len(answers)} answers")
    check(all(0 <= a["next_token"] < cfg.vocab_size
              and all(math.isfinite(x) for x in a["logits_head"])
              for a in answers), f"{what}: malformed answer")
    head_err = max(abs(x - y) for a, b in zip(answers, direct_answers)
                   for x, y in zip(a["logits_head"], b["logits_head"]))
    tokens_equal = sum(a["next_token"] == b["next_token"]
                       for a, b in zip(answers, direct_answers))
    if bit_equal:
        check(answers == direct_answers,
              f"{what}: answers differ from the direct run's (heads off "
              f"by {head_err}, {tokens_equal}/{len(answers)} tokens equal)")
    check(tokens_equal == len(answers),
          f"{what}: {tokens_equal}/{len(answers)} greedy tokens equal to "
          f"the direct run's")
    bound = LOGITS_GAP_FACTOR * gap
    check(head_err <= bound, f"{what}: logits heads off the direct run's "
          f"by {head_err}, over {bound}")
    return head_err


def runtime_replica(rt, w, direct):
    """(c) The serving phase's 8 requests through a Replica actor, each
    batch a ``put`` ref that the actor, on a thread of this process,
    takes as the tensor itself (no host copy)."""
    cfg = flagship_config()
    baseline = card_bytes_without_workspaces()
    actor = rt.remote(num_gpus=1)(ReplicaActor).remote()
    rt.get(actor.ready.remote(), timeout=600)
    pings = []
    for _ in range(RUNTIME_PINGS):
        t0 = time.perf_counter()
        rt.get(actor.ready.remote(), timeout=60)
        pings.append(time.perf_counter() - t0)
    ping_s = float(np.median(pings))
    requests = direct["requests"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spilled_before = w.device_store.stats()["num_spilled_to_host"]
    reset_launch_counts()
    latencies, replies = [], []
    for i in range(N_REQUESTS // BATCH):
        ref = rt.put(requests[i * BATCH:(i + 1) * BATCH])
        counts = launch_counts()
        t0 = time.perf_counter()
        replies.append(rt.get(actor.answer.remote(ref), timeout=600))
        latencies.append(time.perf_counter() - t0)
        per_batch = tuple(a - b for a, b in zip(launch_counts(), counts))
        check(per_batch == (cfg.n_layers, 0, 0),
              f"actor batch {i}: (fwd, dQ, dK/dV) launches {per_batch}, "
              f"expected ({cfg.n_layers}, 0, 0)")
        del ref
    launches = launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    spilled = w.device_store.stats()["num_spilled_to_host"] - spilled_before
    check(spilled == 0, f"{spilled} host copies of the actor's batches")
    answers = [a for r in replies for a in r["answers"]]
    err, gap = rt.get(actor.plain_gap.remote(rt.put(requests[:BATCH])),
                      timeout=600)
    check(gap > 0 and err <= LOGITS_GAP_FACTOR * gap,
          f"actor logits off the plain path by {err}, over "
          f"{LOGITS_GAP_FACTOR} x the bf16/fp32 gap {gap}")
    head_err = check_answers(answers, direct["answers"],
                             direct["logits_gap_bf16_fp32"], "Replica actor",
                             False)
    record = rt.get(actor.first_logits_record.remote(), timeout=600)
    bit_equal = (answers == direct["answers"]
                 and torch.equal(record["last_logits"],
                                 direct["last_logits"])
                 and record["logits_sum"] == direct["logits_sum"])
    forward_s = [r["forward_s"] for r in replies]
    print(f"runtime: Replica actor batch latency {latencies} s, of which "
          f"the forward in the actor {forward_s} s (direct "
          f"{direct['latency_s']} s); an empty actor call {ping_s:.6f} s "
          f"(median of {RUNTIME_PINGS}); launches {launches}; |actor - plain "
          f"bf16| {err:.4g} (gap {gap:.4g}); greedy tokens equal to the "
          f"direct run's; bit for bit equal to "
          f"the direct run: {bit_equal}; peak {peak_bytes} bytes")
    left = kill_and_check_freed(rt, actor, baseline, "Replica actor")
    return {"batch_latency_s": latencies, "forward_in_actor_s": forward_s,
            "direct_batch_latency_s": direct["latency_s"],
            "empty_call_s": ping_s,
            "launches": {"flash_fwd": launches[0],
                         "flash_bwd_dq": launches[1],
                         "flash_bwd_dkv": launches[2]},
            "logits_err": err, "logits_gap_bf16_fp32": gap,
            "head_err_vs_direct": head_err,
            "next_tokens_equal_direct": N_REQUESTS,
            "bit_equal_direct": bit_equal, "peak_mem_bytes": peak_bytes,
            "left_after_kill_bytes": left}


def runtime_trainer(rt, training, tokens):
    """(d) 3 steps of the training phase through a Trainer actor."""
    cfg = flagship_config()
    baseline = card_bytes_without_workspaces()
    actor = rt.remote(num_gpus=1)(TrainerActor).remote()
    rt.get(actor.ready.remote(), timeout=600)
    ref = rt.put(tokens)
    reset_launch_counts()
    steps, round_trips = [], []
    for i in range(RUNTIME_TRAIN_STEPS):
        counts = launch_counts()
        t0 = time.perf_counter()
        steps.append(rt.get(actor.train_step.remote(ref), timeout=600))
        round_trips.append(time.perf_counter() - t0)
        per_step = tuple(a - b for a, b in zip(launch_counts(), counts))
        check(per_step == (cfg.n_layers,) * 3,
              f"actor step {i}: (fwd, dQ, dK/dV) launches {per_step}, "
              f"expected {cfg.n_layers} each")
        got = steps[-1]
        want_loss, want_norm = training["losses"][i], training["grad_norms"][i]
        check(got["step"] == i, f"actor step {i} reported {got['step']}")
        for name, x, y in (("loss", got["loss"], want_loss),
                           ("grad norm", got["grad_norm"], want_norm)):
            check(math.isfinite(x) and abs(x - y) <= MESH_FIRST_LOSS_REL
                  * abs(y), f"actor step {i}: {name} {x}, the training "
                  f"phase's {y}")
    launches = launch_counts()
    print(f"runtime: Trainer actor losses {[s['loss'] for s in steps]} "
          f"(direct {training['losses'][:RUNTIME_TRAIN_STEPS]}); step time "
          f"in the actor {[s['step_s'] for s in steps]} s, through the "
          f"runtime {round_trips} s (direct "
          f"{training['step_time_s'][:RUNTIME_TRAIN_STEPS]} s); launches "
          f"{launches}")
    del ref
    left = kill_and_check_freed(rt, actor, baseline, "Trainer actor")
    return {"steps": steps, "round_trip_s": round_trips,
            "direct_step_time_s": training["step_time_s"][
                :RUNTIME_TRAIN_STEPS],
            "direct_losses": training["losses"][:RUNTIME_TRAIN_STEPS],
            "direct_grad_norms": training["grad_norms"][:RUNTIME_TRAIN_STEPS],
            "launches": {"flash_fwd": launches[0],
                         "flash_bwd_dq": launches[1],
                         "flash_bwd_dkv": launches[2]},
            "left_after_kill_bytes": left}


def runtime_collective(rt):
    """(e) Two num_gpus=0.5 actors on the card in one collective group."""
    col = importlib.import_module("ray_tpu_torch.collective")
    data = np.random.RandomState(SEED + 3).standard_normal(
        (2, RUNTIME_COLL_ELEMS)).astype(np.float32)
    members = [rt.remote(num_gpus=0.5)(CollectiveMember).remote()
               for _ in range(2)]
    name = col.create_collective_group(members, world_size=2, ranks=[0, 1])
    try:
        refs = [rt.put(torch.from_numpy(data[r]).to(DEVICE))
                for r in range(2)]
        outs = rt.get([m.run.remote(x) for m, x in zip(members, refs)],
                      timeout=300)
        rt.get([m.leave.remote() for m in members], timeout=60)
    finally:
        col.destroy_collective_group(name)
        for m in members:
            rt.kill(m)
    for r, out in enumerate(outs):
        check(np.array_equal(out["allreduce"], data[0] + data[1]),
              f"rank {r}: allreduce differs from numpy's")
        check(np.array_equal(out["allgather"], data),
              f"rank {r}: allgather differs from numpy's")
        check(np.array_equal(out["broadcast"], data[1]),
              f"rank {r}: broadcast differs from the source rank's")
    seconds = [out["s"] for out in outs]
    print(f"runtime: collective group of 2 actors on the card, "
          f"{RUNTIME_COLL_ELEMS} fp32 a rank: allreduce, allgather and "
          f"broadcast equal numpy's, {seconds} s")
    return {"ranks": 2, "elements": RUNTIME_COLL_ELEMS, "equal_numpy": True,
            "seconds": seconds}


def runtime_burst(rt):
    """(f) A burst of no-op tasks through the node manager's policy."""
    noop = rt.remote(num_cpus=0.001)(_noop)
    rt.get([noop.remote() for _ in range(64)], timeout=300)   # workers up
    reset_scheduler_launch_counts()
    t0 = time.perf_counter()
    rt.get([noop.remote() for _ in range(RUNTIME_BURST)], timeout=600)
    seconds = time.perf_counter() - t0
    launches = scheduler_launches_by_name()
    print(f"runtime: {RUNTIME_BURST} no-op tasks in {seconds:.4f} s, "
          f"{RUNTIME_BURST / seconds:.1f} tasks/s, scheduler launches "
          f"{launches}")
    return {"tasks": RUNTIME_BURST, "seconds": seconds,
            "tasks_per_s": RUNTIME_BURST / seconds,
            "schedule_classes_launches": launches["schedule_classes"],
            "scheduler_launches": launches}


def phase_runtime(direct, training, tokens):
    """The port's runtime on the card: ``init()``, the device tier on
    CUDA tensors, the flagship served and trained from GPU-demand actors,
    an actor collective group on the card and a burst of tasks."""
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    w = rt.init()
    init_s = time.perf_counter() - t0
    try:
        resources = rt.cluster_resources()
        check(resources.get("GPU") == torch.cuda.device_count(),
              f"cluster GPU {resources.get('GPU')}, cards "
              f"{torch.cuda.device_count()}")
        policy = type(w.node_group._policy._inner).__name__
        print(f"runtime: init {init_s:.3f} s, resources {resources}, "
              f"policy {policy}")
        out = {"init_s": init_s, "resources": resources, "policy": policy}
        out["device_tier"] = runtime_device_tier(rt, w)
        out["nested"] = runtime_nested(rt)
        out["replica"] = runtime_replica(rt, w, direct)
        torch.cuda.empty_cache()
        out["trainer"] = runtime_trainer(rt, training, tokens)
        torch.cuda.empty_cache()
        out["collective"] = runtime_collective(rt)
        out["burst"] = runtime_burst(rt)
    finally:
        rt.shutdown()
    return out


# -- Serve ------------------------------------------------------------------

SERVE_ROUTED_CALLS = 8                 # concurrent calls over 2 replicas


class FlagshipDeployment:
    """The serving phase's Replica as a Serve deployment: the flagship from
    the seed on the card (through the runtime phase's ReplicaActor), warmed
    once at construction. ``__call__`` answers a batch of token lists as
    ``Replica.__call__`` does; ``one`` takes one token list and is gathered
    by ``@serve.batch`` into batches of up to 4."""

    def __init__(self):
        import uuid
        t0 = time.perf_counter()
        self.model = ReplicaActor()
        torch.cuda.synchronize()
        self.construction_s = time.perf_counter() - t0
        self.tag = uuid.uuid4().hex
        self.batch_sizes = []

    def _tokens(self, token_lists):
        return torch.tensor(token_lists, dtype=torch.long, device=DEVICE)

    def __call__(self, token_lists):
        return self.model.answer(self._tokens(token_lists))["answers"]

    def tagged(self, token_lists):
        """``__call__``'s answers and which replica gave them."""
        return {"replica": self.tag, "answers": self(token_lists)}

    @serve.batch(max_batch_size=BATCH)
    async def one(self, token_lists):
        self.batch_sizes.append(len(token_lists))
        return self.model.replica(self._tokens(token_lists))

    def record(self):
        """The construction time, the gathered batch sizes, and the first
        batch's last-position logits and logits sum."""
        return {"construction_s": self.construction_s,
                "batch_sizes": list(self.batch_sizes),
                **self.model.first_logits_record()}


def serve_batch_gauge():
    """``ray_tpu_serve_batch_size`` as the runtime's metrics page shows it:
    the realised requests per batched dispatch."""
    metrics = importlib.import_module("ray_tpu_torch.util.metrics")
    for line in metrics.prometheus_text().splitlines():
        if line.startswith("ray_tpu_serve_batch_size"):
            return float(line.split()[-1])
    raise SmokeFailure("no ray_tpu_serve_batch_size gauge")


def segment_owners(w, pids):
    """Add to ``pids`` the driver's pid and those of the process workers
    that ``w``'s nodes run now; shared-memory segments of this run are
    named after its session or after one of these pids."""
    pids.add(os.getpid())
    group = w.node_group
    with group._lock:
        raylets = list(group._raylets.values())
    for raylet in raylets:
        with raylet.worker_pool._lock:
            workers = list(raylet.worker_pool._all.values())
        pids.update(worker.proc.pid for worker in workers
                    if getattr(worker, "proc", None) is not None)
    return pids


def segments_left(session, pids):
    """This run's ``rtpt_`` segments still in ``/dev/shm``: those of its
    session (``rtpt_<session>*``) and those its processes own
    (``rtpt_own_<pid>_*``). Other runs' segments are not looked at."""
    prefixes = (f"rtpt_{session}",
                *(f"rtpt_own_{pid}_" for pid in sorted(pids)))
    return sorted(f for f in os.listdir("/dev/shm") if f.startswith(prefixes))


def post_json(url, payload):
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"POST {url}: HTTP {resp.status}")
        return json.loads(resp.read())


def phase_serve(direct, card):
    """Serve on the card: the flagship deployed on a ``num_gpus=1``
    replica and answered through a handle, through ``@serve.batch`` and
    through the HTTP ingress; then on two ``num_gpus=0.5`` replicas of one
    card behind the router; then torn down."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import serve_stats
    cfg = flagship_config()
    requests = direct["requests"].tolist()
    batches = [requests[i * BATCH:(i + 1) * BATCH]
               for i in range(N_REQUESTS // BATCH)]
    gap = direct["logits_gap_bf16_fp32"]
    n_batches = len(batches)
    w = rt.init()
    session, pids = w.session, set()
    try:
        for thread in list(tp._device_rt_threads.values()):
            thread.join(timeout=60)
        baseline = card_bytes_without_workspaces()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        reset_scheduler_launch_counts()
        out = {"card": card}

        # (a) the handle path, on one num_gpus=1 replica
        deployment = serve.deployment(
            name="flagship", ray_actor_options={"num_gpus": 1})(
                FlagshipDeployment)
        t0 = time.perf_counter()
        handle = serve.run(deployment.bind(), timeout=600)
        run_s = time.perf_counter() - t0
        latencies, answers = [], []
        for i, batch in enumerate(batches):
            counts = launch_counts()
            t0 = time.perf_counter()
            answers += rt.get(handle.remote(batch), timeout=600)
            latencies.append(time.perf_counter() - t0)
            per_batch = tuple(a - b for a, b in zip(launch_counts(), counts))
            check(per_batch == (cfg.n_layers, 0, 0),
                  f"handle batch {i}: (fwd, dQ, dK/dV) launches {per_batch}, "
                  f"expected ({cfg.n_layers}, 0, 0)")
        record = rt.get(handle.record.remote(), timeout=600)
        check_answers(answers, direct["answers"], gap, "handle", True)
        check(torch.equal(record["last_logits"], direct["last_logits"])
              and record["logits_sum"] == direct["logits_sum"],
              "handle: the first batch's logits differ from the direct "
              "run's")
        out["handle"] = {
            "serve_run_s": run_s,
            "construction_s": record["construction_s"],
            "batch_latency_s": latencies,
            "overhead_s": [a - b for a, b in zip(latencies,
                                                 direct["latency_s"])],
            "bit_equal_direct": True}

        # (b) @serve.batch: 8 concurrent single-sequence calls
        serve_stats.reset()
        counts = launch_counts()
        t0 = time.perf_counter()
        refs = [handle.one.remote(seq) for seq in requests]
        batched = rt.get(refs, timeout=600)
        batch_s = time.perf_counter() - t0
        sizes = rt.get(handle.record.remote(), timeout=600)["batch_sizes"]
        per_path = tuple(a - b for a, b in zip(launch_counts(), counts))
        check(sum(sizes) == N_REQUESTS and max(sizes) <= BATCH,
              f"@serve.batch gathered {sizes}")
        check(per_path == (cfg.n_layers * len(sizes), 0, 0),
              f"@serve.batch: (fwd, dQ, dK/dV) launches {per_path} for "
              f"{len(sizes)} batches")
        head_err = check_answers(batched, direct["answers"], gap,
                                 "@serve.batch", False)
        out["batch"] = {
            "seconds": batch_s, "batch_sizes": sizes,
            "gauge_batch_size": serve_batch_gauge(),
            "router_batches": serve_stats.snapshot()["batches"],
            "head_err_vs_direct": head_err,
            "bit_equal_direct": batched == direct["answers"]}

        # (c) the HTTP ingress, hosted by the driver
        serve.start(http=True, proxy_location="driver")
        host, port = serve.http_address()
        url = f"http://{host}:{port}/flagship"
        http_latencies, http_answers = [], []
        for i, batch in enumerate(batches):
            counts = launch_counts()
            t0 = time.perf_counter()
            http_answers += post_json(url, batch)
            http_latencies.append(time.perf_counter() - t0)
            per_batch = tuple(a - b for a, b in zip(launch_counts(), counts))
            check(per_batch == (cfg.n_layers, 0, 0),
                  f"HTTP batch {i}: (fwd, dQ, dK/dV) launches {per_batch}")
        check_answers(http_answers, direct["answers"], gap, "HTTP", True)
        out["http"] = {
            "batch_latency_s": http_latencies,
            "overhead_s": [a - b for a, b in zip(http_latencies,
                                                 direct["latency_s"])],
            "request_bytes": [len(json.dumps(b)) for b in batches],
            "bit_equal_direct": True}
        serve.delete("flagship")
        del handle
        out["left_after_delete_bytes"] = wait_freed(
            baseline, "the num_gpus=1 deployment")

        # (d) two num_gpus=0.5 replicas of the card behind the router
        pair = serve.deployment(
            name="flagship_x2", num_replicas=2,
            ray_actor_options={"num_gpus": 0.5})(FlagshipDeployment)
        t0 = time.perf_counter()
        handle2 = serve.run(pair.bind(), timeout=600)
        run2_s = time.perf_counter() - t0
        check(serve.status()["flagship_x2"]["live_replicas"] == 2,
              f"routing: {serve.status()['flagship_x2']}")
        counts = launch_counts()
        t0 = time.perf_counter()
        refs = [handle2.tagged.remote(batches[i % n_batches])
                for i in range(SERVE_ROUTED_CALLS)]
        replies = rt.get(refs, timeout=600)
        routed_s = time.perf_counter() - t0
        per_path = tuple(a - b for a, b in zip(launch_counts(), counts))
        check(per_path == (cfg.n_layers * SERVE_ROUTED_CALLS, 0, 0),
              f"routing: (fwd, dQ, dK/dV) launches {per_path}")
        taken = {}
        for reply in replies:
            taken[reply["replica"]] = taken.get(reply["replica"], 0) + 1
        check(len(taken) == 2, f"routing: calls per replica {taken}")
        routed = [reply["answers"] for reply in replies]
        wanted = [direct["answers"][(i % n_batches) * BATCH:
                                    (i % n_batches + 1) * BATCH]
                  for i in range(SERVE_ROUTED_CALLS)]
        worst = max(check_answers(got, want, gap, f"routed call {i}", False)
                    for i, (got, want) in enumerate(zip(routed, wanted)))
        out["routing"] = {
            "serve_run_s": run2_s, "seconds": routed_s,
            "calls": SERVE_ROUTED_CALLS,
            "calls_per_replica": sorted(taken.values()),
            "head_err_vs_direct": worst,
            "bit_equal_direct": routed == wanted}
        del handle2
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        segment_owners(w, pids)

        # (e) teardown
        serve.shutdown()
        out["left_after_shutdown_bytes"] = wait_freed(
            baseline, "serve.shutdown")
    finally:
        serve.shutdown()
        segment_owners(w, pids)
        rt.shutdown()
    left = segments_left(session, pids)
    check(not left, f"shared-memory segments of this run left after "
          f"shutdown: {left}")
    out["launches"] = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                               launch_counts()))
    out["scheduler_launches"] = scheduler_launches_by_name()
    out["schedule_classes_launches"] = out["scheduler_launches"][
        "schedule_classes"]
    out["direct_batch_latency_s"] = direct["latency_s"]
    h, b, x = out["handle"], out["batch"], out["http"]
    print(f"serve ({card}): replica construction "
          f"{h['construction_s']:.3f} s (serve.run {h['serve_run_s']:.3f} s); "
          f"handle batches {h['batch_latency_s']} s, HTTP batches "
          f"{x['batch_latency_s']} s, direct {direct['latency_s']} s; "
          f"overhead a batch: handle {h['overhead_s']} s, HTTP "
          f"{x['overhead_s']} s; @serve.batch of {N_REQUESTS} calls in "
          f"{b['seconds']:.4f} s, batches {b['batch_sizes']} (gauge "
          f"{b['gauge_batch_size']:.3f}), heads within "
          f"{b['head_err_vs_direct']:.4g}, bit equal "
          f"{b['bit_equal_direct']}; 2 replicas took "
          f"{out['routing']['calls_per_replica']} of "
          f"{SERVE_ROUTED_CALLS} calls in {out['routing']['seconds']:.4f} s; "
          f"peak {out['peak_mem_bytes']} bytes; launches {out['launches']}; "
          f"scheduler launches {out['scheduler_launches']}")
    return out


# -- Train and multi-slice ----------------------------------------------------

TRAIN_GANG_STEPS = 3          # phase 15's first fit: steps 1-3
TRAIN_CKPT_STEP = 2           # the loop checkpoints the state after step 2
TRAIN_GANG_COLL_ELEMS = 1 << 20
MS_STEPS = 3                  # steps of each MultiSliceTrainer run
MS_LR = 0.01                  # the numpy SGD step of phase 16's apply_fn
MS_WAIT_S = 600.0             # collective, step and recovery deadlines
TRAIN_RECORD = {}             # what a gang worker measured besides reports
MS_CLOCK = {}                 # seconds by part, summed over ranks and steps
MS_CACHE = {}                 # the ViT's layout and images, made once
MS_LOCK = threading.Lock()
MS_PARTS = ("host_copies", "gradient", "shm_plane", "actor_checkpoint")


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def train_state_tree(state):
    """A TrainState as a tree of dicts and lists (torch's pytree knows no
    dataclass): the step, the parameters, AdamW's count and moments."""
    return {"step": state.step, "params": state.params,
            "count": state.opt_state.count, "mu": state.opt_state.mu,
            "nu": state.opt_state.nu}


def train_state_from_tree(tree):
    """``train_state_tree``'s inverse, every tensor on the card."""
    pytree = importlib.import_module("torch.utils._pytree")

    def card(x):
        return (torch.from_numpy(x) if isinstance(x, np.ndarray)
                else x).to(DEVICE)
    return trn.TrainState(
        step=int(tree["step"]), params=pytree.tree_map(card, tree["params"]),
        opt_state=trn.AdamWState(count=int(tree["count"]),
                                 mu=[card(x) for x in tree["mu"]],
                                 nu=[card(x) for x in tree["nu"]]))


def gang_flagship_loop(config):
    """Phase 15 (a)'s user loop, run by the gang's one worker on the card:
    the seed-0 TrainState, or the one its checkpoint holds; steps until
    TRAIN_GANG_STEPS on the training phase's tokens, one report a step
    (loss, grad norm, launches, time); after step TRAIN_CKPT_STEP the
    whole state through ``save_pytree``, reported as a Checkpoint."""
    train = importlib.import_module("ray_tpu_torch.train")
    cfg = flagship_config()
    tx = trn.make_optimizer(total_steps=1000)
    ckpt = train.get_checkpoint()
    load_s = None
    if ckpt is None:
        state = trn.init_state(cfg, tx, seed=SEED, device=DEVICE)
    else:
        t0 = time.perf_counter()
        state = train_state_from_tree(train.load_pytree(ckpt.path))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    step = trn.make_train_step(cfg, tx)
    tokens = config["tokens"]
    while state.step < TRAIN_GANG_STEPS:
        counts = launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        report = {"step": int(metrics["step"]),
                  "loss": metrics["loss"].item(),
                  "grad_norm": metrics["grad_norm"].item(),
                  "step_s": time.perf_counter() - t0,
                  "launches": [a - b for a, b in zip(launch_counts(),
                                                     counts)],
                  "load_s": load_s, "device": str(tokens.device)}
        checkpoint = None
        if state.step == TRAIN_CKPT_STEP:
            d = tempfile.mkdtemp(prefix="state_", dir=config["scratch"])
            t0 = time.perf_counter()
            train.save_pytree(train_state_tree(state), d)
            report["save_s"] = time.perf_counter() - t0
            report["ckpt_bytes"] = dir_bytes(d)
            checkpoint = train.Checkpoint.from_directory(d)
        t0 = time.perf_counter()
        train.report(report, checkpoint=checkpoint)
        if checkpoint is not None:     # report copies it into the trial dir
            TRAIN_RECORD["report_copy_s"] = time.perf_counter() - t0


def gang_collective_loop(config):
    """Phase 15 (b)'s user loop, run by each of two ``{"GPU": 0.5}``
    workers: its rank's seeded fp32 vector on the card, allreduced over
    the gang's collective group; the sum and what the worker saw of its
    session written to ``config["dir"]`` under its rank."""
    train = importlib.import_module("ray_tpu_torch.train")
    col = importlib.import_module("ray_tpu_torch.collective")
    ctx = train.get_context()
    rank = ctx.get_rank()
    x = torch.from_numpy(config["data"][rank]).to(DEVICE)
    t0 = time.perf_counter()
    out = col.allreduce(x, ctx.collective_group)
    seconds = time.perf_counter() - t0
    np.save(os.path.join(config["dir"], f"sum_{rank}.npy"), out)
    with open(os.path.join(config["dir"], f"rank_{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": ctx.get_world_size(),
                   "pid": os.getpid(), "seconds": seconds,
                   "input_device": str(x.device)}, f)
    train.report({"rank": rank, "world": ctx.get_world_size()})


def train_flagship(training, tokens, scratch, card):
    """(a) The flagship through a one-worker ``DataParallelTrainer``."""
    train = importlib.import_module("ray_tpu_torch.train")
    cfg = flagship_config()
    n_params = sum(p.numel() for p in trn.param_leaves(
        tfm.init_params(cfg, seed=SEED, device=DEVICE)))
    state_bytes = 3 * 4 * n_params           # fp32 params, mu and nu
    disk = shutil.disk_usage(scratch)
    print(f"train: storage {scratch}: {disk.free} bytes free of "
          f"{disk.total}; the state is {state_bytes} bytes, checkpointed "
          f"once and copied into the trial dir")
    check(disk.free > 2.1 * state_bytes,
          f"train: {disk.free} bytes free under {scratch}, the checkpoint "
          f"and its copy need {2 * state_bytes}")
    baseline = card_bytes_without_workspaces()
    config = {"tokens": tokens, "scratch": scratch}
    storage = os.path.join(scratch, "results")
    TRAIN_RECORD.clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    first = train.DataParallelTrainer(
        gang_flagship_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(name="flagship",
                                   storage_path=storage)).fit()
    fit_s = time.perf_counter() - t0
    check(first.error is None, f"train: the fit failed: {first.error!r}")
    hist = first.metrics_history
    check(len(hist) == TRAIN_GANG_STEPS,
          f"train: metrics_history has {len(hist)} entries")
    for i, m in enumerate(hist):
        check(m["step"] == i, f"train: report {i} is of step {m['step']}")
        check(m["device"].startswith(DEVICE),
              f"train: the worker's tokens are on {m['device']}")
        check(tuple(m["launches"]) == (cfg.n_layers,) * 3,
              f"train: step {i}: (fwd, dQ, dK/dV) launches "
              f"{m['launches']}, expected {cfg.n_layers} each")
        for name, x, y in (("loss", m["loss"], training["losses"][i]),
                           ("grad norm", m["grad_norm"],
                            training["grad_norms"][i])):
            check(math.isfinite(x) and abs(x - y) <= MESH_FIRST_LOSS_REL
                  * abs(y), f"train: step {i}: {name} {x}, the training "
                  f"phase's {y}")
    saved = hist[TRAIN_CKPT_STEP - 1]
    check(first.checkpoint is not None
          and first.checkpoint.path.startswith(storage),
          f"train: checkpoint {first.checkpoint}")
    left_first = wait_freed(baseline, "the first fit's gang")

    t0 = time.perf_counter()
    resumed = train.DataParallelTrainer(
        gang_flagship_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(name="flagship_resumed",
                                   storage_path=storage),
        resume_from_checkpoint=first.checkpoint).fit()
    resume_fit_s = time.perf_counter() - t0
    launches = launch_counts()
    check(resumed.error is None,
          f"train: the resumed fit failed: {resumed.error!r}")
    again = resumed.metrics_history
    check(len(again) == 1 and again[0]["step"] == TRAIN_GANG_STEPS - 1,
          f"train: the resumed fit reported {again}")
    last = hist[-1]
    check(again[0]["loss"] == last["loss"]
          and again[0]["grad_norm"] == last["grad_norm"],
          f"train: resumed step {TRAIN_GANG_STEPS}: loss "
          f"{again[0]['loss']!r}, grad norm {again[0]['grad_norm']!r}; the "
          f"first fit's {last['loss']!r}, {last['grad_norm']!r}")
    check(tuple(again[0]["launches"]) == (cfg.n_layers,) * 3,
          f"train: resumed step launches {again[0]['launches']}")
    left = wait_freed(baseline, "the resumed fit's gang")
    runs = TRAIN_GANG_STEPS + 1
    check(launches == (cfg.n_layers * runs,) * 3,
          f"train: launches {launches} over {runs} steps")
    out = {"fit_s": fit_s, "resume_fit_s": resume_fit_s,
           "step_time_s": [m["step_s"] for m in hist],
           "direct_step_time_s": training["step_time_s"][:TRAIN_GANG_STEPS],
           "losses": [m["loss"] for m in hist],
           "grad_norms": [m["grad_norm"] for m in hist],
           "resumed_step_s": again[0]["step_s"],
           "resumed_bit_equal": True,
           "ckpt_bytes": saved["ckpt_bytes"], "state_bytes": state_bytes,
           "save_s": saved["save_s"],
           "report_copy_s": TRAIN_RECORD.get("report_copy_s"),
           "load_s": again[0]["load_s"], "disk_free_bytes": disk.free,
           "left_after_fits_bytes": [left_first, left],
           "launches": dict(zip(("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv"), launches))}
    print(f"train ({card}): gang losses {out['losses']} (direct "
          f"{training['losses'][:TRAIN_GANG_STEPS]}); step times in the "
          f"gang {out['step_time_s']} s (direct {out['direct_step_time_s']}"
          f" s); fits {fit_s:.2f} / {resume_fit_s:.2f} s; checkpoint "
          f"{saved['ckpt_bytes']} bytes, save {saved['save_s']:.2f} s, "
          f"report copy {out['report_copy_s']} s, load "
          f"{out['load_s']:.2f} s; resumed step {TRAIN_GANG_STEPS} bit for "
          f"bit (loss {last['loss']!r}); launches {launches}")
    return out


def train_gang_collective(scratch, card):
    """(b) Two ``{"GPU": 0.5}`` workers, both on threads of the driver."""
    train = importlib.import_module("ray_tpu_torch.train")
    data = np.random.RandomState(SEED + 5).standard_normal(
        (2, TRAIN_GANG_COLL_ELEMS)).astype(np.float32)
    out_dir = tempfile.mkdtemp(prefix="gang_", dir=scratch)
    baseline = card_bytes_without_workspaces()
    t0 = time.perf_counter()
    res = train.DataParallelTrainer(
        gang_collective_loop,
        train_loop_config={"data": data, "dir": out_dir},
        scaling_config=train.ScalingConfig(
            num_workers=2, resources_per_worker={"GPU": 0.5}),
        run_config=train.RunConfig(
            name="gang", storage_path=os.path.join(scratch, "results"))).fit()
    fit_s = time.perf_counter() - t0
    check(res.error is None, f"gang: the fit failed: {res.error!r}")
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".json"))
    check(files == ["rank_0.json", "rank_1.json"],
          f"gang: the workers wrote {files}, not ranks 0 and 1 once each")
    seen = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank_{r}.json")) as f:
            seen.append(json.load(f))
        total = np.load(os.path.join(out_dir, f"sum_{r}.npy"))
        check(np.array_equal(total, data[0] + data[1]),
              f"gang: rank {r}'s allreduce differs from numpy's")
    check([s["rank"] for s in seen] == [0, 1]
          and all(s["world"] == 2 for s in seen),
          f"gang: sessions {seen}")
    check(all(s["pid"] == os.getpid() for s in seen),
          f"gang: the workers ran in {[s['pid'] for s in seen]}, not in "
          f"the driver {os.getpid()}")
    left = wait_freed(baseline, "the 2-worker gang")
    print(f"train ({card}): gang of 2 GPU 0.5 workers in the driver's "
          f"process, "
          f"ranks {[s['rank'] for s in seen]}, allreduce of "
          f"{TRAIN_GANG_COLL_ELEMS} fp32 equal to numpy's in "
          f"{[s['seconds'] for s in seen]} s; fit {fit_s:.2f} s; {left} "
          f"bytes left")
    return {"ranks": [s["rank"] for s in seen], "world": 2,
            "elements": TRAIN_GANG_COLL_ELEMS, "equal_numpy": True,
            "allreduce_s": [s["seconds"] for s in seen], "fit_s": fit_s,
            "left_after_bytes": left}


def phase_train(training, tokens, card):
    """Phase 15: Train on the card (``ray_tpu_torch.train``)."""
    import ray_tpu_torch as rt
    scratch = tempfile.mkdtemp(prefix="chip_smoke_train_")
    rt.init()
    try:
        for thread in list(tp._device_rt_threads.values()):
            thread.join(timeout=60)
        reset_scheduler_launch_counts()
        out = {"card": card, "flagship": train_flagship(
            training, tokens, scratch, card)}
        torch.cuda.empty_cache()
        out["gang"] = train_gang_collective(scratch, card)
        out["scheduler_launches"] = scheduler_launches_by_name()
    finally:
        rt.shutdown()
        shutil.rmtree(scratch, ignore_errors=True)
    return out


def _ms_clock(part, seconds):
    with MS_LOCK:
        MS_CLOCK[part] = MS_CLOCK.get(part, 0.0) + seconds


def _ms_layout(cfg):
    """The ViT's parameter tree with meta tensors for leaves (shapes
    only), made once from a seed-0 init on the card."""
    key = ("layout", repr(cfg))
    with MS_LOCK:
        layout = MS_CACHE.get(key)
    if layout is None:
        pytree = importlib.import_module("torch.utils._pytree")
        params = vit.init_vit_params(cfg, seed=SEED, device=DEVICE)
        layout = pytree.tree_map(
            lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
            params)
        with MS_LOCK:
            MS_CACHE[key] = layout
    return layout


def _ms_unflatten(flat, like):
    """A tree shaped like ``like`` whose leaves are views of ``flat``, in
    ``param_leaves`` order."""
    pieces = iter(torch.split(flat, [p.numel()
                                      for p in trn.param_leaves(like)]))

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(pieces).view(node.shape)
    return build(like)


def ms_images(cfg):
    """VIT_IMAGES images and labels from RandomState(0), as phase 11's."""
    key = ("images", repr(cfg))
    with MS_LOCK:
        batch = MS_CACHE.get(key)
    if batch is None:
        rng = np.random.RandomState(0)
        batch = (rng.rand(VIT_IMAGES, cfg.image_size, cfg.image_size,
                          cfg.channels).astype(np.float32),
                 rng.randint(0, cfg.num_classes, VIT_IMAGES))
        with MS_LOCK:
            MS_CACHE[key] = batch
    return batch


def ms_init_fn():
    """``init_fn``: the seed-0 ViT-B/16 parameters as one flat fp32
    vector, in ``param_leaves`` order."""
    params = vit.init_vit_params(vit_b16_config(), seed=SEED, device=DEVICE)
    return torch.cat([p.reshape(-1).float()
                      for p in trn.param_leaves(params)]).cpu().numpy()


def ms_grad_fn(state, global_rank, world, step):
    """``grad_fn``: the flat state onto the card as the ViT's parameters,
    the gradient of ``vit_loss_fn`` on this rank's VIT_IMAGES / world
    images, back as flat fp32 numpy. Times its host copies and its
    compute into MS_CLOCK."""
    del step
    cfg = vit_b16_config()
    images, labels = ms_images(cfg)
    per = VIT_IMAGES // world
    rows = slice(global_rank * per, (global_rank + 1) * per)
    t0 = time.perf_counter()
    flat = torch.from_numpy(state).to(DEVICE)
    batch = {"images": torch.from_numpy(images[rows]).to(DEVICE),
             "labels": torch.from_numpy(labels[rows]).to(DEVICE)}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    flat.requires_grad_(True)
    params = _ms_unflatten(flat, _ms_layout(cfg))
    loss = vit.vit_loss_fn(params, batch, cfg)
    (grad,) = torch.autograd.grad(loss, flat)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = grad.float().cpu().numpy()
    t3 = time.perf_counter()
    _ms_clock("host_copies", (t1 - t0) + (t3 - t2))
    _ms_clock("gradient", t2 - t1)
    return out


def ms_apply_fn(state, synced):
    """``apply_fn``: a numpy SGD step; the metric is the synced
    gradient's norm."""
    return state - MS_LR * synced, float(np.linalg.norm(synced))


def _timed(fn, part):
    """``fn`` that adds its seconds to MS_CLOCK[part]."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _ms_clock(part, time.perf_counter() - t0)
    return wrapper


def dcn_gauge():
    metrics = importlib.import_module("ray_tpu_torch.util.metrics")
    for line in metrics.prometheus_text().splitlines():
        if line.startswith("ray_tpu_dcn_bytes"):
            return float(line.split()[-1])
    return None


def multislice_run(num_slices, ranks_per_slice):
    """One MultiSliceTrainer run of MS_STEPS steps on ``{"GPU": 0.5}``
    ranks: its history, final snapshots, DCN counters, step times and
    the seconds of each part of a step, summed over ranks."""
    mst = importlib.import_module("ray_tpu_torch.train.multislice")
    ms_pkg = importlib.import_module("ray_tpu_torch.multislice")
    ackpt = importlib.import_module("ray_tpu_torch._private.actor_checkpoint")
    baseline = card_bytes_without_workspaces()
    plain = (ms_pkg.hierarchical_allreduce, ackpt.save_generation)
    ms_pkg.hierarchical_allreduce = _timed(plain[0], "shm_plane")
    ackpt.save_generation = _timed(plain[1], "actor_checkpoint")
    tr = mst.MultiSliceTrainer(
        ms_init_fn, ms_grad_fn, ms_apply_fn,
        mst.MultiSliceConfig(
            num_slices=num_slices, ranks_per_slice=ranks_per_slice,
            resources_per_worker={"GPU": 0.5},
            collective_timeout_s=MS_WAIT_S, step_timeout_s=MS_WAIT_S,
            recover_timeout_s=MS_WAIT_S))
    try:
        t0 = time.perf_counter()
        tr.start()
        start_s = time.perf_counter() - t0
        with MS_LOCK:
            MS_CLOCK.update(dict.fromkeys(MS_PARTS, 0.0))
        hist, step_s = [], []
        for _ in range(MS_STEPS):
            t0 = time.perf_counter()
            hist += tr.run(1)
            step_s.append(time.perf_counter() - t0)
        with MS_LOCK:
            parts = {k: MS_CLOCK[k] for k in MS_PARTS}
        snaps = tr.snapshots()
        stats = tr.dcn_stats()
        # the gauge trails dcn_stats(): read it until it catches up
        deadline = time.perf_counter() + 60
        gauge = dcn_gauge()
        while (stats["bytes_tx"] and gauge != stats["bytes_tx"]
               and time.perf_counter() < deadline):
            time.sleep(0.1)
            gauge = dcn_gauge()
    finally:
        tr.shutdown()
        ms_pkg.hierarchical_allreduce, ackpt.save_generation = plain
    left = wait_freed(baseline, f"the {num_slices} x {ranks_per_slice} "
                      f"MultiSliceTrainer")
    ranks = num_slices * ranks_per_slice
    return {"history": hist, "snapshots": snaps, "dcn": stats,
            "dcn_gauge": gauge, "start_s": start_s, "step_s": step_s,
            "parts_s_per_rank_step": {k: v / (ranks * MS_STEPS)
                                      for k, v in parts.items()},
            "left_after_bytes": left}


def phase_multislice(card):
    """Phase 16: ViT-B/16 through ``MultiSliceTrainer`` on the card, flat
    (1 slice of 2 ranks) and hierarchical (2 slices of 1 rank), against a
    direct loop of the same functions."""
    import ray_tpu_torch as rt
    col = importlib.import_module("ray_tpu_torch.collective.collective")
    cfg = vit_b16_config()
    n_params = sum(p.numel() for p in trn.param_leaves(_ms_layout(cfg)))
    grad_bytes = 4 * n_params
    shm = shutil.disk_usage("/dev/shm")
    need = 8 * grad_bytes
    coll_base, scratch = col._BASE, None
    print(f"multislice: /dev/shm {shm.free} bytes free of {shm.total}; "
          f"a rank file is {grad_bytes} bytes, up to {need} at once")
    if shm.free < need:
        scratch = tempfile.mkdtemp(prefix="chip_smoke_coll_")
        col._BASE = scratch
        print(f"multislice: /dev/shm is too small, collective files under "
              f"{scratch} (RAY_TPU_COLL_DIR)")

    # the direct loop: both shards' gradients, np.mean, apply
    state = ms_init_fn()
    direct = []
    for step in range(1, MS_STEPS + 1):
        grads = [ms_grad_fn(state, r, 2, step) for r in range(2)]
        state, metric = ms_apply_fn(state, np.mean(np.stack(grads), axis=0))
        direct.append((step, metric))
    direct_state = state

    launches_before = launch_counts()
    rt.init()
    try:
        for thread in list(tp._device_rt_threads.values()):
            thread.join(timeout=60)
        reset_scheduler_launch_counts()
        flat = multislice_run(1, 2)
        torch.cuda.empty_cache()
        hier = multislice_run(2, 1)
        sched = scheduler_launches_by_name()
    finally:
        rt.shutdown()
        col._BASE = coll_base
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    launched = tuple(a - b for a, b in zip(launch_counts(), launches_before))
    check(launched == (0, 0, 0), f"multislice: attention kernels launched "
          f"{launched}; the ViT attends densely")

    for name, run in (("flat", flat), ("hierarchical", hier)):
        check([s for s, _ in run["history"]] == list(range(1, MS_STEPS + 1)),
              f"multislice {name}: history {run['history']}")
        check(all(s == MS_STEPS for s, _ in run["snapshots"]),
              f"multislice {name}: ranks at steps "
              f"{[s for s, _ in run['snapshots']]}")
    # the reference test's comparison (tests/test_multislice.py:135-141)
    for (_, fm), (_, hm), (_, dm) in zip(flat["history"], hier["history"],
                                         direct):
        np.testing.assert_allclose(hm, fm)
        np.testing.assert_allclose(fm, dm)
    for (_, fstate), (_, hstate) in zip(flat["snapshots"], hier["snapshots"]):
        np.testing.assert_allclose(fstate, hstate)
        np.testing.assert_allclose(fstate, direct_state)
    state_diff = max(float(np.max(np.abs(f - h)))
                     for (_, f), (_, h) in zip(flat["snapshots"],
                                               hier["snapshots"]))
    metric_diff = max(abs(f - h) for (_, f), (_, h) in zip(
        flat["history"], hier["history"]))
    direct_diff = max(float(np.max(np.abs(s - direct_state)))
                      for _, s in flat["snapshots"] + hier["snapshots"])
    check(flat["dcn"]["bytes_tx"] == 0 and flat["dcn"]["ops"] == 0,
          f"multislice flat: DCN counters {flat['dcn']}")
    want = 2 * grad_bytes * MS_STEPS
    check(hier["dcn"]["bytes_tx"] == want
          and hier["dcn"]["ops"] == 2 * MS_STEPS,
          f"multislice hierarchical: DCN bytes_tx {hier['dcn']['bytes_tx']}"
          f", ops {hier['dcn']['ops']}; expected {want}, {2 * MS_STEPS}")
    check(hier["dcn_gauge"] == want,
          f"multislice: ray_tpu_dcn_bytes {hier['dcn_gauge']}, expected "
          f"{want}")
    out = {"card": card, "params": n_params, "grad_bytes": grad_bytes,
           "images": VIT_IMAGES, "steps": MS_STEPS, "lr": MS_LR,
           "shm_free_bytes": shm.free,
           "collective_dir": "/dev/shm" if scratch is None else "disk",
           "direct_history": direct,
           "max_abs_state_diff_flat_hier": state_diff,
           "max_abs_metric_diff_flat_hier": metric_diff,
           "max_abs_state_diff_vs_direct": direct_diff,
           "scheduler_launches": sched, "kernel_launches": list(launched)}
    for name, run in (("flat", flat), ("hierarchical", hier)):
        step = sum(run["step_s"][1:]) / (MS_STEPS - 1)
        parts = run["parts_s_per_rank_step"]
        out[name] = {"history": run["history"], "dcn": run["dcn"],
                     "dcn_gauge": run["dcn_gauge"], "start_s": run["start_s"],
                     "step_s": run["step_s"], "parts_s": parts,
                     "share_of_step": {k: v / step for k, v in parts.items()},
                     "left_after_bytes": run["left_after_bytes"]}
        print(f"multislice {name} ({card}): steps {run['step_s']} s; per "
              f"rank and step: " + ", ".join(
                  f"{k} {v:.4f} s" for k, v in parts.items())
              + f"; DCN bytes_tx {run['dcn']['bytes_tx']}, ops "
              f"{run['dcn']['ops']}, gauge {run['dcn_gauge']}")
    print(f"multislice ({card}): flat and hierarchical agree, largest "
          f"|d| state "
          f"{state_diff:.4g}, metric {metric_diff:.4g}; against the direct "
          f"loop {direct_diff:.4g}; grad norms {[m for _, m in direct]}")
    return out


# -- multi-node -------------------------------------------------------------

CLUSTER_HEAD_CPUS = 4
CLUSTER_REMOTE_CPUS = 2
CLUSTER_XFER_ELEMS = 8 << 20          # int64: 64 MB each way
CLUSTER_LOST_ELEMS = 2 << 20          # int64: 16 MB whose only copy dies
CLUSTER_BURST = 64                    # CPU tasks of CLUSTER_BURST_S each
CLUSTER_BURST_S = 0.1
CLUSTER_KILL_AFTER = 16               # burst results in before the kill
CLUSTER_PINGS = 20                    # empty client tasks timed
CLUSTER_WAIT_S = 120.0
CLIENT_ATTN = (1, 2048, 16, 128)      # B, S, N, H of the client's forward


class _Spread:
    """The spread policy's strategy: the composite policy routes
    ``kind == "SPREAD"`` to round robin over the feasible nodes."""

    kind = "SPREAD"


def _where():
    """Which process runs this task (its parent is the raylet, or the
    driver for the head's workers), and the card it sees."""
    import os
    return os.getppid(), os.environ.get("CUDA_VISIBLE_DEVICES")


def _import_torch(hold_s):
    """Load torch in a remote worker (what unpickling a tensor does
    first), then hold the worker so that its sibling takes the other
    call; the seconds of the import."""
    import time as _time
    t0 = _time.perf_counter()
    import torch  # noqa: F401
    seconds = _time.perf_counter() - t0
    _time.sleep(hold_s)
    return seconds


def _tensor_sum(x):
    """A CPU task on a remote node: what its argument arrived as and its
    exact sum."""
    return {"type": type(x).__name__, "device": str(x.device),
            "sum": int(x.sum())}


def _make_array(n, seed):
    import numpy as np
    return np.random.default_rng(seed).integers(0, 1 << 20, size=n,
                                                dtype=np.int64)


def _card_sum(a, device):
    """A GPU task on the head: the array moved to the card and summed
    there, and the seconds of that move and sum."""
    import time as _time
    import torch as _torch
    t0 = _time.perf_counter()
    total = int(_torch.from_numpy(a).to(device).sum())
    return total, _time.perf_counter() - t0


def _cut_batch(requests, i, batch):
    """A CPU task on a remote node: batch ``i`` of the serving phase's
    requests, as a tensor of this node's store."""
    return requests[i * batch:(i + 1) * batch].clone()


def _burst_task(i, seconds):
    import os
    import time as _time
    _time.sleep(seconds)
    return i * i, os.getppid()


def _client_flash(shape, seed, device):
    """The port's flash forward (the kernel on a CUDA tensor) on seeded
    bf16 q, k, v: the output's and the LSE's float64 sums, the process
    that ran it and the forward kernel's launches in that call."""
    import os
    import importlib as _il
    import torch as _torch
    fa_mod = _il.import_module("ray_tpu_torch.ops.flash_attention")
    gen = _torch.Generator(device=device).manual_seed(seed)
    q, k, v = (_torch.randn(shape, generator=gen, device=device,
                            dtype=_torch.bfloat16) for _ in range(3))
    before = fa_mod.launches
    out, lse = fa_mod._on_device(fa_mod.flash_attention_plain,
                                 fa_mod.flash_attention_cuda, q, k, v, True,
                                 None)
    return {"out_sum": out.sum(dtype=_torch.float64).item(),
            "lse_sum": lse.sum(dtype=_torch.float64).item(),
            "launches": fa_mod.launches - before, "pid": os.getpid()}


class ClusterReplica(ReplicaActor):
    """The runtime phase's Replica actor, taking batches that arrive from
    other nodes as host tensors."""

    def answer_host(self, batch):
        return self.answer(batch.to(DEVICE))


# A thin client of the client server, run in its own interpreter: argv is
# the rtpu:// address, remote node 1's id, the flash shape and seed, and
# the device. It prints one JSON line.
CLUSTER_CLIENT = r'''
import json, statistics, sys, time
import ray_tpu_torch as rt
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy as On)

def where():
    import os
    return os.getppid(), os.environ.get("CUDA_VISIBLE_DEVICES")

def noop():
    return None

class Counter:
    def __init__(self):
        self.n = 0
    def incr(self):
        self.n += 1
        return self.n

addr, node1, shape, seed, device = (sys.argv[1], sys.argv[2],
                                    json.loads(sys.argv[3]),
                                    int(sys.argv[4]), sys.argv[5])
flash = __import__("chip_smoke")._client_flash
out = {}
rt.init(address=addr)
out["on_node1"] = rt.get(rt.remote(where).options(
    scheduling_strategy=On(node1, soft=False)).remote(), timeout=300)
out["flash"] = rt.get(rt.remote(num_gpus=1)(flash).remote(
    tuple(shape), seed, device), timeout=600)
task = rt.remote(noop)
rt.get(task.remote(), timeout=300)
rounds = []
for _ in range(int(sys.argv[6])):
    t0 = time.perf_counter()
    rt.get(task.remote(), timeout=60)
    rounds.append(time.perf_counter() - t0)
out["empty_task_s"] = statistics.median(rounds)
rt.remote(Counter).options(name="p17_counter", lifetime="detached",
                           num_cpus=1).remote()
h = rt.get_actor("p17_counter")
out["counter_a"] = [rt.get(h.incr.remote(), timeout=300) for _ in range(2)]
rt.shutdown()
rt.init(address=addr)
h = rt.get_actor("p17_counter")
out["counter_b"] = rt.get(h.incr.remote(), timeout=300)
rt.kill(h)
rt.shutdown()
print(json.dumps(out))
'''


def _wait_until(cond, what, timeout=CLUSTER_WAIT_S, interval=0.05):
    deadline = time.perf_counter() + timeout
    while True:
        value = cond()
        if value:
            return value
        check(time.perf_counter() < deadline, f"cluster: timed out waiting "
              f"for {what}")
        time.sleep(interval)


def _children(pids):
    """Pids of the live processes whose parent is one of ``pids``."""
    out = set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid in pids:
            out.add(int(entry))
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode()[:200]
    except OSError:
        return "?"


def _df(path):
    st = os.statvfs(path)
    return {"path": path, "free_bytes": st.f_bavail * st.f_frsize,
            "total_bytes": st.f_blocks * st.f_frsize}


def _data_stack():
    """Whether pyarrow and pandas import here, each in a fresh
    interpreter: a version or the ImportError."""
    out = {}
    for name in ("pyarrow", "pandas"):
        run = subprocess.run(
            [sys.executable, "-c", f"import {name}; print({name}.__version__)"],
            capture_output=True, text=True, timeout=300)
        out[name] = (run.stdout.strip() if run.returncode == 0 else
                     (run.stderr.strip().splitlines() or ["?"])[-1])
    return out


def _pulled_bytes(w, nid):
    """The bytes a remote raylet's transfer plane has pulled, from its
    latest heartbeat."""
    report = w.node_stats.get(nid)
    if report is None:
        return 0
    return report[1].get("wire", {}).get("object_transfer", {}).get(
        "bytes", 0)


def cluster_topology(rt, cluster, w):
    """(a) Two remote raylets that see no card join the head."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as On)
    nodes, spawn_s = {}, {}
    for name in ("n1", "n2"):
        t0 = time.perf_counter()
        nodes[name] = cluster.add_node(num_cpus=CLUSTER_REMOTE_CPUS,
                                       remote=True,
                                       resources={"remote": 100})
        spawn_s[name] = time.perf_counter() - t0
    want = CLUSTER_HEAD_CPUS + 2 * CLUSTER_REMOTE_CPUS
    t0 = time.perf_counter()
    resources = _wait_until(
        lambda: (lambda r: r if r.get("CPU") == want and r.get("GPU") == 1
                 else None)(rt.cluster_resources()),
        f"{want} CPUs and 1 GPU")
    visible_s = time.perf_counter() - t0
    raylet_pid = {name: w.node_group._remote_nodes[nid].proc.pid
                  for name, nid in nodes.items()}
    where = rt.remote(_where)
    first_s, again_s = {}, {}
    for name, nid in nodes.items():
        pinned = where.options(scheduling_strategy=On(nid.hex(), soft=False))
        t0 = time.perf_counter()
        ppid, visible = rt.get(pinned.remote(), timeout=300)
        first_s[name] = time.perf_counter() - t0
        check(ppid == raylet_pid[name] and visible == "",
              f"cluster: a task pinned to {name} ran under pid {ppid} "
              f"(raylet {raylet_pid[name]}) seeing CUDA_VISIBLE_DEVICES="
              f"{visible!r}")
        t0 = time.perf_counter()
        rt.get(pinned.remote(), timeout=300)
        again_s[name] = time.perf_counter() - t0
    # Each remote worker loads torch before the transfers are timed: the
    # first tensor a worker unpickles costs that import.
    warm = rt.remote(_import_torch)
    import_s = {name: rt.get([warm.options(scheduling_strategy=On(
        nid.hex(), soft=False)).remote(1.0)
        for _ in range(CLUSTER_REMOTE_CPUS)], timeout=300)
        for name, nid in nodes.items()}
    try:
        cluster.add_node(num_cpus=1, num_gpus=1, remote=True)
        refused = False
    except ValueError:
        refused = True
    check(refused, "cluster: add_node(remote=True, num_gpus=1) did not raise")
    print(f"cluster: raylets spawned and registered in {spawn_s} s, "
          f"resources {resources} after {visible_s:.3f} s more; a pinned "
          f"task's first round trip {first_s} s (a worker's start), the "
          f"next {again_s} s; torch loaded in the remote workers in "
          f"{import_s} s; a remote node with a GPU refused")
    return nodes, raylet_pid, {
        "spawn_to_registration_s": spawn_s, "resources": resources,
        "first_task_s": first_s, "next_task_s": again_s,
        "worker_torch_import_s": import_s,
        "remote_gpu_node_refused": refused}


def cluster_objects(rt, w, nodes):
    """(b) 64 MB across nodes both ways, summed exactly."""
    from ray_tpu_torch._private import wire_stats
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as On)
    nbytes = CLUSTER_XFER_ELEMS * 8
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t = torch.randint(0, 1 << 20, (CLUSTER_XFER_ELEMS,), generator=gen,
                      device=DEVICE, dtype=torch.int64)
    card_sum = int(t.sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.cpu()
    d2h_s = time.perf_counter() - t0
    copies = []
    host_copy = w._ensure_host_copy

    def timed_host_copy(oid):
        t0 = time.perf_counter()
        out = host_copy(oid)
        copies.append(time.perf_counter() - t0)
        return out

    w._ensure_host_copy = w.node_group._ensure_host_copy_cb = timed_host_copy
    try:
        before_n1 = _pulled_bytes(w, nodes["n1"])
        ref = rt.put(t)
        t0 = time.perf_counter()
        got = rt.get(rt.remote(_tensor_sum).options(
            scheduling_strategy=On(nodes["n1"].hex(), soft=False)).remote(
                ref), timeout=300)
        out_s = time.perf_counter() - t0
    finally:
        w._ensure_host_copy = w.node_group._ensure_host_copy_cb = host_copy
    check(got == {"type": "Tensor", "device": "cpu", "sum": card_sum},
          f"cluster: node 1 saw {got}, the card's sum is {card_sum}")
    pulled_n1 = _wait_until(
        lambda: (lambda b: b if b - before_n1 >= nbytes else None)(
            _pulled_bytes(w, nodes["n1"])), "node 1's pull counters") \
        - before_n1
    del ref

    arr_ref = rt.remote(_make_array).options(
        scheduling_strategy=On(nodes["n2"].hex(), soft=False)).remote(
            CLUSTER_XFER_ELEMS, SEED)
    rt.wait([arr_ref], num_returns=1, timeout=300)
    driver_before = wire_stats.snapshot().get("object_transfer", {}).get(
        "bytes", 0)
    t0 = time.perf_counter()
    total, on_card_s = rt.get(rt.remote(num_gpus=1)(_card_sum).remote(
        arr_ref, DEVICE), timeout=300)
    in_s = time.perf_counter() - t0
    pulled_head = wire_stats.snapshot().get("object_transfer", {}).get(
        "bytes", 0) - driver_before
    want = int(np.sum(_make_array(CLUSTER_XFER_ELEMS, SEED)))
    check(total == want, f"cluster: the card's sum of node 2's array is "
          f"{total}, numpy's {want}")
    check(pulled_head >= nbytes, f"cluster: the head pulled {pulled_head} "
          f"bytes of node 2's {nbytes}-byte array")
    del arr_ref
    host_copy_s = sum(copies)
    print(f"cluster: 64 MB head -> node 1 in {out_s:.4f} s "
          f"({nbytes / out_s / 1e9:.3f} GB/s; the host copy {copies} s, of "
          f"which a device-to-host copy takes {d2h_s:.4f} s; the rest "
          f"{out_s - host_copy_s:.4f} s), node 1 pulled {pulled_n1} bytes; "
          f"node 2 -> head in {in_s:.4f} s ({nbytes / in_s / 1e9:.3f} GB/s, "
          f"of which the move to the card and its sum {on_card_s:.4f} s), "
          f"the head pulled {pulled_head} bytes; both sums exact")
    return {"bytes": nbytes,
            "head_to_remote": {"s": out_s, "gb_per_s": nbytes / out_s / 1e9,
                               "host_copy_s": copies, "d2h_copy_s": d2h_s,
                               "rest_s": out_s - host_copy_s,
                               "pulled_bytes": pulled_n1},
            "remote_to_head": {"s": in_s, "gb_per_s": nbytes / in_s / 1e9,
                               "to_card_and_sum_s": on_card_s,
                               "pulled_bytes": pulled_head},
            "sums_exact": True}


def cluster_batch(rt, actor, batch_ref, i, direct, what):
    """One replica batch from a ref made on a remote node: 8 forward
    launches, answers bit for bit the serving phase's batch ``i``."""
    cfg = flagship_config()
    counts = launch_counts()
    t0 = time.perf_counter()
    reply = rt.get(actor.answer_host.remote(batch_ref), timeout=600)
    latency = time.perf_counter() - t0
    per_batch = tuple(a - b for a, b in zip(launch_counts(), counts))
    check(per_batch == (cfg.n_layers, 0, 0),
          f"cluster {what}: (fwd, dQ, dK/dV) launches {per_batch}, "
          f"expected ({cfg.n_layers}, 0, 0)")
    check_answers(reply["answers"],
                  direct["answers"][i * BATCH:(i + 1) * BATCH],
                  direct["logits_gap_bf16_fp32"], f"cluster {what}", True)
    return latency, reply["forward_s"]


def cluster_serve(rt, nodes, direct):
    """(c) The flagship on the head answers batches cut on the remote
    nodes."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as On)
    actor = rt.remote(num_gpus=1)(ClusterReplica).options(
        name="p17_replica").remote()
    rt.get(actor.ready.remote(), timeout=600)
    requests = direct["requests"]
    req_ref = rt.put(requests)
    cut = rt.remote(_cut_batch)
    batch_refs = [cut.options(scheduling_strategy=On(
        nodes[f"n{i + 1}"].hex(), soft=False)).remote(req_ref, i, BATCH)
        for i in range(N_REQUESTS // BATCH)]
    for i, ref in enumerate(batch_refs):
        got = rt.get(ref, timeout=300)
        check(torch.equal(got.to(DEVICE),
                          requests[i * BATCH:(i + 1) * BATCH]),
              f"cluster: batch {i} cut on node {i + 1} differs from the "
              f"serving phase's")
    latencies, forward_s = [], []
    for i, ref in enumerate(batch_refs):
        lat, fwd = cluster_batch(rt, actor, ref, i, direct, f"batch {i}")
        latencies.append(lat)
        forward_s.append(fwd)
    print(f"cluster: the replica's batch latency {latencies} s (the "
          f"forward {forward_s} s; direct {direct['latency_s']} s), answers "
          f"bit for bit the serving phase's")
    return actor, req_ref, batch_refs, {
        "batch_latency_s": latencies, "forward_in_actor_s": forward_s,
        "direct_batch_latency_s": direct["latency_s"],
        "bit_equal_direct": True}


def cluster_node_loss(rt, cluster, w, nodes, raylet_pid, actor, batch_refs,
                      direct, track):
    """(d) Node 2 killed mid-burst; ``track()`` notes the processes that
    run before the kill."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as On)
    cpus_before = rt.cluster_resources()["CPU"]
    lost = rt.remote(_make_array).options(
        scheduling_strategy=On(nodes["n2"].hex(), soft=True)).remote(
            CLUSTER_LOST_ELEMS, SEED + 3)
    rt.wait([lost], num_returns=1, timeout=300)
    removed = {}
    n2 = nodes["n2"]

    def on_node(msg):
        if msg[0] == "REMOVED":
            removed.setdefault(msg[1], time.perf_counter())

    w.gcs.publisher.subscribe("NODE", on_node)
    burst = rt.remote(num_cpus=1, resources={"remote": 1})(_burst_task)
    t0 = time.perf_counter()
    refs = [burst.options(scheduling_strategy=_Spread()).remote(
        i, CLUSTER_BURST_S) for i in range(CLUSTER_BURST)]
    rt.wait(refs, num_returns=CLUSTER_KILL_AFTER, timeout=300)
    track()
    before_kill = sum(1 for r in refs if w.memory_store.contains(r.id()))
    t_kill = time.perf_counter()
    cluster.kill_raylet_process(n2)
    reply_during = rt.get(actor.answer_host.remote(batch_refs[0]),
                          timeout=600)
    results = rt.get(refs, timeout=600)
    burst_s = time.perf_counter() - t0
    check([v for v, _ in results] == [i * i for i in range(CLUSTER_BURST)],
          "cluster: a burst result is wrong")
    placed = {name: sum(1 for _, p in results if p == pid)
              for name, pid in raylet_pid.items()}
    check_answers(reply_during["answers"], direct["answers"][:BATCH],
                  direct["logits_gap_bf16_fp32"],
                  "cluster batch during recovery", True)
    _wait_until(lambda: n2 in removed, "the GCS to declare node 2 dead")
    notice_s = removed[n2] - t_kill
    _wait_until(lambda: rt.cluster_resources()["CPU"]
                == cpus_before - CLUSTER_REMOTE_CPUS,
                "node 2's CPUs to leave the cluster")
    recon_before = w.task_manager.num_reconstructions
    t0 = time.perf_counter()
    value = rt.get(lost, timeout=600)
    rebuild_s = time.perf_counter() - t0
    check(np.array_equal(value, _make_array(CLUSTER_LOST_ELEMS, SEED + 3)),
          "cluster: the rebuilt 16 MB object differs")
    rebuilt = w.task_manager.num_reconstructions - recon_before
    check(rebuilt >= 1, "cluster: node 2's object was not rebuilt by lineage")
    print(f"cluster: node 2 killed after {before_kill} of {CLUSTER_BURST} "
          f"burst tasks; all {CLUSTER_BURST} right in {burst_s:.3f} s "
          f"(placed {placed}, the rest retried); the GCS declared it dead "
          f"{notice_s:.3f} s after the kill; CPUs {cpus_before} -> "
          f"{rt.cluster_resources()['CPU']}; its 16 MB object rebuilt in "
          f"{rebuild_s:.3f} s ({rebuilt} reconstruction); a batch sent "
          f"during the recovery bit for bit")
    return {"done_before_kill": before_kill, "burst_s": burst_s,
            "placed": placed, "kill_to_death_notice_s": notice_s,
            "cpus": [cpus_before, rt.cluster_resources()["CPU"]],
            "lost_object_rebuild_s": rebuild_s, "reconstructions": rebuilt,
            "batch_during_recovery_bit_equal": True}


def cluster_gcs_restart(rt, w, nodes, req_ref, direct):
    """(e) The GCS process killed and restarted on its old port."""
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch._private.gcs_server import spawn_gcs_process
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as On)
    old_addr, old = tuple(w.gcs_address), w._gcs_proc
    old.kill()
    old.wait(timeout=30)
    t_restart = time.time()
    t0 = time.perf_counter()
    proc, addr = spawn_gcs_process(w.session, get_config().serialize(),
                                   persist=True, port=old_addr[1])
    w._gcs_proc = proc
    check(tuple(addr) == old_addr, f"cluster: the GCS came back on {addr}, "
          f"not {old_addr}")
    _wait_until(lambda: w.node_reports.get(nodes["n1"], (0,))[0] > t_restart,
                "node 1 to report through the restarted GCS")
    reregister_s = time.perf_counter() - t0
    alive = {n.node_id: n.alive for n in w.gcs.get_all_node_info()}
    check(alive.get(nodes["n1"]) is True, "cluster: node 1 is not alive in "
          "the restarted GCS")
    again = rt.get_actor("p17_replica")
    ref = rt.remote(_cut_batch).options(scheduling_strategy=On(
        nodes["n1"].hex(), soft=False)).remote(req_ref, 1, BATCH)
    lat, _ = cluster_batch(rt, again, ref, 1, direct, "batch after the GCS "
                           "restart")
    print(f"cluster: GCS killed and restarted; node 1 re-registered "
          f"{reregister_s:.3f} s after the restart; the named replica "
          f"found; a task pinned to node 1 ran; a batch {lat:.4f} s, bit "
          f"for bit")
    return {"restart_to_reregistration_s": reregister_s,
            "batch_latency_s": lat, "bit_equal_direct": True}


def start_client_server(w):
    """Start the port's client server, joined to the cluster's GCS with
    ``--num-gpus 1``; returns the process, its address file, its
    environment and its start time."""
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch._private.session_dir import session_dir
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + env.get("PYTHONPATH", "").split(os.pathsep))
    env["RTPU_SESSION_TOKEN"] = rpc.get_session_token()
    port_file = session_dir(w.session, "client_server.addr")
    host, port = w.gcs_address
    log = open(session_dir(w.session, "client_server.log"), "ab")
    t0 = time.perf_counter()
    server = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.client_server",
         "--address", f"{host}:{port}", "--port-file", port_file,
         "--config", get_config().serialize(), "--num-gpus", "1"],
        env=env, start_new_session=True, stdout=log, stderr=log)
    log.close()
    return server, port_file, env, t0


def cluster_client(nodes, local, server, port_file, env, t0):
    """(f) A thin ``rtpu://`` client through the port's client server
    (``server``, started at ``t0``); its flash forward held against
    ``local``, the same call in this process."""
    _wait_until(lambda: os.path.exists(port_file)
                or server.poll() is not None, "the client server")
    check(server.poll() is None, f"cluster: the client server exited "
          f"({server.returncode})")
    start_s = time.perf_counter() - t0
    addr = "rtpu://" + open(port_file).read().strip()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", CLUSTER_CLIENT, addr, nodes["n1"].hex(),
         json.dumps(CLIENT_ATTN), str(SEED), DEVICE, str(CLUSTER_PINGS)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=900)
    client_s = time.perf_counter() - t0
    check(run.returncode == 0, f"cluster: the client failed: "
          f"{run.stderr[-2000:]}")
    got = json.loads(run.stdout.strip().splitlines()[-1])
    flash = got["flash"]
    check(flash["pid"] == server.pid, f"cluster: the client's GPU task ran "
          f"in pid {flash['pid']}, not the client server {server.pid}")
    check(flash["out_sum"] == local["out_sum"]
          and flash["lse_sum"] == local["lse_sum"],
          f"cluster: the client's flash forward {flash} differs from this "
          f"process's {local}")
    check(flash["launches"] == local["launches"],
          f"cluster: {flash['launches']} forward launches in the client "
          f"server, {local['launches']} here")
    check(got["on_node1"][1] == "", "cluster: node 1's worker sees a card")
    check(got["counter_a"] == [1, 2] and got["counter_b"] == 3,
          f"cluster: the detached counter read {got['counter_a']} then "
          f"{got['counter_b']}")
    print(f"cluster: client server up in {start_s:.3f} s; the thin "
          f"client's run {client_s:.3f} s: a task on node 1, the flash "
          f"forward in the client server (pid {flash['pid']}, "
          f"{flash['launches']} launch) bit for bit this process's, the "
          f"detached counter {got['counter_a']} then {got['counter_b']} "
          f"across connections; an empty task round trip "
          f"{got['empty_task_s']:.6f} s (median of {CLUSTER_PINGS})")
    return {"server_start_s": start_s, "client_run_s": client_s,
            "flash": flash, "flash_local": local,
            "empty_task_s": got["empty_task_s"],
            "detached_counter": [*got["counter_a"], got["counter_b"]]}


def phase_cluster(direct, card):
    """Phase 17: the head (this process, the card's owner) with the GCS in
    its own process, two remote raylets that see no card, the flagship
    served from batches cut on them, a node lost and the GCS restarted
    while it serves, and a thin client through the client server."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    t_phase = time.perf_counter()
    tmp = tempfile.gettempdir()
    disks = [_df(tmp), _df("/dev/shm")]
    print(f"cluster: disk {disks}")
    data_stack = _data_stack()
    print(f"cluster: Data's stack on this machine: {data_stack}")
    # what the client's forward is held to: the same call here, made
    # before the phase's launch counts start
    local = _client_flash(CLIENT_ATTN, SEED, DEVICE)
    baseline = card_bytes_without_workspaces()
    torch.cuda.empty_cache()
    card_free = torch.cuda.mem_get_info()[0]
    reset_launch_counts()
    reset_scheduler_launch_counts()
    cluster = Cluster(head_num_cpus=CLUSTER_HEAD_CPUS, num_gpus=1,
                      start_gcs=True,
                      _system_config={"gcs_mode": "process"})
    w = cluster.worker
    session = w.session
    procs, pids, server = [], set(), None
    out = {"disk": disks, "data_stack": data_stack}

    def track():
        """Note the processes of the run: the raylets' and the client
        server's workers, and the head's."""
        segment_owners(w, pids)
        pids.update(_children({p.pid for p in procs if p.poll() is None}))

    try:
        procs.append(w._gcs_proc)
        nodes, raylet_pid, out["topology"] = cluster_topology(rt, cluster, w)
        procs += [w.node_group._remote_nodes[nid].proc
                  for nid in nodes.values()]
        out["objects"] = cluster_objects(rt, w, nodes)
        actor, req_ref, batch_refs, out["serve"] = cluster_serve(
            rt, nodes, direct)
        out["node_loss"] = cluster_node_loss(rt, cluster, w, nodes,
                                             raylet_pid, actor, batch_refs,
                                             direct, track)
        out["gcs_restart"] = cluster_gcs_restart(rt, w, nodes, req_ref,
                                                 direct)
        procs.append(w._gcs_proc)
        server, *started = start_client_server(w)
        procs.append(server)
        out["client"] = cluster_client(nodes, local, server, *started)
        track()
        rt.kill(actor)
        del actor, req_ref, batch_refs
    finally:
        t0 = time.perf_counter()
        if server is not None:
            server.terminate()
            try:
                server.wait(timeout=60)
            except subprocess.TimeoutExpired:
                server.kill()
        cluster.shutdown()
        teardown_s = time.perf_counter() - t0
    # what the runtime held (the replica on a driver thread among it) goes
    # with the last references to it
    del track, w, cluster
    launches = launch_counts()
    check(launches[1:] == (0, 0), "cluster: a backward kernel launched")
    for proc in procs:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            pass
    def running():
        return ([p.pid for p in procs if p.poll() is None]
                + [pid for pid in sorted(pids - {os.getpid()})
                   if _alive(pid)])

    deadline = time.perf_counter() + RUNTIME_FREE_WAIT_S
    while running() and time.perf_counter() < deadline:
        time.sleep(0.1)
    left_procs = {pid: _cmdline(pid) for pid in running()}
    check(not left_procs, f"cluster: processes still running after "
          f"teardown: {left_procs}")
    left = wait_freed(baseline, "cluster")

    def card_free_now():
        torch.cuda.empty_cache()
        return torch.cuda.mem_get_info()[0]

    deadline = time.perf_counter() + RUNTIME_FREE_WAIT_S
    while (card_free_now() < card_free - RUNTIME_FREE_SLACK
           or segments_left(session, pids)) \
            and time.perf_counter() < deadline:
        time.sleep(0.1)
    card_free_after = card_free_now()
    check(card_free_after >= card_free - RUNTIME_FREE_SLACK,
          f"cluster: the card has {card_free_after} bytes free after the "
          f"phase, {card_free} before")
    segments = segments_left(session, pids)
    check(not segments, f"cluster: segments left in /dev/shm: "
          f"{segments[:8]} ({len(segments)})")
    strays = []
    if os.path.realpath(tmp) != "/tmp":
        strays = sorted(f for f in os.listdir("/tmp")
                        if f.startswith(f"rtpt_{session}"))
    check(not strays, f"cluster: {strays} left in /tmp")
    sched = scheduler_launches_by_name()
    client_launches = out["client"]["flash"]["launches"]
    wall_s = time.perf_counter() - t_phase
    print(f"cluster: teardown {teardown_s:.3f} s; no process, segment or "
          f"card memory left ({left} bytes of this process, card free "
          f"{card_free_after} of {card_free} before); launches here "
          f"{launches}, in the client server {client_launches}; scheduler "
          f"{sched}; the phase took {wall_s:.3f} s ({card})")
    out.update({"launches": {"flash_fwd": launches[0] + client_launches,
                             "flash_bwd_dq": launches[1],
                             "flash_bwd_dkv": launches[2]},
                "head_flash_fwd": launches[0],
                "client_flash_fwd": client_launches,
                "scheduler_launches": sched, "teardown_s": teardown_s,
                "left_bytes": left, "wall_s": wall_s})
    return out


# -- Data, Tune and sharded checkpoints ---------------------------------------

DATA_BLOCK_ROWS = 4                   # phase 6's requests: 2 blocks of 4 rows
DATA_TRAIN_REPEATS = 3                # phase 7's batch, 3 times: 12 rows
SHUFFLE_ROWS = 8 << 20                # int64: 64 MB
SHUFFLE_BLOCKS = 16
TUNE_LRS = (1e-4, 3e-4, 1e-3, 3e-3)   # the grid of peak learning rates
TUNE_STEPS = 3
TUNE_WARMUP = 1                       # the sweep's schedule: lr from step 1
TUNE_CONTEXT = {}                     # the tokens the trials train on


def _counts():
    """Flash and scheduler launch counters, read together."""
    return launch_counts() + scheduler_launch_counts()


def _launch_delta(before):
    """Launches since ``before`` (a ``_counts()``): the flash kernels'
    and the scheduler kernels' by name."""
    now = _counts()
    diff = [a - b for a, b in zip(now, before)]
    return dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                    + SCHEDULER_KERNELS, diff))


def _add_launches(*parts):
    out = {}
    for part in parts:
        for key, n in part.items():
            out[key] = out.get(key, 0) + n
    return out


class FlagshipPredictor:
    """Phase 18 (a)'s ``map_batches`` class on a ``num_gpus=1`` actor: the
    flagship from seed 0 on the card, answering each batch of token rows
    as phase 6's ``Replica`` does (greedy next token and the head of the
    last-position logits), with the launches of its forward and where it
    ran."""

    def __init__(self):
        self.cfg = flagship_config()
        self.params = tfm.init_params(self.cfg, seed=SEED, device=DEVICE)
        torch.cuda.synchronize()
        self.pid, self.thread = os.getpid(), threading.get_ident()

    def __call__(self, batch):
        tokens = torch.from_numpy(np.require(batch["tokens"],
                                             requirements="W")).to(DEVICE)
        before = launch_counts()
        with torch.inference_mode():
            logits = tfm.forward(self.params, tokens, self.cfg)
        last = logits[:, -1]
        out = {"next_token": last.argmax(dim=-1),
               "logits_head": last[:, :4].float()}
        torch.cuda.synchronize()
        n = len(tokens)
        launches = [a - b for a, b in zip(launch_counts(), before)]
        return {**out, "checksum": batch["checksum"],
                "cpu_pid": batch["cpu_pid"],
                "launches": np.tile(np.asarray(launches), (n, 1)),
                "pid": np.full(n, os.getpid()),
                "thread": np.full(n, threading.get_ident()),
                "built_in": np.full(n, self.pid)}


def data_inference(rt, rdata, data_stats, direct, card):
    """(a) Phase 6's requests through a CPU stage and the predictor."""
    cfg = flagship_config()
    rows = direct["requests"].cpu().numpy()
    checksums = rows.sum(axis=1)
    baseline = card_bytes_without_workspaces()
    before_stats = data_stats.snapshot()
    before = _counts()
    t0 = time.perf_counter()
    n_blocks = len(rows) // DATA_BLOCK_ROWS
    ds = rdata.from_items([{"tokens": r} for r in rows],
                          parallelism=n_blocks)
    ds = ds.map_batches(
        lambda b: {"tokens": b["tokens"],
                   "checksum": b["tokens"].sum(axis=1),
                   "cpu_pid": np.full(len(b["tokens"]), os.getpid())})
    ds = ds.map_batches(FlagshipPredictor, batch_size=BATCH, concurrency=1,
                        num_gpus=1)
    got = list(ds.iter_rows())
    wall_s = time.perf_counter() - t0
    launches = _launch_delta(before)
    stats = {k: v - before_stats[k]
             for k, v in data_stats.snapshot().items()}
    answers = [{"next_token": int(r["next_token"]),
                "logits_head": [float(x) for x in r["logits_head"]]}
               for r in got]
    check_answers(answers, direct["answers"], direct["logits_gap_bf16_fp32"],
                  "data: batch inference", bit_equal=True)
    check([int(r["checksum"]) for r in got] == checksums.tolist(),
          "data: the CPU stage's checksums differ from numpy's")
    per_batch = {tuple(int(x) for x in r["launches"]) for r in got}
    check(per_batch == {(cfg.n_layers, 0, 0)},
          f"data: (fwd, dQ, dK/dV) launches a batch {per_batch}")
    check((launches["flash_fwd"], launches["flash_bwd_dq"],
           launches["flash_bwd_dkv"])
          == (cfg.n_layers * len(rows) // BATCH, 0, 0),
          f"data: launches {launches} for {len(rows) // BATCH} batches")
    check({int(r["pid"]) for r in got} == {os.getpid()}
          and {int(r["built_in"]) for r in got} == {os.getpid()}
          and threading.get_ident() not in {int(r["thread"]) for r in got},
          "data: the predictor did not run on a thread of the driver")
    check(os.getpid() not in {int(r["cpu_pid"]) for r in got},
          "data: the CPU stage ran in the driver, not in a process worker")
    check(stats["blocks_produced"] == 2 * n_blocks
          and stats["blocks_consumed"] == n_blocks,
          f"data: blocks produced {stats['blocks_produced']}, consumed "
          f"{stats['blocks_consumed']}; expected {2 * n_blocks} and "
          f"{n_blocks}")
    del ds
    left = wait_freed(baseline, "the consumed dataset's predictor")
    out = {"rows": len(rows), "blocks": n_blocks, "wall_s": wall_s,
           "rows_per_s": len(rows) / wall_s,
           "direct_batch_latency_s": direct["latency_s"],
           "direct_rows_per_s": len(rows) / sum(direct["latency_s"]),
           "bit_equal_direct": True, "blocks_produced":
           stats["blocks_produced"], "blocks_consumed":
           stats["blocks_consumed"], "left_after_bytes": left,
           "launches": launches}
    print(f"data (a) ({card}): {len(rows)} rows in {n_blocks} blocks through "
          f"a CPU stage and the num_gpus=1 predictor in {wall_s:.3f} s "
          f"({out['rows_per_s']:.2f} rows/s; phase 6's direct batches "
          f"{direct['latency_s']} s, {out['direct_rows_per_s']:.2f} rows/s); "
          f"answers bit for bit phase 6's; launches {launches}; blocks "
          f"produced {stats['blocks_produced']}, consumed "
          f"{stats['blocks_consumed']}; {left} bytes left")
    return out


def data_flagship_loop(config):
    """Phase 18 (b)'s user loop, on the gang's one worker (a thread of the
    driver): the seed-0 TrainState, one step per batch of its dataset
    shard, each batch moved to the card; one report a step with the
    seconds the loop waited on the shard's iterator."""
    train = importlib.import_module("ray_tpu_torch.train")
    cfg = flagship_config()
    tx = trn.make_optimizer(total_steps=1000)
    state = trn.init_state(cfg, tx, seed=SEED, device=DEVICE)
    step = trn.make_train_step(cfg, tx)
    batches = iter(train.get_dataset_shard("train").iter_batches(
        batch_size=BATCH))
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        wait_s = time.perf_counter() - t0
        if batch is None:
            break
        tokens = torch.from_numpy(np.require(batch["tokens"],
                                             requirements="W")).to(DEVICE)
        counts = launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        train.report({"step": int(metrics["step"]),
                      "loss": metrics["loss"].item(),
                      "grad_norm": metrics["grad_norm"].item(),
                      "step_s": time.perf_counter() - t0, "wait_s": wait_s,
                      "launches": [a - b for a, b in zip(launch_counts(),
                                                         counts)],
                      "tokens_equal": bool(torch.equal(tokens,
                                                       config["tokens"]))})


def data_trainer(rt, rdata, tokens, trained, scratch, card):
    """(b) Phase 7's batch, three times, feeding a one-worker trainer; then
    ``iter_device_batches`` over the same Dataset."""
    train = importlib.import_module("ray_tpu_torch.train")
    cfg = flagship_config()
    rows = tokens.cpu().numpy()
    ds = rdata.from_items([{"tokens": r} for r in rows] * DATA_TRAIN_REPEATS,
                          parallelism=DATA_TRAIN_REPEATS)
    baseline = card_bytes_without_workspaces()
    before = _counts()
    t0 = time.perf_counter()
    res = train.DataParallelTrainer(
        data_flagship_loop, train_loop_config={"tokens": tokens},
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(name="data_fed",
                                   storage_path=os.path.join(scratch,
                                                             "results")),
        datasets={"train": ds}).fit()
    fit_s = time.perf_counter() - t0
    launches = _launch_delta(before)
    check(res.error is None, f"data: the fit failed: {res.error!r}")
    hist = res.metrics_history
    gang = trained["flagship"]
    check(len(hist) == DATA_TRAIN_REPEATS,
          f"data: {len(hist)} reports, expected {DATA_TRAIN_REPEATS}")
    bit_equal = True
    for i, m in enumerate(hist):
        check(m["step"] == i and m["tokens_equal"],
              f"data: report {i}: step {m['step']}, tokens equal to phase "
              f"7's {m['tokens_equal']}")
        check(tuple(m["launches"]) == (cfg.n_layers,) * 3,
              f"data: step {i}: launches {m['launches']}")
        for name, x, y in (("loss", m["loss"], gang["losses"][i]),
                           ("grad norm", m["grad_norm"],
                            gang["grad_norms"][i])):
            bit_equal = bit_equal and x == y
            check(math.isfinite(x) and abs(x - y) <= MESH_FIRST_LOSS_REL
                  * abs(y), f"data: step {i}: {name} {x}, phase 15's {y}")
    check(launches["flash_fwd"] == launches["flash_bwd_dq"]
          == launches["flash_bwd_dkv"] == cfg.n_layers * len(hist),
          f"data: the fit's launches {launches}")
    left = wait_freed(baseline, "the data-fed fit's gang")
    device_batches = 0
    for batch in ds.iter_device_batches(batch_size=BATCH, device=DEVICE):
        t = batch["tokens"]
        check(t.device == tokens.device and torch.equal(t, tokens),
              f"data: iter_device_batches gave {t.device} tokens unequal "
              f"to phase 7's")
        device_batches += 1
    check(device_batches == DATA_TRAIN_REPEATS,
          f"data: iter_device_batches gave {device_batches} batches")
    out = {"fit_s": fit_s, "losses": [m["loss"] for m in hist],
           "grad_norms": [m["grad_norm"] for m in hist],
           "bit_equal_phase15": bit_equal,
           "step_time_s": [m["step_s"] for m in hist],
           "iterator_wait_s": [m["wait_s"] for m in hist],
           "phase15_step_time_s": gang["step_time_s"],
           "device_batches": device_batches, "left_after_bytes": left,
           "launches": launches}
    print(f"data (b) ({card}): a {len(rows) * DATA_TRAIN_REPEATS}-row "
          f"Dataset fed the flagship's one-worker trainer: losses "
          f"{out['losses']} (phase 15 {gang['losses']}), bit for bit "
          f"{bit_equal}; step times {out['step_time_s']} s, waits on the "
          f"iterator {out['iterator_wait_s']} s; fit {fit_s:.2f} s; "
          f"launches {launches}; iter_device_batches gave {device_batches} "
          f"CUDA batches equal to phase 7's")
    return out


def data_shuffle(rt, rdata, data_stats, card):
    """(c) 64 MB of int64 shuffled and repartitioned on process workers."""
    metrics = importlib.import_module("ray_tpu_torch.util.metrics")
    n = SHUFFLE_ROWS
    t0 = time.perf_counter()
    ds = rdata.range(n).random_shuffle(seed=SEED).repartition(SHUFFLE_BLOCKS)
    count, total, blocks, head = 0, 0, 0, None
    for blk in ds.iter_blocks():
        ids = blk.column("id").to_numpy()
        if head is None and len(ids):
            head = ids[:16].tolist()
        count += len(ids)
        total += int(ids.sum())
        blocks += 1
    seconds = time.perf_counter() - t0
    check(count == n and total == n * (n - 1) // 2,
          f"data: the shuffle gave {count} rows summing to {total}")
    check(blocks == SHUFFLE_BLOCKS, f"data: {blocks} blocks after "
          f"repartition({SHUFFLE_BLOCKS})")
    check(head != list(range(16)), f"data: the shuffle kept the order "
          f"{head}")
    check(data_stats.queued_bytes_by_stage() == {}
          and "ray_tpu_data_queued_bytes{" not in metrics.prometheus_text(),
          "data: ray_tpu_data_queued_bytes is not back to 0")
    gbs = 8 * n / seconds / 1e9
    print(f"data (c) ({card}): random_shuffle + repartition({SHUFFLE_BLOCKS}) "
          f"of {8 * n} bytes in {seconds:.3f} s ({gbs:.3f} GB/s); count and "
          f"sum exact, order changed, queued bytes back to 0")
    return {"bytes": 8 * n, "seconds": seconds, "gb_per_s": gbs,
            "blocks": blocks}


def tune_flagship_trainable(config):
    """Phase 18 (d)'s trial: the seed-0 TrainState, TUNE_STEPS steps on
    phase 7's batch at the trial's peak learning rate, one report a step
    with the trial's own learning rate and where it ran."""
    tune = importlib.import_module("ray_tpu_torch.tune")
    cfg = flagship_config()
    tx = trn.make_optimizer(lr=config["lr"], warmup_steps=TUNE_WARMUP,
                            total_steps=1000)
    state = trn.init_state(cfg, tx, seed=SEED, device=DEVICE)
    step = trn.make_train_step(cfg, tx)
    tokens = TUNE_CONTEXT["tokens"]
    for _ in range(TUNE_STEPS):
        state, metrics = step(state, {"tokens": tokens})
        tune.report({"lr": config["lr"], "step": int(metrics["step"]),
                     "loss": metrics["loss"].item(),
                     "grad_norm": metrics["grad_norm"].item(),
                     "pid": os.getpid(), "thread": threading.get_ident()})


def tune_direct(tokens, lr):
    cfg = flagship_config()
    tx = trn.make_optimizer(lr=lr, warmup_steps=TUNE_WARMUP,
                            total_steps=1000)
    state = trn.init_state(cfg, tx, seed=SEED, device=DEVICE)
    step = trn.make_train_step(cfg, tx)
    losses = []
    for _ in range(TUNE_STEPS):
        state, metrics = step(state, {"tokens": tokens})
        losses.append(metrics["loss"].item())
    return losses


def phase_tune(rt, w, tokens, scratch, card):
    """(d) A Tuner sweep of the flagship's learning rate on two
    ``{"GPU": 0.5}`` trials at a time, against direct loops."""
    tune = importlib.import_module("ray_tpu_torch.tune")
    session_dir = importlib.import_module(
        "ray_tpu_torch._private.session_dir").session_dir(w.session)
    cfg = flagship_config()
    direct = {lr: tune_direct(tokens, lr) for lr in TUNE_LRS}
    torch.cuda.empty_cache()
    baseline = card_bytes_without_workspaces()
    TUNE_CONTEXT["tokens"] = tokens
    torch.cuda.reset_peak_memory_stats()
    before = _counts()
    t0 = time.perf_counter()
    grid = tune.Tuner(
        tune_flagship_trainable,
        param_space={"lr": tune.grid_search(list(TUNE_LRS))},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=2,
            trial_resources={"GPU": 0.5}),
        run_config=importlib.import_module("ray_tpu_torch.train").RunConfig(
            name="sweep", storage_path=os.path.join(scratch, "results"))
    ).fit()
    fit_s = time.perf_counter() - t0
    launches = _launch_delta(before)
    peak = torch.cuda.max_memory_allocated()
    TUNE_CONTEXT.clear()
    check(not grid.errors, f"tune: trial errors {grid.errors}")
    results = list(grid)
    check(len(results) == len(TUNE_LRS), f"tune: {len(results)} results")
    worst, bit_equal, threads = 0.0, True, set()
    for res in results:
        hist = res.metrics_history
        lr = hist[0]["lr"] if hist else None
        check(lr in direct and [m["lr"] for m in hist] == [lr] * TUNE_STEPS
              and [m["step"] for m in hist] == list(range(TUNE_STEPS)),
              f"tune: a trial's reports {[(m['lr'], m['step']) for m in hist]}"
              f" are not one trial's {TUNE_STEPS} steps")
        check({m["pid"] for m in hist} == {os.getpid()},
              "tune: a {\"GPU\": 0.5} trial ran outside the driver")
        threads.update(m["thread"] for m in hist)
        for m, want in zip(hist, direct[lr]):
            err = abs(m["loss"] - want) / abs(want)
            worst = max(worst, err)
            bit_equal = bit_equal and m["loss"] == want
            check(math.isfinite(m["loss"]) and err <= MESH_FIRST_LOSS_REL,
                  f"tune: lr {lr} step {m['step']}: loss {m['loss']}, the "
                  f"direct loop's {want}")
    best = grid.get_best_result()
    direct_best = min(TUNE_LRS, key=lambda lr: min(direct[lr]))
    check(best.metrics["lr"] == direct_best,
          f"tune: best trial lr {best.metrics['lr']}, the direct loops' "
          f"{direct_best}")
    n_steps = len(TUNE_LRS) * TUNE_STEPS
    check(launches["flash_fwd"] == launches["flash_bwd_dq"]
          == launches["flash_bwd_dkv"] == cfg.n_layers * n_steps,
          f"tune: launches {launches} over {n_steps} trial steps")
    check(threading.get_ident() not in threads,
          "tune: a trial ran on the driver's main thread")
    left = wait_freed(baseline, "the sweep's trials")
    stray = [d for d in os.listdir(session_dir) if d.startswith("rtpt_trial")]
    check(not stray, f"tune: trial dirs left {stray}")
    out = {"lrs": list(TUNE_LRS), "steps": TUNE_STEPS, "fit_s": fit_s,
           "losses": {str(r.metrics_history[0]["lr"]):
                      [m["loss"] for m in r.metrics_history]
                      for r in results},
           "direct_losses": {str(lr): v for lr, v in direct.items()},
           "loss_rel_err": worst, "bit_equal_direct": bit_equal,
           "best_lr": best.metrics["lr"], "peak_mem_bytes": peak,
           "trial_threads": len(threads), "left_after_bytes": left,
           "launches": launches}
    print(f"tune ({card}): {len(TUNE_LRS)} trials of {TUNE_STEPS} steps on "
          f"GPU 0.5, 2 at a time, in {fit_s:.2f} s; losses within {worst:.3g}"
          f" of direct loops (bit for bit {bit_equal}); best lr "
          f"{best.metrics['lr']} as the direct loops'; peak {peak} bytes "
          f"with two trials on the card; launches {launches}; {left} bytes "
          f"left, no trial dir left")
    return out


def _tree_equal(a, b):
    """Every leaf of two state trees equal bit for bit (DTensors by their
    blocks)."""
    DTensor = importlib.import_module("torch.distributed.tensor").DTensor
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    if isinstance(a, DTensor):
        return (isinstance(b, DTensor) and a.placements == b.placements
                and torch.equal(a.to_local(), b.to_local()))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def phase_checkpoint(trained, tokens, scratch, card):
    """(e) The seed-0 TrainState as DTensors on a world-size-1 mesh, saved
    asynchronously, stepped in place at once, restored and stepped
    again."""
    import torch.distributed as dist
    pmesh = importlib.import_module("ray_tpu_torch.parallel.mesh")
    ack = importlib.import_module("ray_tpu_torch.train.array_checkpoint")
    pytree = importlib.import_module("torch.utils._pytree")
    cfg = flagship_config()
    rendezvous = tempfile.mkdtemp(prefix="pg_", dir=scratch)
    free_before_pg = card_free_bytes()
    # training's usual group: NCCL alone; the save's own collectives run
    # on a gloo group that ``array_checkpoint`` makes
    dist.init_process_group(
        "nccl" if DEVICE == "cuda" else "gloo",
        init_method=f"file://{rendezvous}/pg", rank=0, world_size=1)
    before = _counts()
    try:
        mesh = pmesh.make_mesh(pmesh.MeshSpec.auto(1), device=DEVICE)
        tx = trn.make_optimizer(total_steps=1000)
        state = trn.init_state(cfg, tx, seed=SEED, device=DEVICE, mesh=mesh)
        step = trn.make_train_step(cfg, tx, mesh)
        tree = train_state_tree(state)
        state_bytes = sum(x.numel() * x.element_size()
                          for x in pytree.tree_leaves(tree)
                          if isinstance(x, torch.Tensor))
        disk = shutil.disk_usage(scratch)
        check(disk.free > 1.1 * state_bytes,
              f"checkpoint: {disk.free} bytes free under {scratch}, the "
              f"state is {state_bytes}")
        pre = pytree.tree_map(
            lambda x: x.detach().clone() if isinstance(x, torch.Tensor)
            else x, tree)
        path = os.path.join(scratch, "sharded")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = ack.save_sharded(path, tree, async_save=True)
        staged_s = time.perf_counter() - t0
        # one step at once: AdamW updates the saved tensors in place
        t1 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        first = (metrics["loss"].item(), metrics["grad_norm"].item())
        # (at step 0 the learning rate is 0: the moments move, in place)
        check(not _tree_equal(tree["mu"], pre["mu"]),
              "checkpoint: the step did not update the saved moments")
        handle.wait()
        write_s = time.perf_counter() - t0
        ckpt_bytes = dir_bytes(path)
        template = train_state_tree(state)
        t0 = time.perf_counter()
        restored = ack.restore_sharded(path, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(_tree_equal(restored, pre), "checkpoint: the restored state "
              "differs from the state at the call")
        del pre, template
        torch.cuda.empty_cache()
        again = trn.TrainState(
            step=restored["step"], params=restored["params"],
            opt_state=trn.AdamWState(count=restored["count"],
                                     mu=restored["mu"], nu=restored["nu"]))
        again, metrics = step(again, {"tokens": tokens})
        second = (metrics["loss"].item(), metrics["grad_norm"].item())
        check(second == first, f"checkpoint: a step from the restored "
              f"state gave {second}, the step taken gave {first}")
        check(_tree_equal(train_state_tree(again), train_state_tree(state)),
              "checkpoint: the restored state's step differs from the step "
              "taken")
        del state, again, restored, tree
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    # what the part's process group and save left outside torch's
    # allocator (NCCL's own buffers, if any stay)
    pg_held = free_before_pg - card_free_bytes()
    launches = _launch_delta(before)
    check(launches["flash_fwd"] == launches["flash_bwd_dq"]
          == launches["flash_bwd_dkv"] == 2 * cfg.n_layers,
          f"checkpoint: launches {launches} over 2 steps")
    gang = trained["flagship"]
    out = {"state_bytes": state_bytes, "ckpt_bytes": ckpt_bytes,
           "staged_s": staged_s, "step_s": step_s,
           "background_write_s": write_s, "restore_s": restore_s,
           "save_pytree_s": gang["save_s"], "load_pytree_s": gang["load_s"],
           "loss": first[0], "grad_norm": first[1],
           "restored_bit_equal": True, "step_bit_equal": True,
           "process_group_held_bytes": pg_held, "launches": launches}
    print(f"checkpoint ({card}): {state_bytes} bytes of DTensor state saved "
          f"async: returned after {staged_s:.2f} s (staged), written by "
          f"{write_s:.2f} s, {ckpt_bytes} bytes on disk; restored in "
          f"{restore_s:.2f} s; phase 15's save_pytree {gang['save_s']:.2f} s"
          f", load_pytree {gang['load_s']:.2f} s; the step taken during the "
          f"write and the step from the restored state bit for bit equal "
          f"(loss {first[0]!r}); launches {launches}")
    return out


def phase_data(direct, tokens, trained, card):
    """Phase 18: Data, Tune and sharded checkpoints on the card."""
    import ray_tpu_torch as rt
    t_phase = time.perf_counter()
    tmp = tempfile.gettempdir()
    disks = [_df(tmp), _df("/dev/shm")]
    rdata = importlib.import_module("ray_tpu_torch.data")
    stack = {name: importlib.import_module(name).__version__
             for name in ("pyarrow", "pandas")}
    print(f"data: disk {disks}; Data's stack {stack} ({card})")
    data_stats = importlib.import_module("ray_tpu_torch._private.data_stats")
    scratch = tempfile.mkdtemp(prefix="chip_smoke_data_")
    baseline = card_bytes_without_workspaces()
    card_free = card_free_bytes()
    # the card's free bytes after each part: where library state outside
    # torch's allocator, if any, stayed
    free_by_part = {}
    w = rt.init()
    session, pids = w.session, set()
    out = {"disk": disks, "data_stack": stack}
    try:
        for thread in list(tp._device_rt_threads.values()):
            thread.join(timeout=60)
        out["inference"] = data_inference(rt, rdata, data_stats, direct, card)
        free_by_part["inference"] = card_free_bytes()
        out["trainer"] = data_trainer(rt, rdata, tokens, trained, scratch,
                                      card)
        free_by_part["trainer"] = card_free_bytes()
        out["shuffle"] = data_shuffle(rt, rdata, data_stats, card)
        segment_owners(w, pids)
        free_by_part["shuffle"] = card_free_bytes()
        tuned = phase_tune(rt, w, tokens, scratch, card)
        segment_owners(w, pids)
    finally:
        segment_owners(w, pids)
        rt.shutdown()
    free_by_part["tune"] = card_free_bytes()
    checkpoint = phase_checkpoint(trained, tokens, scratch, card)
    free_by_part["checkpoint"] = card_free_bytes()
    shutil.rmtree(scratch, ignore_errors=True)

    # (f) teardown: the phase's tensors are gone, and the card's free
    # bytes, which also count library state outside torch's allocator
    # that a thread of a trial, a predictor or a gang worker could keep,
    # are back to where they were
    left = wait_freed(baseline, "phase 18")
    deadline = time.perf_counter() + RUNTIME_FREE_WAIT_S
    while (card_free_bytes() < card_free - RUNTIME_FREE_SLACK
           or segments_left(session, pids)) \
            and time.perf_counter() < deadline:
        time.sleep(0.1)
    card_free_after = card_free_bytes()
    free_by_part["teardown"] = card_free_after
    check(card_free_after >= card_free - RUNTIME_FREE_SLACK,
          f"data: the card has {card_free_after} bytes free after the "
          f"phase, {card_free} before (after each part: {free_by_part})")
    segments = segments_left(session, pids)
    check(not segments, f"data: segments left in /dev/shm: {segments[:8]}")
    strays = []
    if os.path.realpath(tmp) != "/tmp":
        strays = sorted(f for f in os.listdir("/tmp")
                        if f.startswith(f"rtpt_{session}"))
    check(not strays, f"data: {strays} left in /tmp")
    wall_s = time.perf_counter() - t_phase
    out["launches_by_part"] = {
        "data": _add_launches(out["inference"]["launches"],
                              out["trainer"]["launches"]),
        "tune": tuned["launches"], "checkpoint": checkpoint["launches"]}
    out["card_free_bytes"] = [card_free, card_free_after]
    out["card_free_by_part"] = free_by_part
    out["left_bytes"] = left
    out["wall_s"] = wall_s
    print(f"data: teardown: {left} bytes of the phase's tensors left; card "
          f"free {card_free_after} of {card_free} before (after each part "
          f"{free_by_part}; the checkpoint's process group and save left "
          f"{checkpoint['process_group_held_bytes']}); no segment left; the "
          f"phase took {wall_s:.3f} s ({card})")
    return out, tuned, checkpoint


# -- phase 19: DAGs, workflows, tracing, the autoscaler and the CLI ------

DAG_TIMED = 8                 # (a), (b): calls timed on each side
DAG_TRACED = 2                # (d): compiled executes under the trace
DAG_WAIT_S = 120.0
AUTOSCALE_IDLE_S = 1.0        # (e): the scaler's idle timeout
DAG_CONTEXT = {}              # the phase's flagship, read by its actors and
                              # its GPU workflow step on driver threads
JOB_SRC = r'''
import importlib, json, os, sys
import torch
import ray_tpu_torch as rt
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
device, (b, s, n, h) = sys.argv[1], json.loads(sys.argv[2])
rt.init(address=os.environ["RAY_TPU_ADDRESS"], num_cpus=1,
        max_process_workers=1)
pid = rt.get(rt.remote(os.getpid).remote(), timeout=120)
g = torch.Generator(device).manual_seed(0)
q, k, v = (torch.randn(b, s, n, h, device=device, dtype=torch.bfloat16,
                       generator=g) for _ in range(3))
before = fa.launches
with torch.inference_mode():
    o = fa.flash_attention(q, k, v, causal=True)
    launches = fa.launches - before
    ref, _ = fa.flash_attention_plain(q, k, v, causal=True)
diff = o.float() - ref.float()
print("job-flash", json.dumps({
    "task_pid": pid, "job_pid": os.getpid(), "launches": launches,
    "max_abs_err": diff.abs().max().item(),
    "rel_err": (diff.norm() / ref.float().norm()).item(),
    "resources": rt.cluster_resources()}), flush=True)
rt.shutdown()
'''


class PathLaunches:
    """Launches of a phase-19 path, summed over the ``with`` blocks that
    run it; the comparisons around them (a direct forward, the chained
    ``.remote`` calls) stay outside."""

    def __init__(self):
        self.total = _launch_delta(_counts())

    def __enter__(self):
        self._before = _counts()
        return self

    def __exit__(self, *exc):
        self.total = _add_launches(self.total, _launch_delta(self._before))
        return False


def _answers_of(logits):
    """What phase 6's Replica returns for a batch's logits."""
    last = logits[:, -1]
    return [{"next_token": t, "logits_head": hd}
            for t, hd in zip(last.argmax(dim=-1).tolist(),
                             last[:, :4].tolist())]


def dag_jit(direct, card):
    """(a) Phase 6's requests through ``compile_to_jit`` of a pure DAG:
    prep -> the flagship's forward -> the next-token loss."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode, MultiOutputNode, compile_to_jit
    cfg, params = flagship_config(), DAG_CONTEXT["params"]

    @rt.remote
    def prep(tokens):
        return tokens.to(DEVICE, torch.long)

    @rt.remote
    def logits_of(tokens):
        return tfm.forward(params, tokens, cfg)

    @rt.remote
    def loss_of(logits, tokens):
        return next_token_loss(logits, tokens)

    with InputNode() as inp:
        tokens = prep.bind(inp)
        logits = logits_of.bind(tokens)
        dag = MultiOutputNode([logits, loss_of.bind(logits, tokens)])
    composed = compile_to_jit(dag)
    requests = direct["requests"]
    batches = [requests[i * BATCH:(i + 1) * BATCH]
               for i in range(N_REQUESTS // BATCH)]
    path = PathLaunches()
    answers, per_call = [], []
    with torch.inference_mode():
        for batch in batches:
            counts = fa.launches
            with path:
                got_logits, got_loss = composed(batch)
                torch.cuda.synchronize()
            per_call.append(fa.launches - counts)
            want = tfm.forward(params, batch, cfg)
            check(torch.equal(got_logits, want),
                  "dag (a): compile_to_jit's logits differ from the direct "
                  "forward's")
            check(torch.equal(got_loss, next_token_loss(want, batch)),
                  "dag (a): the DAG's loss differs from the direct one")
            answers += _answers_of(got_logits)
        check_answers(answers, direct["answers"],
                      direct["logits_gap_bf16_fp32"], "dag (a)",
                      bit_equal=True)
        check(per_call == [cfg.n_layers] * len(batches),
              f"dag (a): flash launches a call {per_call}, expected "
              f"{cfg.n_layers}")
        dag_s, direct_s = [], []
        for i in range(DAG_TIMED):
            batch = batches[i % len(batches)]
            torch.cuda.synchronize()
            with path:
                t0 = time.perf_counter()
                composed(batch)
                torch.cuda.synchronize()
                dag_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            next_token_loss(tfm.forward(params, batch, cfg), batch)
            torch.cuda.synchronize()
            direct_s.append(time.perf_counter() - t0)
    launches = path.total
    check(launches["flash_fwd"] == cfg.n_layers * (len(batches) + DAG_TIMED),
          f"dag (a): launches {launches}")
    res = {"calls": len(batches) + DAG_TIMED,
           "launches_per_call": per_call, "bit_equal_direct": True,
           "dag_s": float(np.median(dag_s)),
           "direct_s": float(np.median(direct_s)), "launches": launches}
    print(f"dag (a) ({card}): compile_to_jit of prep -> forward -> loss, "
          f"logits bit for bit the direct forward's and phase 6's answers; "
          f"{per_call} flash launches a call; median of {DAG_TIMED}: "
          f"{res['dag_s']:.6f} s a call against {res['direct_s']:.6f} s "
          f"for the direct forward and loss")
    return res


def dag_compiled(rt, direct, card):
    """(b) A compiled actor DAG: a CPU process-worker actor cuts phase 6's
    batches, a ``num_gpus=1`` Replica answers them on the card."""
    from ray_tpu_torch.dag import InputNode
    cfg = flagship_config()
    rows = direct["requests"].cpu().numpy()
    n_batches = N_REQUESTS // BATCH

    class Batches:
        """Defined here, so that it travels by value: its process worker
        loads no torch."""

        def __init__(self, rows):
            self.rows = rows

        def batch(self, i):
            return self.rows[i * BATCH:(i + 1) * BATCH]

        def boom(self, i):
            raise ValueError(f"stage exploded on batch {i}")

        def pid(self):
            return os.getpid()

    path = PathLaunches()
    with path:              # the Replica's constructor warms the forward
        prep = rt.remote(num_cpus=1)(Batches).remote(rows)
        replica = rt.remote(num_gpus=1)(Replica).remote()
        check(rt.get(prep.pid.remote(), timeout=DAG_WAIT_S) != os.getpid(),
              "dag (b): the CPU stage runs in the driver, not a process "
              "worker")
        with InputNode() as inp:
            dag = replica.answer.bind(prep.batch.bind(inp))
        compiled = dag.experimental_compile()
    check(compiled.is_fast, "dag (b): the compiled DAG took the replay path")
    answers, per_execute = [], []
    for i in range(n_batches):
        counts = fa.launches
        with path:
            answers += rt.get(compiled.execute(i), timeout=DAG_WAIT_S)
        per_execute.append(fa.launches - counts)
    check_answers(answers, direct["answers"], direct["logits_gap_bf16_fp32"],
                  "dag (b)", bit_equal=True)
    check(per_execute == [cfg.n_layers] * n_batches,
          f"dag (b): flash launches an execute {per_execute}")
    compiled_s, chained_s = [], []
    for i in range(DAG_TIMED):
        b = i % n_batches
        with path:
            t0 = time.perf_counter()
            got_c = rt.get(compiled.execute(b), timeout=DAG_WAIT_S)
            compiled_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got_u = rt.get(replica.answer.remote(prep.batch.remote(b)),
                       timeout=DAG_WAIT_S)
        chained_s.append(time.perf_counter() - t0)
        want = direct["answers"][b * BATCH:(b + 1) * BATCH]
        check(got_c == want and got_u == want,
              f"dag (b): timed answers to batch {b} differ from phase 6's")
    with InputNode() as inp:
        bad = replica.answer.bind(prep.boom.bind(inp))
    failing = bad.experimental_compile()
    check(failing.is_fast, "dag (b): the failing DAG took the replay path")
    t0 = time.perf_counter()
    try:
        rt.get(failing.execute(1), timeout=DAG_WAIT_S)
        raised = None
    except Exception as e:          # the stage's error, through the channel
        raised = e
    error_s = time.perf_counter() - t0
    check(raised is not None and "stage exploded on batch 1" in str(raised),
          f"dag (b): the failing stage's error did not reach the caller: "
          f"{raised!r}")
    failing.teardown()
    check(path.total["flash_fwd"] == cfg.n_layers * (1 + n_batches
                                                     + DAG_TIMED),
          f"dag (b): launches {path.total} (a warm forward and "
          f"{n_batches + DAG_TIMED} executes)")
    res = {"is_fast": True, "executes": n_batches + DAG_TIMED,
           "launches": path.total,
           "launches_per_execute": per_execute, "bit_equal_direct": True,
           "execute_s": float(np.median(compiled_s)),
           "chained_remote_s": float(np.median(chained_s)),
           "direct_batch_latency_s": direct["latency_s"],
           "error_s": error_s, "error": type(raised).__name__}
    print(f"dag (b) ({card}): CPU process-worker stage -> num_gpus=1 "
          f"Replica, is_fast, answers bit for bit phase 6's, {per_execute} "
          f"flash launches an execute; median of {DAG_TIMED}: execute "
          f"{res['execute_s']:.6f} s, the two calls chained by .remote "
          f"{res['chained_remote_s']:.6f} s (phase 6 direct "
          f"{direct['latency_s']} s); a raising stage's "
          f"{type(raised).__name__} reached the caller in {error_s:.3f} s")
    return compiled, replica, prep, res


def dag_trace(rt, compiled, direct, card):
    """(d) Two of (b)'s executes under ``tracing.trace``."""
    from ray_tpu_torch.util import tracing
    cfg = flagship_config()
    logdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    path = PathLaunches()
    t0 = time.perf_counter()
    with path, tracing.trace(logdir):
        got = [rt.get(compiled.execute(i % 2), timeout=DAG_WAIT_S)
               for i in range(DAG_TRACED)]
    traced_s = time.perf_counter() - t0
    for i, answers in enumerate(got):
        b = i % 2
        check(answers == direct["answers"][b * BATCH:(b + 1) * BATCH],
              f"dag (d): traced execute {i}'s answers differ from phase 6's")
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"dag (d): trace files {files}")
    trace_file = os.path.join(logdir, files[0])
    trace_bytes = os.path.getsize(trace_file)
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(logdir, ignore_errors=True)
    span_name = "Replica.answer [compiled]"
    spans = sorted((e for e in events if e.get("name") == span_name
                    and e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    check(len(spans) == DAG_TRACED,
          f"dag (d): {len(spans)} spans named {span_name!r}, expected "
          f"{DAG_TRACED}")
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "flash_fwd_wgmma" in e.get("name", "")]
    corr = {e.get("args", {}).get("correlation") for e in kernels}
    calls = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")
             and e.get("args", {}).get("correlation") in corr]
    in_span = [sum(1 for c in calls
                   if s["ts"] <= c["ts"] <= s["ts"] + s["dur"])
               for s in spans]
    check(in_span == [cfg.n_layers] * DAG_TRACED,
          f"dag (d): flash_fwd_wgmma launches inside each stage span "
          f"{in_span} ({len(kernels)} kernels in the trace), expected "
          f"{cfg.n_layers}")
    timeline = tracing.timeline()
    stage_events = {}
    for e in timeline:
        if e.get("name", "").endswith("[compiled]") \
                and "exec_ms" in e.get("args", {}):
            stage_events.setdefault(e["name"], []).append(
                e["args"]["exec_ms"])
    check({"Batches.batch [compiled]", span_name} <= set(stage_events),
          f"dag (d): the timeline's compiled stages {sorted(stage_events)}")
    res = {"spans": len(spans), "flash_in_span": in_span,
           "launches": path.total,
           "flash_kernels": len(kernels), "trace_bytes": trace_bytes,
           "traced_s": traced_s,
           "span_ms": [s["dur"] / 1e3 for s in spans],
           "timeline_exec_ms": {k: float(np.median(v))
                                for k, v in stage_events.items()}}
    print(f"dag (d) ({card}): {DAG_TRACED} executes traced in "
          f"{traced_s:.3f} s ({trace_bytes} bytes of trace): spans "
          f"{span_name!r} of {res['span_ms']} ms, flash_fwd_wgmma launched "
          f"{in_span} times inside them; the timeline's stages (median "
          f"exec_ms) {res['timeline_exec_ms']}")
    return res


def p19_forward_step(rows, counter):
    """(c)'s middle step, a ``num_gpus=1`` task on a driver thread: the
    flagship's forward on a batch, counted in ``counter``."""
    with open(counter, "a") as f:
        f.write("forward\n")
    tokens = torch.from_numpy(np.require(rows, requirements="W")).to(DEVICE)
    with torch.inference_mode():
        logits = tfm.forward(DAG_CONTEXT["params"], tokens, flagship_config())
    last = logits[:, -1]
    return {"next_token": last.argmax(dim=-1).cpu().numpy(),
            "last_logits": last.float().cpu().numpy()}


def dag_workflow(rt, direct, card):
    """(c) A three-step workflow whose middle step runs the flagship on
    the card; the last step crashes on the first run."""
    from ray_tpu_torch import workflow
    scratch = tempfile.mkdtemp(prefix="chip_smoke_workflow_")
    counter = os.path.join(scratch, "steps")
    flag = os.path.join(scratch, "let_the_last_step_pass")
    rows = direct["requests"].cpu().numpy()

    def cut(rows, i, counter):
        with open(counter, "a") as f:
            f.write("cut\n")
        return rows[i * BATCH:(i + 1) * BATCH]

    def finish(out, counter, flag):
        with open(counter, "a") as f:
            f.write("finish\n")
        if not os.path.exists(flag):
            raise RuntimeError("injected crash in the last step")
        return {"next_token": out["next_token"].tolist(),
                "last_logits": out["last_logits"]}

    cut_step = rt.remote(num_cpus=1)(cut)
    forward_step = rt.remote(num_gpus=1)(p19_forward_step)
    finish_step = rt.remote(num_cpus=1)(finish)
    dag = finish_step.bind(
        forward_step.bind(cut_step.bind(rows, 0, counter), counter),
        counter, flag)
    storage = os.path.join(scratch, "store")
    path = PathLaunches()
    t0 = time.perf_counter()
    try:
        with path:
            workflow.run(dag, workflow_id="p19", storage=storage)
        crashed = None
    except Exception as e:
        crashed = e
    first_s = time.perf_counter() - t0
    check(crashed is not None and "injected crash" in str(crashed),
          f"dag (c): the first run did not fail in its last step: "
          f"{crashed!r}")
    check(workflow.get_status("p19", storage) == "FAILED",
          "dag (c): the crashed workflow is not FAILED")
    with open(counter) as f:
        first = f.read().split()
    check(first == ["cut", "forward", "finish"],
          f"dag (c): steps of the first run {first}")
    open(flag, "w").close()
    t0 = time.perf_counter()
    with path:
        out = workflow.resume("p19", storage)
    resume_s = time.perf_counter() - t0
    with open(counter) as f:
        steps = f.read().split()
    check(steps == ["cut", "forward", "finish", "finish"],
          f"dag (c): the resume ran {steps[3:]}, expected the last step "
          f"alone")
    check(workflow.get_status("p19", storage) == "SUCCEEDED",
          "dag (c): the resumed workflow is not SUCCEEDED")
    with torch.inference_mode():
        want = tfm.forward(DAG_CONTEXT["params"], direct["requests"][:BATCH],
                           flagship_config())[:, -1]
    want_logits = want.float().cpu()
    check(torch.equal(want_logits, direct["last_logits"]),
          "dag (c): the direct forward's last logits differ from phase 6's")
    check(np.array_equal(out["last_logits"], want_logits.numpy())
          and out["next_token"] == want.argmax(dim=-1).tolist(),
          "dag (c): the resumed result differs from a direct run's")
    launches = path.total
    check(launches["flash_fwd"] == flagship_config().n_layers,
          f"dag (c): launches {launches}")
    shutil.rmtree(scratch, ignore_errors=True)
    res = {"steps_first_run": first, "steps_after_resume": steps,
           "forward_runs": steps.count("forward"),
           "first_run_s": first_s, "resume_s": resume_s,
           "bit_equal_direct": True, "launches": launches}
    print(f"dag (c) ({card}): workflow cut -> forward (num_gpus=1) -> "
          f"finish; the first run crashed in its last step after "
          f"{first_s:.3f} s, the resume ran the last step alone in "
          f"{resume_s:.3f} s; the forward ran {steps.count('forward')} "
          f"time(s); the result bit for bit a direct run's; launches "
          f"{launches}")
    return res


def phase_dag(direct, card):
    """Phase 19 (a)-(d) on one runtime that owns the card."""
    import ray_tpu_torch as rt
    DAG_CONTEXT["params"] = tfm.init_params(flagship_config(), seed=SEED,
                                            device=DEVICE)
    torch.cuda.synchronize()
    out = {"jit": dag_jit(direct, card)}
    w = rt.init()
    session, pids = w.session, set()
    try:
        compiled, replica, prep, out["compiled"] = dag_compiled(
            rt, direct, card)
        out["trace"] = dag_trace(rt, compiled, direct, card)
        compiled.teardown()
        rt.kill(replica)
        rt.kill(prep)
        segment_owners(w, pids)
        # after the Replica is gone: the GPU step needs the card's one GPU
        out["workflow"] = dag_workflow(rt, direct, card)
        segment_owners(w, pids)
    finally:
        segment_owners(w, pids)
        rt.shutdown()
    segments = segments_left(session, pids)
    check(not segments, f"dag: segments left in /dev/shm: {segments[:8]}")
    return out


def _metric(url, name, tags):
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
    for line in body.splitlines():
        if line.startswith(name + "{") and all(
                f'{k}="{v}"' in line for k, v in tags.items()):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def phase_autoscale(direct, card):
    """(e) ``AutoscalerV2`` with a logical ``{"CPU": 1, "GPU": 1}`` node
    type under a head without GPUs."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import NodeType
    from ray_tpu_torch.autoscaler.v2 import (AutoscalerV2, FakeCloudProvider,
                                             InstanceState)
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    cfg = flagship_config()
    gpu_type = NodeType("gpu", {"CPU": 1, "GPU": 1}, max_workers=1)
    cluster = Cluster(head_num_cpus=2, num_gpus=0)
    w = cluster.worker
    session, pids = w.session, set()
    scaler = None
    try:
        check("GPU" not in rt.cluster_resources(),
              "autoscale: the head has a GPU")
        try:
            AutoscalerV2(FakeCloudProvider(cluster, remote=True), [gpu_type])
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "see no card" in refused,
              f"autoscale: a remote GPU node type was not refused "
              f"({refused!r})")
        host, port = start_dashboard()
        metrics = f"http://{host}:{port}/metrics"
        gauge = "ray_tpu_autoscaler_instances"
        scaler = AutoscalerV2(
            FakeCloudProvider(cluster, boot_delay_s=0.05), [gpu_type],
            idle_timeout_s=AUTOSCALE_IDLE_S, period_s=0.05,
            upscale_delay_s=0.05, downscale_delay_s=0.2).start()
        path = PathLaunches()
        t0 = time.perf_counter()
        rows = direct["requests"][:BATCH].cpu().numpy()
        with path:
            replica = rt.remote(num_gpus=1)(Replica).remote()
            answers = rt.get(replica.answer.remote(rows), timeout=DAG_WAIT_S)
        answer_s = time.perf_counter() - t0
        check(answers == direct["answers"][:BATCH],
              "autoscale: the Replica's answers differ from phase 6's")
        running = [i for i in scaler.instances.all()
                   if i.state == InstanceState.RUNNING]
        check(len(running) == 1 and len(scaler.instances.all()) == 1,
              f"autoscale: instances {scaler.instances.table()}")
        _wait_until(lambda: _metric(metrics, gauge,
                                    {"state": "RUNNING"}) == 1.0,
                    "the RUNNING instance on /metrics", timeout=DAG_WAIT_S)
        launched_s = time.perf_counter() - t0
        rt.kill(replica)
        t_kill = time.perf_counter()
        _wait_until(lambda: _metric(metrics, gauge,
                                    {"state": "TERMINATED"}) == 1.0,
                    "the TERMINATED instance on /metrics",
                    timeout=DAG_WAIT_S)
        terminated_s = time.perf_counter() - t_kill
        check(_metric(metrics, gauge, {"state": "RUNNING"}) == 0.0,
              "autoscale: an instance still RUNNING on /metrics")
        node = running[0].node_id
        check(node not in {nid for nid, _ in
                           w.node_group.cluster_resources.nodes()},
              "autoscale: the terminated node is still in the cluster")
        states = [t[2] for t in running[0].transitions]
        launches = path.total
        check(launches["flash_fwd"] == 2 * cfg.n_layers,
              f"autoscale: launches {launches} (a warm forward and a "
              f"batch)")
        segment_owners(w, pids)
    finally:
        if scaler is not None:
            scaler.stop()
        stop_dashboard()
        segment_owners(w, pids)
        cluster.shutdown()
    segments = segments_left(session, pids)
    check(not segments, f"autoscale: segments left: {segments[:8]}")
    res = {"refused_remote_gpu_type": True, "answer_s": answer_s,
           "launched_s": launched_s, "terminated_after_kill_s": terminated_s,
           "idle_timeout_s": AUTOSCALE_IDLE_S, "transitions": states,
           "bit_equal_direct": True, "launches": launches}
    print(f"autoscale ({card}): a pending num_gpus=1 Replica launched one "
          f"logical GPU node and answered a batch bit for bit phase 6's "
          f"{answer_s:.3f} s after it was made (gauge RUNNING at "
          f"{launched_s:.3f} s); killed, its node was TERMINATED on "
          f"/metrics {terminated_s:.3f} s later (idle timeout "
          f"{AUTOSCALE_IDLE_S} s); transitions {states}; a remote GPU node "
          f"type refused")
    return res


def phase_cli_job(card):
    """(f) The CLI's head, a job on the card, status, list and timeline,
    and stop, in a ``TMPDIR`` of the phase's own."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    root = os.path.dirname(os.path.abspath(__file__))
    old_env = {k: os.environ.get(k) for k in ("TMPDIR", "RTPU_SESSION_TOKEN")}
    os.environ["TMPDIR"] = tmp
    tempfile.tempdir = None
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    shm = "/dev/shm"
    shm_before = {f for f in os.listdir(shm) if f.startswith("rtpt_")}
    session = f"p19{os.getpid()}"

    def cli(*args, timeout=120):
        out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                             capture_output=True, text=True, env=env,
                             timeout=timeout, cwd=root)
        check(out.returncode == 0, f"cli {args[:2]}: rc {out.returncode}: "
              f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
        return out.stdout

    t_phase = time.perf_counter()
    stopped = None
    try:
        head = cli("start", "--head", "--session", session)
        addr = head.split(" at ", 1)[1].split()[0]
        t0 = time.perf_counter()
        job = cli("job", "submit", "--address", addr, "--timeout", "600",
                  "--", sys.executable, "-c", shlex.quote(JOB_SRC), DEVICE,
                  shlex.quote(json.dumps(FLAGSHIP_ATTN)), timeout=900)
        job_s = time.perf_counter() - t0
        check("SUCCEEDED (rc=0)" in job, f"cli: the job did not succeed: "
              f"{job[-2000:]}")
        line = next(ln for ln in job.splitlines()
                    if ln.startswith("job-flash "))
        flash = json.loads(line.split(" ", 1)[1])
        check(flash["launches"] == 1 and flash["task_pid"] != flash["job_pid"],
              f"cli: the job's flash launches and task {flash}")
        check(flash["max_abs_err"] <= BF16_O_TOL
              and flash["rel_err"] <= BF16_O_REL,
              f"cli: the job's flash forward off its plain version {flash}")
        check(flash["resources"].get("GPU", 0) >= 1,
              f"cli: the job's driver saw no GPU: {flash['resources']}")
        status = cli("status", "--address", addr)
        check("True" in status, f"cli: status {status}")
        # a driver of this process joins, for the state and the timeline
        rt.init(address=addr, num_cpus=1, max_process_workers=1)
        try:
            @rt.remote(num_cpus=1)
            class Pinger:
                def ping(self):
                    return os.getpid()

            pinger = Pinger.options(name="p19_pinger").remote()
            check(rt.get(pinger.ping.remote(), timeout=DAG_WAIT_S)
                  != os.getpid(), "cli: the actor ran in the driver")
            listed = cli("list", "actors", "--address", addr)
            check("Pinger" in listed and "ALIVE" in listed,
                  f"cli: list actors {listed}")
            host, port = start_dashboard()
            path = os.path.join(tmp, "timeline.json")
            cli("timeline", "--dashboard", f"{host}:{port}", "--out", path)
            with open(path) as f:
                spans = json.load(f)
            check(any("Pinger.ping" in e["name"] for e in spans),
                  f"cli: timeline spans {[e['name'] for e in spans][:8]}")
            stop_dashboard()
            rt.kill(pinger)
        finally:
            rt.shutdown()
    finally:
        try:
            stopped = subprocess.run(
                [sys.executable, "-m", "ray_tpu_torch", "stop", "--session",
                 session], capture_output=True, text=True, env=env,
                timeout=60, cwd=root).stdout.strip()
        finally:
            for k, v in old_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            tempfile.tempdir = None
    check(stopped == "terminated 1 process(es)", f"cli: stop said {stopped!r}")
    deadline = time.perf_counter() + RUNTIME_FREE_WAIT_S
    while time.perf_counter() < deadline:
        left = sorted({f for f in os.listdir(shm) if f.startswith("rtpt_")}
                      - shm_before)
        if not left:
            break
        time.sleep(0.1)
    check(not left, f"cli: segments left in /dev/shm: {left[:8]}")
    shutil.rmtree(tmp, ignore_errors=True)
    res = {"job_s": job_s, "job_flash": flash, "timeline_spans": len(spans),
           "stop": stopped, "wall_s": time.perf_counter() - t_phase,
           "launches": {"flash_fwd": flash["launches"]}}
    print(f"cli ({card}): start --head, a job SUCCEEDED in {job_s:.3f} s "
          f"(a CPU task in pid {flash['task_pid']}, the flash forward at "
          f"{FLAGSHIP_ATTN} on the card: {flash['launches']} launch, |dO| "
          f"{flash['max_abs_err']:.3g}, rel {flash['rel_err']:.3g} against "
          f"plain); status, list actors, timeline ({len(spans)} spans); "
          f"{stopped}; no segment left")
    return res


def phase_slice19(direct, card):
    """Phase 19: DAGs, workflows and tracing, then the autoscaler and the
    CLI with a job, at the flagship's width on the card."""
    t0 = time.perf_counter()
    out = phase_dag(direct, card)
    out["autoscale"] = phase_autoscale(direct, card)
    out["cli"] = phase_cli_job(card)
    DAG_CONTEXT.clear()
    out["wall_s"] = time.perf_counter() - t0
    out["launches_by_part"] = {
        "dag": _add_launches(out["jit"]["launches"],
                             out["compiled"]["launches"],
                             out["trace"]["launches"]),
        "workflow": out["workflow"]["launches"],
        "autoscaler": out["autoscale"]["launches"],
        "job": {**dict.fromkeys(out["autoscale"]["launches"], 0),
                **out["cli"]["launches"]}}
    print(f"phase 19 took {out['wall_s']:.3f} s ({card})")
    return out


# -- phase 20: RL ----------------------------------------------------------

RL_TOL = 1e-4            # abs, every parameter: card update vs CPU update
RL_CHECKED = 3           # PPO updates held against the CPU path
RL_PPO_ITERS = 30        # the reference's budget and threshold
RL_PPO_BEST = 120.0      # (tests/test_rl.py:46-64, seed 1)
RL_OTHER_ITERS = 2       # DQN, IMPALA and multi-agent PPO
RL_GANG_CALLS = 3        # timed updates of each way in (c)


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    else:
        yield np.asarray(tree, np.float64)


def _max_abs(a, b):
    return max(float(np.max(np.abs(x - y))) if x.size else 0.0
               for x, y in zip(_leaves(a), _leaves(b)))


class CheckedUpdate:
    """An algorithm's ``_update`` on the card (numpy in, numpy out), timed
    on the host clock; each of its first ``checked`` calls is also run by
    the same update on the CPU on the same inputs, and every parameter of
    the two results held within RL_TOL. ``extra(args)`` runs beside each
    checked call."""

    def __init__(self, name, module, config, checked, extra=None):
        self.name, self.checked, self.extra = name, checked, extra
        self.card = module.make_update(config, DEVICE)
        self.cpu = module.make_update(config, "cpu")
        self.ms, self.param_err, self.other_err = [], [], []
        self.last_args = None

    def __call__(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.card(*args)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.last_args = args
        if len(self.param_err) < self.checked:
            want = self.cpu(*args)
            err = _max_abs(out[0], want[0])
            self.param_err.append(err)
            self.other_err.append(_max_abs(out[1:], want[1:]))
            check(err <= RL_TOL,
                  f"rl {self.name}: update {len(self.param_err)} on the "
                  f"card off the CPU path by {err:.3e} > {RL_TOL}")
            if self.extra is not None:
                self.extra(args)
        return out

    def summary(self):
        return {"updates": len(self.ms), "update_ms": self.ms,
                "update_ms_median": float(np.median(self.ms)),
                "checked_param_max_abs": self.param_err,
                "checked_state_max_abs": self.other_err}


def rl_ppo(rl, card, batches):
    """(a) PPO at the reference's learning-test settings, learner on the
    card; the first RL_CHECKED updates held against the CPU path; up to
    RL_PPO_ITERS iterations to reach RL_PPO_BEST; one update traced. Its
    config and last update's arguments go into ``batches["ppo"]``."""
    from ray_tpu_torch.rl import ppo
    algo = (rl.PPOConfig()
            .environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_runner=16,
                         rollout_length=128)
            .training(lr=3e-3, epochs=10, entropy_coeff=0.01, seed=1,
                      device=DEVICE)
            .build())
    try:
        check(algo.device.type == torch.device(DEVICE).type,
              f"rl ppo: learner on {algo.device}")
        bundle = algo._default_learner_bundle()
        algo._update = upd = CheckedUpdate("ppo", ppo, algo.config,
                                           RL_CHECKED)
        first = algo.train()
        best, iters, walls = 0.0, 1, [first["time_this_iter_s"]]
        while best < RL_PPO_BEST and iters < 1 + RL_PPO_ITERS:
            result = algo.train()
            iters += 1
            walls.append(result["time_this_iter_s"])
            best = max(best, result["episode_return_mean"])
        check(len(upd.param_err) == RL_CHECKED,
              f"rl ppo: {len(upd.param_err)} checked updates")
        check(best >= RL_PPO_BEST,
              f"rl ppo: best {best:.1f} < {RL_PPO_BEST} in {iters} "
              f"iterations")
        batches["ppo"] = (algo.config, upd.last_args)
        trace = profile_device(lambda: upd.card(*upd.last_args),
                               "rl ppo update")
        out = {**upd.summary(), "iterations": iters, "best": best,
               "iteration_s": walls,
               "iteration_s_median": float(np.median(walls)),
               "learner_bundle": bundle,
               "device_idle_share": trace.get("idle_share"),
               "trace": trace}
        print(f"rl ppo: best {best:.1f} after {iters} iterations; update "
              f"{out['update_ms_median']:.2f} ms (median of {len(upd.ms)}),"
              f" iteration {out['iteration_s_median']:.3f} s, device idle "
              f"share {out['device_idle_share']}; card vs CPU "
              f"{max(upd.param_err):.3e} ({card})")
        return out
    finally:
        algo.stop()


def rl_vtrace_check(config, got):
    """IMPALA's V-trace targets of an update's batch, from the CPU's
    values: the function on the card against the same on the CPU."""
    from ray_tpu_torch.rl import impala, ppo

    def inputs(args):
        params, _, _, obs, actions, logp, rewards, dones, last_obs, _ = args
        with torch.no_grad():
            p = ppo.to_device(params, "cpu")
            logits, values = ppo._net(p, torch.from_numpy(obs))
            _, last_v = ppo._net(p, torch.from_numpy(last_obs))
            _, target = ppo._log_probs(
                logits, torch.from_numpy(actions).long())
        rhos = torch.exp(target - torch.from_numpy(logp))
        not_done = 1.0 - torch.from_numpy(dones).float()
        return values, last_v, torch.from_numpy(rewards), not_done, rhos

    def extra(args):
        cpu_in = inputs(args)
        kw = dict(gamma=config.gamma, rho_clip=config.rho_clip,
                  c_clip=config.c_clip)
        want = impala.vtrace_targets(*cpu_in, **kw)
        have = [h.cpu() for h in impala.vtrace_targets(
            *(x.to(DEVICE) for x in cpu_in), **kw)]
        # the reference's bound, rtol and atol 1e-4, element by element
        check(all(bool(((h - w).abs() <= RL_TOL * (1 + w.abs())).all())
                  for h, w in zip(have, want)),
              "rl impala: V-trace on the card off the CPU function")
        got.append(max(float((h - w).abs().max())
                       for h, w in zip(have, want)))
    return extra


def rl_others(rl, card, batches):
    """(b) DQN, IMPALA and multi-agent PPO, RL_OTHER_ITERS iterations
    each, learner on the card, every update held against the CPU path.
    Each config and last update's arguments go into ``batches``."""
    from ray_tpu_torch.rl import dqn, impala, multi_agent
    out = {}
    vtrace_err = []
    for name, module, config in (
            ("dqn", dqn, rl.DQNConfig(device=DEVICE)),
            ("impala", impala, rl.IMPALAConfig(lr=3e-3, seed=3,
                                               device=DEVICE)),
            ("multi_agent", multi_agent,
             rl.MultiAgentPPOConfig(seed=3, device=DEVICE))):
        algo = config.build()
        try:
            extra = (rl_vtrace_check(config, vtrace_err)
                     if name == "impala" else None)
            algo._update = upd = CheckedUpdate(name, module, config,
                                               RL_OTHER_ITERS, extra)
            results = [algo.train() for _ in range(RL_OTHER_ITERS)]
            check(len(upd.param_err) == RL_OTHER_ITERS,
                  f"rl {name}: {len(upd.param_err)} checked updates")
            out[name] = {**upd.summary(), "results": results}
            batches[name] = (config, upd.last_args)
            print(f"rl {name}: {len(upd.ms)} updates, "
                  f"{out[name]['update_ms_median']:.2f} ms median, card vs "
                  f"CPU {max(upd.param_err):.3e} ({card})")
        finally:
            algo.stop()
    out["impala"]["vtrace_max_abs"] = vtrace_err
    return out


def _timed_ms(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rl_gang(batches, card):
    """(c) The learner gang at world size 1 on the card (``LocalRanks(1,
    "cuda")``: one NCCL rank on card 0, which the driver shares) for PPO,
    IMPALA and multi-agent PPO: each one's ``make_dp_update`` on the last
    batch of (a) or (b), its first update held against the in-driver
    update on the same params and batch within RL_TOL in every parameter,
    then RL_GANG_CALLS updates of each way timed on the host clock."""
    from ray_tpu_torch.parallel.launch import LocalRanks
    from ray_tpu_torch.rl import impala, multi_agent, ppo
    out = {}
    t0 = time.perf_counter()
    with LocalRanks(1, DEVICE) as ranks:
        start_s = time.perf_counter() - t0
        for name, module in (("ppo", ppo), ("impala", impala),
                             ("multi_agent", multi_agent)):
            config, args = batches[name]
            gang = module.make_dp_update(config, 1, DEVICE, ranks=ranks)
            driver = module.make_update(config, DEVICE)
            got, first_ms = _timed_ms(gang, *args)
            want, _ = _timed_ms(driver, *args)
            err = _max_abs(got[0], want[0])
            check(err <= RL_TOL,
                  f"rl gang {name}: the world-size-1 gang's update off the "
                  f"in-driver update by {err:.3e} > {RL_TOL}")
            gang_ms = [_timed_ms(gang, *args)[1]
                       for _ in range(RL_GANG_CALLS)]
            driver_ms = [_timed_ms(driver, *args)[1]
                         for _ in range(RL_GANG_CALLS)]
            out[name] = {"param_max_abs": err,
                         "state_max_abs": _max_abs(got[1:3], want[1:3]),
                         "gang_first_ms": first_ms, "gang_ms": gang_ms,
                         "driver_ms": driver_ms,
                         "gang_ms_median": float(np.median(gang_ms)),
                         "driver_ms_median": float(np.median(driver_ms))}
            print(f"rl gang {name} ({card}): gang of 1 vs driver "
                  f"{err:.3e}; update {out[name]['gang_ms_median']:.2f} ms "
                  f"through the gang (first {first_ms:.2f} ms) against "
                  f"{out[name]['driver_ms_median']:.2f} ms in the driver "
                  f"(medians of {RL_GANG_CALLS})")
    out["ranks_start_s"] = start_s
    return out


def phase_rl(card):
    """Phase 20: RL (PPO, DQN, IMPALA, multi-agent PPO) with the learners
    on the card and CPU process-worker runners, after a fresh ``init()``;
    then the learner gang at world size 1 against the in-driver learner.
    The launches of every kernel over the phase are its ``rl`` path."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import rl
    check(not torch.backends.cuda.matmul.allow_tf32,
          "rl: TF32 is on for fp32 matmuls")
    t0 = time.perf_counter()
    before = _counts()
    batches = {}
    rt.init()
    try:
        out = {"ppo": rl_ppo(rl, card, batches),
               **rl_others(rl, card, batches)}
    finally:
        rt.shutdown()
    out["gang"] = rl_gang(batches, card)
    out["launches"] = _launch_delta(before)
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 20 took {out['wall_s']:.3f} s, launches "
          f"{out['launches']} ({card})")
    return out


# -- static analysis and the sanitizer ------------------------------------

SANITIZED_WAIT_S = 900.0      # the sanitized child's limit, its nvcc included
ANALYSIS_WAIT_S = 600.0


def _repo_root():
    return os.path.dirname(os.path.abspath(__file__))


def analysis_ci(card):
    """Phase 21 (a): the port's static analysis over its own tree on this
    host (``python -m ray_tpu_torch.devtools.analysis --ci``, exit 0), and
    the committed contract manifest equal to what ``--emit-contracts``
    makes of the tree now."""
    contracts = importlib.import_module(
        "ray_tpu_torch.devtools.analysis.contracts")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.analysis", "--ci"],
        capture_output=True, text=True, cwd=_repo_root(),
        timeout=ANALYSIS_WAIT_S)
    ci_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"analysis --ci exited {proc.returncode}:\n{proc.stdout[-4000:]}"
          f"{proc.stderr[-2000:]}")
    timings_ms = {}
    summary = ""
    for line in proc.stdout.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "timing" and parts[3] == "ms":
            timings_ms[parts[1]] = float(parts[2])
        elif line.startswith("graftcheck:"):
            summary = line
    check(summary.startswith("graftcheck: 0 finding(s)"),
          f"analysis --ci: {summary!r}")
    t0 = time.perf_counter()
    fresh = contracts.render_manifest(contracts.emit_contracts())
    emit_s = time.perf_counter() - t0
    with open(contracts.default_manifest_path(), encoding="utf-8") as f:
        committed = f.read()
    check(committed == fresh, "contracts.json is stale: re-run `python -m "
          "ray_tpu_torch.devtools.analysis --emit-contracts`")
    manifest = json.loads(committed)
    out = {"ci_s": ci_s, "summary": summary, "timings_ms": timings_ms,
           "emit_s": emit_s, "contracts_in_sync": True,
           "lock_sites": len(manifest["lock_sites"]),
           "orders": len(manifest["orders"]),
           "guarded_fields": sum(len(fields)
                                 for owners in manifest["guarded"].values()
                                 for fields in owners.values()),
           "blocking_escapes": len(manifest["blocking_escapes"])}
    print(f"analysis --ci ({card}): {summary} in {ci_s:.3f} s; "
          f"timings {timings_ms} ms; contracts in sync ({emit_s:.3f} s): "
          f"{out['lock_sites']} lock sites, {out['orders']} orders, "
          f"{out['guarded_fields']} guarded fields")
    return out


def sanitized_serve_child(io_dir):
    """Phase 21 (b), in a child started with ``RTPU_SANITIZE=1``: the
    flagship deployed on a ``num_gpus=1`` Serve replica answers phase 6's
    requests through the handle, with the sanitizer's lock registry,
    guarded fields and blocking probes armed, and the kernels built at
    their first use, under the loader's lock, into a build directory of
    the child's own. Writes what it saw to ``io_dir/out.pt``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.devtools import sanitizer
    san_rt = importlib.import_module("ray_tpu_torch.devtools.sanitizer.runtime")
    router = importlib.import_module("ray_tpu_torch.serve._private.router")
    check(sanitizer.installed()
          and threading.Lock.__name__ == "_lock_factory",
          "sanitized child: the lock factories are not patched")
    check(isinstance(router.ReplicaSet.__dict__.get("_replicas"),
                     san_rt.GuardedAttr),
          "sanitized child: the guarded fields are not armed")
    check(isinstance(native_loader._lock, san_rt._RLockProxy),
          "sanitized child: the kernel loader's lock is not instrumented")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    native_loader.BUILD_DIR = os.path.join(io_dir, "_build")
    requests = torch.load(os.path.join(io_dir, "in.pt"))["requests"].tolist()
    batches = [requests[i * BATCH:(i + 1) * BATCH]
               for i in range(len(requests) // BATCH)]
    rt.init()
    try:
        reset_launch_counts()
        reset_scheduler_launch_counts()
        before = _counts()
        deployment = serve.deployment(
            name="flagship_sanitized", ray_actor_options={"num_gpus": 1})(
                FlagshipDeployment)
        t0 = time.perf_counter()
        handle = serve.run(deployment.bind(), timeout=600)
        run_s = time.perf_counter() - t0
        latencies, answers, per_batch = [], [], []
        for batch in batches:
            counts = launch_counts()
            t0 = time.perf_counter()
            answers += rt.get(handle.remote(batch), timeout=600)
            latencies.append(time.perf_counter() - t0)
            per_batch.append(tuple(a - b for a, b in
                                   zip(launch_counts(), counts)))
        record = rt.get(handle.record.remote(), timeout=600)
        launches = _launch_delta(before)
        serve.shutdown()
    finally:
        serve.shutdown()
        rt.shutdown()
    built = sorted(os.listdir(native_loader.BUILD_DIR)) \
        if os.path.isdir(native_loader.BUILD_DIR) else []
    violations = [v.to_json() for v in sanitizer.reporter().snapshot()]
    pairs = sanitizer.observed_pairs()
    torch.save({"answers": answers, "latency_s": latencies,
                "per_batch": per_batch, "launches": launches,
                "serve_run_s": run_s,
                "construction_s": record["construction_s"],
                "last_logits": record["last_logits"],
                "logits_sum": record["logits_sum"], "built": built,
                "violations": violations, "pairs": pairs},
               os.path.join(io_dir, "out.pt"))
    print(f"sanitized child: {len(answers)} answers, launches {launches}, "
          f"built {built}, {len(violations)} violation(s), {len(pairs)} "
          f"lock pair(s) observed")
    return 0


def _observed_inversions(observed_path, manifest):
    """Observed acquisition pairs (a, b) that some declared
    ``# lock-order:`` lists with b before a."""
    out = []
    try:
        with open(observed_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return out
    orders = [{name: i for i, name in enumerate(decl["nodes"])}
              for decl in manifest.get("orders", [])]
    for line in lines:
        if not line.strip():
            continue
        rec = json.loads(line)
        a, b = rec["held"], rec["acquired"]
        if any(a in idx and b in idx and idx[a] > idx[b] for idx in orders):
            out.append(rec)
    return out


def sanitized_serve(direct, served, card):
    """Phase 21 (b): the child above, started with ``RTPU_SANITIZE=1`` (the
    gate acts at import, and this process has imported the port), its own
    ``RTPU_SANITIZE_LOG`` and ``RTPU_SANITIZE_OBSERVED``. Fails on any
    violation in the child's ring or in the log (its process workers
    write there too), on an observed pair that inverts a declared order,
    on no flash forward launch, and on answers that are not phase 14's
    handle answers bit for bit."""
    contracts = importlib.import_module(
        "ray_tpu_torch.devtools.analysis.contracts")
    cfg = flagship_config()
    io_dir = tempfile.mkdtemp(prefix="rtpt_sanitized_")
    try:
        torch.save({"requests": direct["requests"].cpu()},
                   os.path.join(io_dir, "in.pt"))
        log = os.path.join(io_dir, "graftsan.jsonl")
        observed = os.path.join(io_dir, "observed.jsonl")
        env = dict(os.environ, RTPU_SANITIZE="1", RTPU_SANITIZE_LOG=log,
                   RTPU_SANITIZE_OBSERVED=observed)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke; "
             "sys.exit(chip_smoke.sanitized_serve_child(sys.argv[1]))",
             io_dir], cwd=_repo_root(), env=env, capture_output=True,
            text=True, timeout=SANITIZED_WAIT_S)
        child_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines()[-5:]:
            print(f"  {line}")
        check(proc.returncode == 0,
              f"sanitized child exited {proc.returncode}:\n"
              f"{proc.stdout[-3000:]}{proc.stderr[-4000:]}")
        got = torch.load(os.path.join(io_dir, "out.pt"), weights_only=False)
        logged = []
        if os.path.exists(log):
            with open(log, encoding="utf-8") as f:
                logged = [json.loads(line) for line in f if line.strip()]
        diff = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.devtools.sanitizer",
             "--diff", observed], capture_output=True, text=True,
            cwd=_repo_root(), timeout=120)
        inversions = _observed_inversions(observed,
                                          contracts.load_manifest() or {})
        with open(observed, encoding="utf-8") as f:
            observed_pairs = [json.loads(line) for line in f if line.strip()]
    finally:
        shutil.rmtree(io_dir, ignore_errors=True)
    bad = got["violations"] + logged
    check(not bad, "sanitizer violations in the sanitized serve:\n"
          + "\n".join(f"[{v['kind']}] {v['message']}" for v in bad))
    check(diff.returncode in (0, 1),
          f"sanitizer --diff exited {diff.returncode}: {diff.stderr}")
    check(not inversions, "observed lock pairs invert a declared order: "
          + ", ".join(f"{r['held']} -> {r['acquired']}" for r in inversions))
    check(got["launches"]["flash_fwd"] > 0,
          "sanitized serve: no flash forward launch")
    check(all(b == (cfg.n_layers, 0, 0) for b in got["per_batch"]),
          f"sanitized serve: (fwd, dQ, dK/dV) launches a batch "
          f"{got['per_batch']}, expected ({cfg.n_layers}, 0, 0)")
    check(any(name.startswith("flash_attention-") for name in got["built"]),
          f"sanitized serve: the forward kernel was not built in the "
          f"child ({got['built']})")
    check_answers(got["answers"], direct["answers"],
                  direct["logits_gap_bf16_fp32"], "sanitized handle", True)
    check(torch.equal(got["last_logits"], direct["last_logits"])
          and got["logits_sum"] == direct["logits_sum"],
          "sanitized handle: the first batch's logits differ from the "
          "direct run's")
    plain_s = served["handle"]["batch_latency_s"]
    out = {"child_s": child_s, "serve_run_s": got["serve_run_s"],
           "construction_s": got["construction_s"],
           "batch_latency_s": got["latency_s"],
           "request_latency_s": [t / BATCH for t in got["latency_s"]],
           "unsanitized_batch_latency_s": plain_s,
           "unsanitized_request_latency_s": [t / BATCH for t in plain_s],
           "violations": 0, "observed_pairs": len(observed_pairs),
           "undeclared_pairs": [line.strip() for line in
                                diff.stdout.splitlines()
                                if "->" in line],
           "inversions": 0, "built": got["built"],
           "launches": got["launches"], "bit_equal_direct": True}
    print(f"sanitized serve ({card}): a request "
          f"{out['request_latency_s']} s against {out['unsanitized_request_latency_s']} s "
          f"unsanitized (phase 14's handle, batches of {BATCH}); child "
          f"{child_s:.3f} s, serve.run {got['serve_run_s']:.3f} s "
          f"(construction {got['construction_s']:.3f} s, the kernel build "
          f"included); 0 violations, {len(observed_pairs)} lock pairs "
          f"observed, {len(out['undeclared_pairs'])} undeclared, 0 "
          f"inversions; launches {got['launches']}")
    return out


def phase_sanitize(direct, served, card):
    """Phase 21: the static analysis on this host, then the flagship served
    under the sanitizer in a child process."""
    t0 = time.perf_counter()
    out = {"analysis": analysis_ci(card)}
    torch.cuda.empty_cache()
    out["serve"] = sanitized_serve(direct, served, card)
    out["launches"] = out["serve"]["launches"]
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 21 took {out['wall_s']:.3f} s ({card})")
    return out


# -- phase 22: the soak ------------------------------------------------------

SOAK_SEED = 600           # tests/test_soak.py's SMOKE_SEED and
SOAK_DURATION = 14.0      # SMOKE_DURATION: a draw over all six scopes
SOAK_WAIT_S = 600.0       # the reference smoke's subprocess limit
SOAK_INVARIANTS = ("no-lost-results", "exactly-once-side-effects",
                   "gauges-at-baseline", "bounded-p99-inflation",
                   "graftsan-clean", "replayable-timeline")
# tests/test_soak.py:206-219: each count at or above its floor (the
# reference's "> 50" and "> 10" as 51 and 11)
SOAK_FLOORS = {"fires": 1, "phases": 3, "ingress_ok": 51,
               "churn_tasks_ok": 11, "trainer_epochs_ok": 1,
               "scale_tasks_ok": 1, "storm_bcasts_ok": 1,
               "storm_pulls_deduped": 1}


def soak_child(io_dir):
    """Phase 22, in a child started with ``RTPU_SANITIZE=1``: the port's
    soak (``SoakRunner``) at SOAK_SEED x SOAK_DURATION with the head on
    the card (``device="cuda"``), the lanes' ingress p99s kept, and the
    verdict with the kernel launches of the run written to
    ``io_dir/result.json``."""
    from ray_tpu_torch.devtools import sanitizer
    from ray_tpu_torch.soak import SoakConfig, SoakRunner, oracle
    check(sanitizer.installed(), "soak child: the sanitizer is not on")
    runner = SoakRunner(SoakConfig(seed=SOAK_SEED, duration=SOAK_DURATION,
                                   out_dir=os.path.join(io_dir, "out"),
                                   device=DEVICE))
    p99 = {}
    invariant = runner._p99_invariant

    def keep_p99(ingress):
        p99["calm_s"] = oracle.percentile(ingress.latencies_calm, 0.99)
        p99["chaos_s"] = oracle.percentile(ingress.latencies_chaos, 0.99)
        return invariant(ingress)

    runner._p99_invariant = keep_p99
    reset_launch_counts()
    reset_scheduler_launch_counts()
    before = _counts()
    t0 = time.perf_counter()
    verdict = runner.run()
    wall_s = time.perf_counter() - t0
    launches = _launch_delta(before)
    with open(os.path.join(io_dir, "result.json"), "w",
              encoding="utf-8") as f:
        json.dump({"verdict": verdict.to_dict(), "wall_s": wall_s,
                   "p99": p99, "launches": launches,
                   "kind": torch.cuda.get_device_name(0)}, f)
    print(verdict.render())
    return 0 if verdict.ok else 1


def phase_soak(card):
    """Phase 22: the port's soak on the card-owning runtime, in a child
    process started with ``RTPU_SANITIZE=1`` and its own
    ``RTPU_SANITIZE_LOG`` (the gate acts at import), under SOAK_WAIT_S.
    Fatal: a non-zero exit, ``ok`` false, any of SOAK_INVARIANTS failing
    or ``graftsan-clean`` skipped, a count under SOAK_FLOORS, a live
    digest that is not the dry-run's. Its launches are the ``soak``
    path."""
    from ray_tpu_torch.soak.schedule import (fault_log_digest,
                                             generate_schedule)
    io_dir = tempfile.mkdtemp(prefix="rtpt_soak_")
    try:
        env = dict(os.environ, RTPU_SANITIZE="1",
                   RTPU_SANITIZE_LOG=os.path.join(io_dir, "san.jsonl"))
        env.pop("RTPU_CHAOS", None)         # a stray rule or log would
        env.pop("RTPU_CHAOS_LOG", None)     # skew the replay digest
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke; "
             "sys.exit(chip_smoke.soak_child(sys.argv[1]))", io_dir],
            cwd=_repo_root(), env=env, capture_output=True, text=True,
            timeout=SOAK_WAIT_S)
        child_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines()[-10:]:
            print(f"  {line}")
        check(proc.returncode == 0,
              f"soak child exited {proc.returncode}:\n"
              f"{proc.stdout[-3000:]}{proc.stderr[-4000:]}")
        with open(os.path.join(io_dir, "result.json"),
                  encoding="utf-8") as f:
            got = json.load(f)
        live = fault_log_digest(os.path.join(io_dir, "out",
                                             "fault_events.jsonl"))
    finally:
        shutil.rmtree(io_dir, ignore_errors=True)
    verdict = got["verdict"]
    check(verdict["ok"] is True, f"soak: verdict not ok: {verdict}")
    rows = {r["name"]: r for r in verdict["invariants"]}
    for name in SOAK_INVARIANTS:
        check(name in rows and rows[name]["ok"],
              f"soak: {name}: {rows.get(name)}")
    check(rows["graftsan-clean"]["skipped"] is False,
          "soak: graftsan-clean skipped: the sanitizer was off")
    counts = verdict["counts"]
    for name, floor in SOAK_FLOORS.items():
        check(counts.get(name, 0) >= floor,
              f"soak: {name} = {counts.get(name)} < {floor}")
    want = generate_schedule(SOAK_SEED, SOAK_DURATION).digest()
    check(live == want and verdict["digest"] == want,
          f"soak: live digest {live[:12]} (verdict {verdict['digest'][:12]}) "
          f"!= the dry-run's {want[:12]}")
    out = {"child_s": child_s, "wall_s": got["wall_s"], "counts": counts,
           "calm_p99_s": got["p99"].get("calm_s"),
           "chaos_p99_s": got["p99"].get("chaos_s"),
           "invariants": verdict["invariants"], "digest": want,
           "launches": got["launches"], "device": got["kind"]}
    print(f"phase 22 soak ({card}): seed {SOAK_SEED} x {SOAK_DURATION} s on "
          f"the card, all six invariants held; run {got['wall_s']:.3f} s "
          f"(child {child_s:.3f} s); calm p99 {out['calm_p99_s']} s, chaos "
          f"p99 {out['chaos_p99_s']} s; counts {counts}; launches "
          f"{got['launches']}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    name, count, card = phase_device()
    flash = phase_kernels()
    bwd = phase_backward_kernels()
    wide_head = phase_head_dims()
    memory = phase_memory()
    serving, serving_launches, direct = phase_serving()
    torch.cuda.empty_cache()
    training, tokens = phase_training()
    torch.cuda.empty_cache()
    training["parity"] = phase_training_parity(tokens)
    training["memory_linear_in_s"] = memory
    train_launches = training["launches"]
    torch.cuda.empty_cache()
    mesh, pipeline, vit_result = phase_mesh(training, tokens)
    mesh_launches = mesh["launches"]
    pipe_launches = {key: (pipeline["launches"]["forward"][key]
                           + pipeline["launches"]["gradient"][key])
                     for key in ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv")}
    torch.cuda.empty_cache()
    scheduler = phase_scheduler()
    torch.cuda.empty_cache()
    runtime = phase_runtime(direct, training, tokens)
    replica_launches = runtime["replica"]["launches"]
    trainer_launches = runtime["trainer"]["launches"]
    torch.cuda.empty_cache()
    served = phase_serve(direct, card)
    serve_launches = served["launches"]
    # Phases 15-16 hand functions to gang workers and slice ranks, which
    # unpickle them by module name: run them from the module
    # ``chip_smoke``, so that those functions and the phase share one
    # module's globals (``__main__`` would be pickled by value).
    this = importlib.import_module("chip_smoke")
    torch.cuda.empty_cache()
    trained = this.phase_train(training, tokens, card)
    gang_launches = trained["flagship"]["launches"]
    torch.cuda.empty_cache()
    multislice = this.phase_multislice(card)
    # Phase 17 hands its remote CPU functions to workers that see no card:
    # defined in ``__main__``, they are pickled by value and load nothing
    # but what they use.
    torch.cuda.empty_cache()
    clustered = phase_cluster(direct, card)
    cluster_launches = clustered["launches"]
    # Phase 18 hands its trainer loop and Tune trainable to driver-thread
    # workers by reference, as phases 15-16 do: run it from the module.
    torch.cuda.empty_cache()
    data_out, tuned, checkpointed = this.phase_data(direct, tokens, trained,
                                                    card)
    # Phase 19's actors and its GPU workflow step read the phase's
    # flagship from the module's globals: run it from the module too.
    torch.cuda.empty_cache()
    slice19 = this.phase_slice19(direct, card)
    torch.cuda.empty_cache()
    rl_out = phase_rl(card)
    torch.cuda.empty_cache()
    sanitized = phase_sanitize(direct, served, card)
    torch.cuda.empty_cache()
    soaked = phase_soak(card)
    data_parts = {**data_out["launches_by_part"],
                  **slice19["launches_by_part"], "rl": rl_out["launches"],
                  "sanitized_serve": sanitized["launches"],
                  "soak": soaked["launches"]}
    burst_sched = runtime["burst"]["scheduler_launches"]
    serve_sched = served["scheduler_launches"]
    train_sched = trained["scheduler_launches"]
    multislice_sched = multislice["scheduler_launches"]
    cluster_sched = clustered["scheduler_launches"]

    print(json.dumps({"serving": serving, "card": card}))
    print(json.dumps({"training": training, "card": card}))
    print(json.dumps({"mesh_training": mesh, "card": card}))
    print(json.dumps({"pipeline": pipeline, "card": card}))
    print(json.dumps({"vit": vit_result, "card": card}))
    print(json.dumps({"wide_head_dims": wide_head, "card": card}))
    print(json.dumps({"scheduler": scheduler, "card": card}))
    print(json.dumps({"runtime": runtime, "card": card}))
    print(json.dumps({"serve": served, "card": card}))
    print(json.dumps({"train": trained, "card": card}))
    print(json.dumps({"multislice": multislice, "card": card}))
    print(json.dumps({"cluster": clustered, "card": card}, default=str))
    print(json.dumps({"data": data_out, "checkpoint": checkpointed,
                      "card": card}, default=str))
    print(json.dumps({"tune": tuned, "card": card}, default=str))
    print(json.dumps({"dag_workflow_ops": slice19, "card": card},
                     default=str))
    print(json.dumps({"rl": rl_out, "card": card}, default=str))
    print(json.dumps({"sanitize": sanitized, "card": card}, default=str))
    print(json.dumps({"soak": soaked, "card": card}, default=str))
    src = "ray_tpu/ops/flash_attention.py"
    bwd_src = "ray_tpu_torch/csrc/flash_attention_bwd.cu"
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"{src}:83", "replaces_fn": f"{src}::_flash_fwd_kernel",
        "launches": (serving_launches + train_launches["flash_fwd"]
                     + mesh_launches["flash_fwd"]
                     + pipe_launches["flash_fwd"]
                     + replica_launches["flash_fwd"]
                     + trainer_launches["flash_fwd"]
                     + serve_launches["flash_fwd"]
                     + gang_launches["flash_fwd"]
                     + cluster_launches["flash_fwd"]
                     + sum(part["flash_fwd"]
                           for part in data_parts.values())),
        "launches_by_path": {"serving": serving_launches,
                             "training": train_launches["flash_fwd"],
                             "mesh_training": mesh_launches["flash_fwd"],
                             "pipeline": pipe_launches["flash_fwd"],
                             "runtime_replica": replica_launches["flash_fwd"],
                             "runtime_trainer":
                             trainer_launches["flash_fwd"],
                             "serve": serve_launches["flash_fwd"],
                             "train": gang_launches["flash_fwd"],
                             "cluster": cluster_launches["flash_fwd"],
                             **{name: part["flash_fwd"]
                                for name, part in data_parts.items()}},
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
            "launches": (train_launches[f"flash_bwd_{key}"]
                         + mesh_launches[f"flash_bwd_{key}"]
                         + pipe_launches[f"flash_bwd_{key}"]
                         + trainer_launches[f"flash_bwd_{key}"]
                         + serve_launches[f"flash_bwd_{key}"]
                         + gang_launches[f"flash_bwd_{key}"]
                         + cluster_launches[f"flash_bwd_{key}"]
                         + sum(part[f"flash_bwd_{key}"]
                               for part in data_parts.values())),
            "launches_by_path": {"serving": 0, "training":
                                 train_launches[f"flash_bwd_{key}"],
                                 "mesh_training":
                                 mesh_launches[f"flash_bwd_{key}"],
                                 "pipeline":
                                 pipe_launches[f"flash_bwd_{key}"],
                                 "runtime_replica": 0,
                                 "runtime_trainer":
                                 trainer_launches[f"flash_bwd_{key}"],
                                 "serve": serve_launches[f"flash_bwd_{key}"],
                                 "train": gang_launches[f"flash_bwd_{key}"],
                                 "cluster":
                                 cluster_launches[f"flash_bwd_{key}"],
                                 **{name: part[f"flash_bwd_{key}"]
                                    for name, part in data_parts.items()}},
            "max_abs_err": k["max_abs_err"], "max_err": k["max_abs_err"],
            "rel_err": k["rel_err"], "tile_rel_err": k["tile_rel_err"],
            "ms": k["ms"], "kernel_ms": k["ms"], "tflops": k["tflops"],
            "share_of_bound": k["bound_ms"] / k["ms"],
            "plain_ms": bwd["plain_ms"],
            "plain_is": "the whole plain backward (dQ, dK, dV)",
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": bwd["library_ms"],
            "library_is": bwd["library_is"],
            "delta_ms": bwd["delta_ms"],
            "variant": "bf16: wgmma + TMA; fp32: CUDA-core FMA",
        })
    sched_src = "ray_tpu/_private/scheduler"
    s3_shapes = scheduler["pg_pack_batch_shapes"]
    for key, replaces, fn in (
            ("schedule_classes", f"{sched_src}/tpu_policy.py:76",
             "_schedule_classes_kernel"),
            ("pg_pack", f"{sched_src}/pg_kernel.py:49", "_pack_kernel"),
            ("pg_pack_batch", f"{sched_src}/pg_kernel.py:87",
             "_pack_batch_kernel")):
        k = scheduler["kernels"][key]
        kernels.append({
            "name": key, "route": "cuda",
            "source": "ray_tpu_torch/csrc/scheduler.cu",
            "replaces": replaces,
            "replaces_fn": f"{replaces.split(':')[0]}::{fn} (jitted jnp)",
            "launches": (scheduler["launches"][key] + burst_sched[key]
                         + serve_sched[key] + train_sched[key]
                         + multislice_sched[key] + cluster_sched[key]
                         + sum(part[key] for part in data_parts.values())),
            "launches_by_path": {
                "scheduler": scheduler["launches"][key],
                "runtime_burst": burst_sched[key],
                "serve": serve_sched[key], "train": train_sched[key],
                "multislice": multislice_sched[key],
                "cluster": cluster_sched[key],
                **{name: part[key] for name, part in data_parts.items()}},
            "max_abs_err": 0.0, "exact": True,
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": "bytes",
            "bytes_bound_ms": k["bytes_bound_ms"],
            "launch_floor_ms": k["launch_floor_ms"],
            "library_ms": (s3_shapes["bench"]["argsort_ms"]
                           if key == "pg_pack_batch" else None),
            **({"library_is": "torch.sort(stable=True) of the same "
                              "10,000 base-score keys into outputs "
                              "allocated once (torch.argsort's call), "
                              "least of three passes: the ranking only",
                "ms_by_shape": s3_shapes} if key == "pg_pack_batch" else {}),
            "variant": {
                "schedule_classes": "one thread-block cluster: node slices "
                                    "in shared memory, sums by st.async "
                                    "exchanges, merge-path ranking",
                "pg_pack": "one thread-block cluster: rows and util in "
                           "shared memory, argmin by st.async exchanges",
                "pg_pack_batch": "one thread-block cluster: merge-path "
                                 "ranking of sorted slices, then a warp a "
                                 "group, cached util, in a second "
                                 "launch"}[key],
            "launch_shape": scheduler["launch_shapes"].get(key),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
