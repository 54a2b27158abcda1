"""The port stands alone: no file of ``ray_tpu_torch`` nor ``chip_smoke.py``
imports JAX or anything of ``ray_tpu``, and its entry points run on the
card unless the caller asks for the CPU."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root.startswith("jax") or root == "ray_tpu"


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_ray_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(m for m in _imported_modules(tree) if _forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_RAY_TPU_MODULE = re.compile(r"(?<![\w.])ray_tpu\.[A-Za-z_]")


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                yield first.value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_string_names_a_ray_tpu_module(path):
    """The import scan above cannot see a module named in a string, as a
    spawned process's ``-m ray_tpu._private.raylet_server`` would be: no
    string constant outside docstrings names a ``ray_tpu.`` module."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(node) for node in _docstrings(tree)}
    bad = sorted({node.value for node in ast.walk(tree)
                  if isinstance(node, ast.Constant)
                  and isinstance(node.value, str) and id(node) not in docs
                  and _RAY_TPU_MODULE.search(node.value)})
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_string_check_sees_a_spawned_module():
    """The check above flags the reference's spawn command and passes
    the port's own."""
    bad = 'cmd = [sys.executable, "-m", "ray_tpu._private.gcs_server"]'
    good = 'cmd = [sys.executable, "-m", "ray_tpu_torch._private.gcs_server"]'
    assert [n.value for n in ast.walk(ast.parse(bad))
            if isinstance(n, ast.Constant)
            and _RAY_TPU_MODULE.search(str(n.value))]
    assert not [n.value for n in ast.walk(ast.parse(good))
                if isinstance(n, ast.Constant)
                and _RAY_TPU_MODULE.search(str(n.value))]


def test_entry_points_default_to_the_card():
    from ray_tpu_torch.models import (TransformerConfig, init_params,
                                      init_state, make_optimizer,
                                      params_from_jax)
    cfg = TransformerConfig(vocab_size=32, d_model=64, n_layers=1,
                            n_heads=1, n_kv_heads=1, d_ff=64)
    tx = make_optimizer()
    state = init_state(cfg, tx, device="cpu")
    assert state.step == 0 and state.params["embed"].device.type == "cpu"
    assert state.opt_state.mu[0].device.type == "cpu"
    params = init_params(cfg, device="cpu")
    tree = {k: (np.asarray(v) if k != "blocks" else
                [{n: np.asarray(t) for n, t in b.items()} for b in v])
            for k, v in params.items()}
    assert params_from_jax(tree, device="cpu")["embed"].device.type == "cpu"
    if torch.cuda.is_available():
        assert init_params(cfg)["embed"].device.type == "cuda"
        assert params_from_jax(tree)["embed"].device.type == "cuda"
        assert init_state(cfg, tx).params["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(tree)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_state(cfg, tx)


def test_sources_cover_the_scheduler():
    """The scan above reaches every module of the scheduler slice."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("ids", "config", "scheduler/resources",
                   "scheduler/policy", "scheduler/tpu_policy",
                   "scheduler/pg_kernel", "scheduler/workload"):
        assert f"ray_tpu_torch/_private/{module}.py" in names


def test_scheduler_entry_points_default_to_the_card():
    from ray_tpu_torch._private.scheduler import pg_kernel, policy, tpu_policy
    makers = (tpu_policy.TpuSchedulingPolicy,
              tpu_policy.AdaptiveSchedulingPolicy, pg_kernel.PgKernelSolver,
              policy.default_policy)
    for make in makers:
        assert make(device="cpu") is not None
    if torch.cuda.is_available():
        assert tpu_policy.TpuSchedulingPolicy().device.type == "cuda"
        assert pg_kernel.PgKernelSolver().device.type == "cuda"
    else:
        for make in makers:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


def test_sources_cover_the_mesh_family_and_vit():
    """The scan above reaches every module of the pipeline, slice-mesh,
    multi-host and ViT slice."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("parallel/pipeline", "parallel/slice_mesh",
                   "parallel/multihost", "models/vit", "models/sharded"):
        assert f"ray_tpu_torch/{module}.py" in names


def test_sharded_model_has_no_block_body_of_its_own():
    """``models/sharded.py`` runs ``transformer._block_forward`` through
    its hooks: it defines no block or MoE body (the pre-hook
    ``_block_shard`` and ``_moe_shard``) and calls none of a block body's
    own operations (RoPE, GQA's repeat, SwiGLU's silu)."""
    path = ROOT / "ray_tpu_torch" / "models" / "sharded.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    defined = {node.name for node in ast.walk(tree)
               if isinstance(node, (ast.FunctionDef, ast.ClassDef))}
    assert not defined & {"_block_shard", "_moe_shard"}, defined
    called = {getattr(node.func, "attr", getattr(node.func, "id", None))
              for node in ast.walk(tree) if isinstance(node, ast.Call)}
    body_ops = {"rope", "silu", "repeat_interleave", "_block_forward",
                "_moe_mlp"}
    assert not called & body_ops, called & body_ops



def test_sharded_vit_runs_vit_forward():
    """``models/sharded.py::vit_loss_fn_shard`` runs ``vit.vit_forward``
    through its hooks and repeats none of its steps (patchify, the patch
    positions, the ViT's attention, the log-softmax of the loss)."""
    path = ROOT / "ray_tpu_torch" / "models" / "sharded.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    called = {getattr(node.func, "attr", getattr(node.func, "id", None))
              for node in ast.walk(tree) if isinstance(node, ast.Call)}
    assert {"vit_forward", "vit_nll"} <= called, called
    own_steps = {"patchify", "patch_positions", "vit_attention",
                 "log_softmax"}
    assert not called & own_steps, called & own_steps

def test_vit_entry_point_defaults_to_the_card():
    from ray_tpu_torch.models import ViTConfig, init_vit_params
    cfg = ViTConfig(image_size=8, patch_size=4, d_model=32, n_layers=1,
                    n_heads=2, n_kv_heads=2, d_ff=32)
    assert init_vit_params(cfg, device="cpu")["head"].device.type == "cpu"
    if torch.cuda.is_available():
        assert init_vit_params(cfg)["head"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_vit_params(cfg)


RUNTIME_MODULES = (
    "__init__", "actor", "remote_function", "exceptions", "runtime_context",
    "util/metrics", "util/placement_group", "util/scheduling_strategies",
    "collective/collective", "_private/actor_checkpoint", "_private/backoff",
    "_private/chaos", "_private/config", "_private/connection_hub",
    "_private/device_object", "_private/durable", "_private/events",
    "_private/export", "_private/gcs", "_private/ids",
    "_private/log_monitor", "_private/node_manager", "_private/object_ref",
    "_private/object_store", "_private/object_transfer", "_private/pip_env",
    "_private/placement_group_manager", "_private/profiling",
    "_private/ref_counting", "_private/rpc", "_private/serialization",
    "_private/stats", "_private/task_manager", "_private/task_spec",
    "_private/wire_stats", "_private/worker", "_private/worker_core",
    "_private/worker_entry", "_private/worker_pool",
    "_private/worker_process", "_private/scheduler/native_policy")


def test_sources_cover_the_runtime():
    """The scan above reaches every module of the runtime core."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    missing = [m for m in RUNTIME_MODULES
               if f"ray_tpu_torch/{m}.py" not in names]
    assert not missing, missing


SERVE_MODULES = (
    "_private/nested_client", "_private/serve_stats", "serve/__init__",
    "serve/_private/__init__", "serve/_private/controller",
    "serve/_private/http_proxy", "serve/_private/ingress",
    "serve/_private/replica", "serve/_private/router")


def test_sources_cover_serve_and_the_nested_client():
    """The scan above reaches every module of Serve and the nested
    client that it stands on."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    missing = [m for m in SERVE_MODULES
               if f"ray_tpu_torch/{m}.py" not in names]
    assert not missing, missing


TRAIN_MODULES = (
    "train/__init__", "train/_session", "train/checkpoint", "train/ingest",
    "train/multislice", "train/torch", "train/trainer",
    "multislice/__init__", "multislice/dcn", "multislice/hierarchical",
    "multislice/slice_set")


def test_sources_cover_train_and_multislice():
    """The scan above reaches every module of the Train core and the
    multi-slice plane."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    missing = [m for m in TRAIN_MODULES
               if f"ray_tpu_torch/{m}.py" not in names]
    assert not missing, missing


MULTINODE_MODULES = (
    "cluster_utils", "_private/gcs_server", "_private/gcs_client",
    "_private/raylet_server", "_private/client_server")


def test_sources_cover_multinode():
    """The scan above reaches every module of the multi-node plane."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    missing = [m for m in MULTINODE_MODULES
               if f"ray_tpu_torch/{m}.py" not in names]
    assert not missing, missing


@pytest.mark.parametrize("module", ["ray_tpu_torch",
                                    "ray_tpu_torch._private.worker_process",
                                    "ray_tpu_torch.serve",
                                    "ray_tpu_torch.train",
                                    "ray_tpu_torch.multislice",
                                    "ray_tpu_torch._private.gcs_server",
                                    "ray_tpu_torch._private.raylet_server",
                                    "ray_tpu_torch._private.client_server",
                                    "ray_tpu_torch.cluster_utils"])
def test_runtime_imports_load_neither_torch_nor_jax(module):
    """A process worker imports ``worker_process`` (and so the package),
    and a replica in one imports Serve, a gang worker Train and a slice
    rank the multi-slice plane; the GCS, raylet and client-server
    processes start from their modules, and a driver imports
    ``cluster_utils``: in a fresh interpreter none of them loads torch
    or JAX (a GCS or raylet that imported torch would pay seconds at
    every start)."""
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in ('torch', 'jax', 'ray_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_init_needs_a_card_or_an_explicit_gpu_count():
    import ray_tpu_torch
    if torch.cuda.is_available():
        w = ray_tpu_torch.init(num_cpus=1, max_process_workers=1)
        try:
            assert w.cluster_resources()["GPU"] == torch.cuda.device_count()
        finally:
            ray_tpu_torch.shutdown()
    else:
        with pytest.raises(RuntimeError, match="num_gpus=0"):
            ray_tpu_torch.init(num_cpus=1, max_process_workers=1)
        assert not ray_tpu_torch.is_initialized()
    for num_gpus in (0, 2):
        w = ray_tpu_torch.init(num_cpus=1, num_gpus=num_gpus,
                               max_process_workers=1)
        try:
            res = ray_tpu_torch.cluster_resources()
            assert res.get("GPU", 0.0) == num_gpus and "TPU" not in res
        finally:
            ray_tpu_torch.shutdown()


_SESSION_CODE = {
    "single": ("import ray_tpu_torch as rt\n"
               "w = rt.init(num_cpus=1, num_gpus=0, max_process_workers=1)\n"
               "f = rt.remote(lambda x: x + 1)\n"
               "print(w.session, rt.get(f.remote(1)))\n"
               "rt.shutdown()\n"),
    # A GCS process and one remote raylet: each prints whether it
    # mapped libtorch, before the value line.
    "cluster": ("import ray_tpu_torch as rt\n"
                "from ray_tpu_torch.cluster_utils import Cluster\n"
                "from ray_tpu_torch.util.scheduling_strategies import (\n"
                "    NodeAffinitySchedulingStrategy as On)\n"
                "c = Cluster(num_gpus=0, head_num_cpus=1, start_gcs=True,\n"
                "            max_process_workers=1)\n"
                "n = c.add_node(num_cpus=1, remote=True)\n"
                "f = rt.remote(lambda x: x + 1)\n"
                "v = rt.get(f.options(scheduling_strategy=On(n.hex(),\n"
                "    soft=False)).remote(1), timeout=60)\n"
                "procs = [c._gcs_proc,\n"
                "         c.worker.node_group._remote_nodes[n].proc]\n"
                "print(['libtorch' in open(f'/proc/{p.pid}/maps').read()\n"
                "       for p in procs])\n"
                "print(c.worker.session, v)\n"
                "c.shutdown()\n"),
}


@pytest.mark.parametrize("depth,mode", [("short", "single"),
                                        ("long", "single"),
                                        ("short", "cluster")],
                         ids=["short", "long", "cluster"])
def test_session_files_live_under_tmpdir(tmp_path, depth, mode):
    """Every file a session writes on the host (session dir, the
    ``rtpt_current`` pointer) lands under ``TMPDIR``, and none in
    ``/tmp``. A ``TMPDIR`` too long for a unix socket path still starts
    process workers (the hub listens in the abstract namespace). A
    cluster's GCS process and remote raylet keep their address, log and
    state files in the head's and the node's session directories there,
    and neither loads torch."""
    tmpdir = tmp_path / ("d" * 90 if depth == "long" else "t")
    tmpdir.mkdir()
    env = dict(os.environ, TMPDIR=str(tmpdir))
    out = subprocess.run([sys.executable, "-c", _SESSION_CODE[mode]],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    session, value = out.stdout.split()[-2:]
    assert value == "2"
    ours = tmpdir / f"rtpt_{session}"
    assert (ours / "session_token").is_file()
    link = tmpdir / f"rtpt_current_{os.getuid()}"
    assert os.path.realpath(link) == str(ours)
    assert not any(name.startswith(f"rtpt_{session}")
                   for name in os.listdir("/tmp"))
    tmp_link = f"/tmp/rtpt_current_{os.getuid()}"
    assert not (os.path.lexists(tmp_link)
                and os.path.realpath(tmp_link) == str(ours))
    if mode == "cluster":
        assert out.stdout.splitlines()[-2] == "[False, False]"
        for name in ("gcs.addr", "gcs.log", "gcs_state.bin"):
            assert (ours / name).is_file(), name
        node = tmpdir / f"rtpt_{session}n1"
        assert [p.suffix for p in sorted(node.glob("raylet_*"))] \
            == [".addr", ".log"]
