"""graftcheck's whole-tree gates on the port: the cases of
``tests/test_static_analysis.py`` that analyse the whole package,
pointed at ``ray_tpu_torch/``, and the port's tree analysed by both
packages' suites.

``test_repo_tree_is_clean`` is the tier-1 ratchet: the suite must exit
0 over ``ray_tpu_torch/`` (unsuppressed findings fail the build). One
cold run, made by a module fixture, serves every case that only needs
a run of the tree (the reference repeats it: its clean-tree gate, the
cache warm-ups of its speed bounds); the JAX package's analysis of the
same tree runs beside it in a second process.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from ray_tpu_torch.devtools.analysis import run_analysis
from ray_tpu_torch.devtools.analysis.core import CACHE_BASENAME

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(ROOT, "ray_tpu_torch")

_REFERENCE_SCAN = """\
import json, sys
from ray_tpu.devtools.analysis import run_analysis
_, found = run_analysis([sys.argv[1]], use_cache=False)
json.dump([f.to_json() for f in found], open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def cold(tmp_path_factory):
    """The enforced invocation, cold (the port's cache removed first, so
    no stale entry can hide a finding; the run then warms the cache for
    the speed bounds), beside the JAX package's analysis of the same
    tree (no cache: it must not write the reference's cache file)."""
    out = tmp_path_factory.mktemp("graftcheck") / "reference.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_SCAN, TREE, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT)
    try:
        os.remove(os.path.join(ROOT, CACHE_BASENAME))
    except FileNotFoundError:
        pass
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.analysis", TREE],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    elapsed = time.perf_counter() - t0
    ref_out, ref_err = ref.communicate(timeout=300)
    assert ref.returncode == 0, ref_err
    with open(out, encoding="utf-8") as f:
        reference = json.load(f)
    return {"proc": proc, "seconds": elapsed, "reference": reference}


def test_repo_tree_is_clean(cold):
    """The enforcement gate: `python -m ray_tpu_torch.devtools.analysis
    ray_tpu_torch/` exits 0 — zero unsuppressed findings on the tree."""
    proc = cold["proc"]
    assert proc.returncode == 0, (
        f"graftcheck found unsuppressed issues:\n{proc.stdout}"
        f"\n{proc.stderr}")
    assert "graftcheck: 0 finding(s)" in proc.stdout


def test_cached_full_suite_stays_fast(cold):
    """CI-hygiene bound: a warm-cache re-run of all sixteen passes over
    the whole tree must stay comfortably inside the tier-1 budget
    (< 5s with generous headroom). The module's cold run warmed the
    cache."""
    t0 = time.perf_counter()
    unsuppressed, _ = run_analysis([TREE], use_cache=True)
    elapsed = time.perf_counter() - t0
    assert unsuppressed == []
    assert elapsed < 5.0, f"cached graftcheck re-run took {elapsed:.2f}s"


def test_ci_mode_aggregates(cold):
    """`--ci` is the one-flag CI gate: full tree, timings printed,
    exit 0 on a clean tree — and a warm-cache run stays inside the
    10 s budget.  Scan-shaping flags are rejected (exit 2)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "ray_tpu_torch.devtools.analysis", "--ci"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    elapsed = time.perf_counter() - t0
    assert proc.returncode == 0, (
        f"--ci found unsuppressed issues:\n{proc.stdout}\n{proc.stderr}")
    assert "timing " in proc.stdout                # --timings implied
    assert "graftcheck: 0 finding(s)" in proc.stdout
    assert elapsed < 10.0, f"cached --ci run took {elapsed:.2f}s"

    proc = subprocess.run(cmd + ["ray_tpu_torch/"], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 2
    assert "aggregate mode" in proc.stderr


def test_contract_manifest_in_sync(cold):
    """The committed contracts.json must equal what --emit-contracts
    produces from the current tree: annotations changed without
    re-emitting would hand graftsan a stale contract.  The committed
    baseline must also only suppress passes that still exist."""
    from ray_tpu_torch.devtools.analysis import contracts
    from ray_tpu_torch.devtools.analysis.core import default_baseline_path
    from ray_tpu_torch.devtools.analysis.passes import load_passes

    path = contracts.default_manifest_path()
    assert os.path.exists(path), (
        "no committed contract manifest; run "
        "`python -m ray_tpu_torch.devtools.analysis --emit-contracts`")
    fresh = contracts.render_manifest(contracts.emit_contracts())
    with open(path, encoding="utf-8") as f:
        committed = f.read()
    assert committed == fresh, (
        "contracts.json is stale — re-run "
        "`python -m ray_tpu_torch.devtools.analysis --emit-contracts`")

    live = {p.PASS_ID for p in load_passes()}
    with open(default_baseline_path(), encoding="utf-8") as f:
        baselined = {e["pass"] for e in json.load(f)["findings"]}
    assert baselined <= live, (
        f"baseline.json suppresses nonexistent pass(es) "
        f"{sorted(baselined - live)} — prune the stale entries")


def test_contract_manifest_contents():
    """Schema spot-checks on the committed manifest: the declared
    orders, the guarded map, and the designed `# blocking-ok:` escapes
    all survive compilation with class-qualified identities."""
    from ray_tpu_torch.devtools.analysis import contracts

    m = contracts.load_manifest()
    assert m is not None and m["version"] == contracts.MANIFEST_VERSION
    order_nodes = [tuple(o["nodes"]) for o in m["orders"]]
    assert ("RayletServer._push_order_lock", "RayletServer._push_lock",
            "ConnectionContext._send_lock") in order_nodes
    assert ("Worker._gang_lock", "Worker._actor_lock") in order_nodes
    router = m["guarded"]["ray_tpu_torch/serve/_private/router.py"]
    assert router["ReplicaSet"]["_replicas"] == "_lock"
    assert router["ReplicaSet"]["_inflight"] == "_lock"
    sites = m["lock_sites"]
    escapes = {v["name"]: v.get("escape") for v in sites.values()}
    assert escapes.get("ConnectionContext._send_lock"), (
        "_send_lock must carry its designed blocking-ok escape")
    assert m["chaos_points"], "chaos fire() sites must be compiled"
    # every manifest path is the port's, never the JAX package's
    paths = set(m["guarded"]) | {k.rsplit(":", 1)[0] for k in sites}
    assert paths and all(p.startswith("ray_tpu_torch/") for p in paths)
    # the kernel build's designed escape: the loader's lock IS the
    # build serialization
    loader = [e for e in m["blocking_escapes"]
              if e["path"] == "ray_tpu_torch/_private/native_loader.py"]
    assert len(loader) == 2, loader


def test_baseline_holds_only_the_reference_counterparts():
    """The port's baseline accepts exactly the counterparts of the JAX
    package's two entries: the retained but uncalled RPC handlers."""
    from ray_tpu.devtools.analysis.core import (
        default_baseline_path as ref_baseline_path)
    from ray_tpu_torch.devtools.analysis.core import default_baseline_path

    def entries(path, pkg):
        with open(path, encoding="utf-8") as f:
            return sorted((e["pass"], e["path"][len(pkg):], e["context"],
                           e["message"])
                          for e in json.load(f)["findings"])

    ours = entries(default_baseline_path(), "ray_tpu_torch/")
    theirs = entries(ref_baseline_path(), "ray_tpu/")
    assert ours == theirs
    assert {e[0] for e in ours} == {"rpc-surface"} and len(ours) == 2


def test_tree_findings_match_reference(cold):
    """Both packages' suites over ``ray_tpu_torch/`` give the same
    findings, apart from the port's adaptations: its metric and chaos
    doc contracts read ``ray_tpu_torch/docs/`` and only
    ``tests/test_torch_*.py`` (the reference reads the repo's ``docs/``
    and every test), the metric pass's message names the port's docs
    directory, and ref-leak knows the name ``ray_tpu_torch``. On
    today's tree none of them moves a finding, so the sets are equal
    but for those passes' wording."""
    _, ours = run_analysis([TREE], use_cache=True)

    def key(d):
        msg = d["message"].replace("metric registry in ray_tpu_torch/docs/",
                                   "metric registry in docs/")
        return (d["pass"], d["path"], d["line"], d["context"], msg)

    assert sorted(key(f.to_json()) for f in ours) == \
        sorted(key(d) for d in cold["reference"])
    assert len(ours) == 2, [f.render() for f in ours]
