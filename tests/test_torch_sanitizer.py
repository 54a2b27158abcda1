"""graftsan runtime enforcement on the port: the cases of
``tests/test_sanitizer.py`` pointed at ``ray_tpu_torch.devtools.sanitizer``,
and the seeded scenarios run under both packages' sanitizers.

Every scenario that installs the instrumented lock factories runs in
a SUBPROCESS: install() patches ``threading.Lock`` process-wide, and
the main pytest process must stay unpatched (that is itself the
zero-cost contract ``test_sanitizer_never_imported_when_off`` pins).
Scenario scripts live in tmp_path; the fixture manifest lists that
directory under ``extra_roots`` and keys ``lock_sites`` /
``blocking_escapes`` on absolute paths, so the scripts' locks are
instrumented and named without touching the committed manifest.
"""

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """\
import json, sys, threading, time
from ray_tpu_torch.devtools.sanitizer import report, runtime

MANIFEST = json.load(open(sys.argv[1]))
runtime.install(MANIFEST)
"""

_EPILOGUE = """
print("GRAFTSAN:" + json.dumps(
    [v.to_json() for v in report.reporter().snapshot()]))
"""


def _run_scenario(tmp_path, body, manifest=None, env=None,
                  prelude=_PRELUDE):
    """Run a scenario script under the sanitizer (the port's, or the
    JAX package's with ``prelude=_REF_PRELUDE``); returns
    (violations, completed process)."""
    man = {"version": 1, "lock_sites": {}, "orders": [], "guarded": {},
           "blocking_escapes": [], "extra_roots": [str(tmp_path)]}
    man.update(manifest or {})
    man_path = tmp_path / "manifest.json"
    man_path.write_text(json.dumps(man))
    script = tmp_path / "scenario.py"
    script.write_text(prelude + body + _EPILOGUE)
    full_env = dict(os.environ, PYTHONPATH=ROOT)
    full_env.update(env or {})
    proc = subprocess.run(
        [sys.executable, str(script), str(man_path)],
        capture_output=True, text=True, timeout=120, env=full_env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    for line in proc.stdout.splitlines():
        if line.startswith("GRAFTSAN:"):
            return json.loads(line[len("GRAFTSAN:"):]), proc
    raise AssertionError(f"no GRAFTSAN marker in:\n{proc.stdout}\n"
                         f"{proc.stderr}")


def _scenario_line(tmp_path, needle):
    src = (tmp_path / "scenario.py").read_text().splitlines()
    return next(i + 1 for i, ln in enumerate(src) if needle in ln)


# -- lock-order -------------------------------------------------------------


def test_abba_inversion_caught_with_both_stacks(tmp_path):
    """An AB/BA inversion actually executed (across two threads) is
    one violation carrying the acquisition stack of BOTH sides."""
    violations, _ = _run_scenario(tmp_path, """
A = threading.Lock()
B = threading.Lock()

def t1():
    with A:
        with B:      # records pair A -> B
            pass

th = threading.Thread(target=t1)
th.start()
th.join()
with B:
    with A:          # reverse pair: the inversion
        pass
""")
    inv = [v for v in violations if v["kind"] == "lock-order"]
    assert len(inv) == 1, violations
    v = inv[0]
    assert "inversion actually executed" in v["message"]
    assert len(v["stacks"]) == 2
    for stack in v["stacks"].values():
        assert "scenario.py" in stack     # a real traceback, per side
    labels = " ".join(v["stacks"])
    assert "->" in labels


def test_nested_same_order_is_clean(tmp_path):
    violations, _ = _run_scenario(tmp_path, """
A = threading.Lock()
B = threading.Lock()
for _ in range(3):
    with A:
        with B:
            pass
""")
    assert violations == []


def test_declared_order_violation_without_reverse_pair(tmp_path):
    """Acquiring against a declared `# lock-order:` is a violation
    even if the reverse pair is never executed — the declaration IS
    the contract."""
    body = """
A = threading.Lock()   # site-A
B = threading.Lock()   # site-B
with B:
    with A:
        pass
"""
    man_path = str(tmp_path / "scenario.py")
    # line numbers of the two creation sites inside the final script
    prelude_lines = _PRELUDE.count("\n")
    site_a = prelude_lines + 2      # body starts after the prelude
    site_b = prelude_lines + 3
    violations, _ = _run_scenario(tmp_path, body, manifest={
        "lock_sites": {
            f"{man_path}:{site_a}": {"name": "Fix.alpha"},
            f"{man_path}:{site_b}": {"name": "Fix.beta"},
        },
        "orders": [{"path": "scenario.py", "line": 1,
                    "nodes": ["Fix.alpha", "Fix.beta"],
                    "elements": ["alpha", "beta"]}],
    })
    decl = [v for v in violations if v["kind"] == "lock-order"]
    assert len(decl) == 1, violations
    assert "violates the declared order" in decl[0]["message"]
    assert "Fix.beta -> Fix.alpha" in decl[0]["message"] or (
        "Fix.beta" in decl[0]["message"])


def test_rlock_reentrancy_not_a_pair(tmp_path):
    """Reentrant re-acquisition must not self-pair or double-count."""
    violations, _ = _run_scenario(tmp_path, """
R = threading.RLock()
A = threading.Lock()
with R:
    with R:
        with A:
            pass
with A:
    pass             # A alone afterwards: no reverse pair exists
""")
    assert violations == []


def test_condition_aliases_its_lock(tmp_path):
    """Condition(lock) acquisition IS the underlying proxy's — waiting
    on the CV releases it for pair-tracking purposes too."""
    violations, _ = _run_scenario(tmp_path, """
L = threading.Lock()
cv = threading.Condition(L)
hit = []

def waiter():
    with cv:
        while not hit:
            cv.wait(timeout=5)

th = threading.Thread(target=waiter)
th.start()
time.sleep(0.05)
with cv:
    hit.append(1)
    cv.notify()
th.join()
assert not runtime._stack(), "acquisition stack should be empty"
""")
    assert violations == []


# -- guarded-by -------------------------------------------------------------


def test_guarded_write_without_lock_caught(tmp_path):
    violations, _ = _run_scenario(tmp_path, """
class Box:
    def __init__(self):
        self.lk = threading.Lock()
        self.val = 0          # __init__ writes are exempt

runtime.arm_class(Box, {"val": "lk"})
b = Box()
with b.lk:
    b.val = 1                 # disciplined write: clean
b.val = 2                     # UNGUARDED write
""")
    g = [v for v in violations if v["kind"] == "guarded-by"]
    assert len(g) == 1, violations
    assert "without lk held" in g[0]["message"]
    assert any("scenario.py" in s for s in g[0]["stacks"].values())


def test_guarded_write_under_lock_clean(tmp_path):
    violations, _ = _run_scenario(tmp_path, """
class Box:
    def __init__(self):
        self.lk = threading.Lock()
        self.val = 0

runtime.arm_class(Box, {"val": "lk"})
b = Box()
for i in range(5):
    with b.lk:
        b.val = i
assert b.val == 4
""")
    assert violations == []


def test_guarded_module_lock_lookup(tmp_path):
    """A guarded field whose lock lives at module scope resolves
    through the instance's module."""
    violations, _ = _run_scenario(tmp_path, """
import types
mod = types.ModuleType("scratch_guarded_mod")
mod.mlock = threading.Lock()
sys.modules["scratch_guarded_mod"] = mod
class Holder:
    pass
Holder.__module__ = "scratch_guarded_mod"
mod.Holder = Holder
runtime.arm_class(Holder, {"state": "mlock"})
h = Holder()
def poke():
    h.state = 1               # unguarded, outside __init__
poke()
with mod.mlock:
    h.state = 2               # guarded: clean
""")
    g = [v for v in violations if v["kind"] == "guarded-by"]
    assert len(g) == 1, violations


def test_arm_disarm_restores_class(tmp_path):
    violations, _ = _run_scenario(tmp_path, """
class Box:
    def __init__(self):
        self.lk = threading.Lock()
        self.val = 0

orig = Box.__dict__.get("val")
runtime.arm_class(Box, {"val": "lk"})
assert isinstance(Box.__dict__["val"], runtime.GuardedAttr)
runtime.disarm()
assert Box.__dict__.get("val") is orig
b = Box()
b.val = 7                     # disarmed: no enforcement
assert b.val == 7
""")
    assert violations == []


# -- blocking probes --------------------------------------------------------


def test_sleep_under_lock_caught(tmp_path):
    violations, _ = _run_scenario(tmp_path, """
L = threading.Lock()
with L:
    time.sleep(0.001)
""")
    b = [v for v in violations if v["kind"] == "blocking-under-lock"]
    assert len(b) == 1, violations
    assert "time.sleep" in b[0]["message"]


def test_blocking_ok_lock_escape_does_not_fire(tmp_path):
    """A lock whose definition carries `# blocking-ok:` (compiled into
    the manifest's lock_sites escape) may be held across blocking
    calls — the probe provably stands down."""
    body = """
L = threading.Lock()   # the designed-escape lock
assert L.escape == "send atomicity", L
with L:
    time.sleep(0.001)
"""
    script = str(tmp_path / "scenario.py")
    line = _PRELUDE.count("\n") + 2
    violations, _ = _run_scenario(tmp_path, body, manifest={
        "lock_sites": {f"{script}:{line}":
                       {"name": "Fix.sendish",
                        "escape": "send atomicity"}},
    })
    assert violations == []


def test_blocking_ok_site_escape_does_not_fire(tmp_path):
    """A `# blocking-ok:` annotated CALL site (compiled into
    blocking_escapes spans) stands the probe down for calls running
    under it, while the same blocking call elsewhere still fires."""
    body = """
L = threading.Lock()

def escorted():
    time.sleep(0.001)          # ESCAPED-SPAN

with L:
    escorted()
with L:
    time.sleep(0.001)          # not escaped: fires
"""
    script = str(tmp_path / "scenario.py")
    line = _PRELUDE.count("\n") + 5      # the ESCAPED-SPAN line
    violations, _ = _run_scenario(tmp_path, body, manifest={
        "blocking_escapes": [{"path": script, "line": line,
                              "end": line}],
    })
    b = [v for v in violations if v["kind"] == "blocking-under-lock"]
    assert len(b) == 1, violations


def test_rpc_send_frame_probe_fires_for_foreign_lock(tmp_path):
    """The env-gated rpc tail wraps _send_frame; sending while holding
    an unrelated instrumented lock is a violation, while the internal
    _send_lock (designed escape) stays quiet."""
    violations, _ = _run_scenario(tmp_path, """
import os
os.environ["RTPU_SANITIZE"] = "1"
import socket
from ray_tpu_torch._private import rpc

assert getattr(rpc._send_frame, "__graftsan_wrapped__", None), (
    "rpc probe tail not installed")
a, b = socket.socketpair()
FOREIGN = threading.Lock()
with FOREIGN:
    rpc._send_frame(a, ("ping",), None)
a.close(); b.close()
""", env={"RTPU_SANITIZE": "1"})
    b = [v for v in violations if v["kind"] == "blocking-under-lock"]
    assert len(b) == 1, violations
    assert "rpc._send_frame" in b[0]["message"]


# -- install / arm lifecycle ------------------------------------------------


def test_sanitizer_never_imported_when_off():
    """RTPU_SANITIZE unset: zero overhead means the sanitizer package
    is never even imported and nothing is patched."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("RTPU_SANITIZE", None)
    code = (
        "import sys, threading, time\n"
        "import ray_tpu_torch\n"
        "assert 'ray_tpu_torch.devtools.sanitizer' not in sys.modules\n"
        "assert 'ray_tpu_torch.devtools.sanitizer.runtime' not in sys.modules\n"
        "assert getattr(threading.Lock, '__name__', '') != '_lock_factory'\n"
        "assert getattr(time.sleep, '__name__', '') != '_sleep_probe'\n"
        "lk = threading.Lock()\n"
        "assert type(lk).__module__ == '_thread'\n"
        "print('OFF-OK')\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert "OFF-OK" in proc.stdout


def test_import_ray_tpu_torch_installs_and_arms():
    """RTPU_SANITIZE=1: import ray_tpu_torch patches the factories, loads
    the committed manifest, and arms the guarded descriptors on the
    annotated classes (arming must not silently no-op)."""
    env = dict(os.environ, PYTHONPATH=ROOT, RTPU_SANITIZE="1",
               JAX_PLATFORMS="cpu")
    code = (
        "import threading\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch.devtools import sanitizer\n"
        "from ray_tpu_torch.devtools.sanitizer import runtime\n"
        "assert sanitizer.installed()\n"
        "assert threading.Lock.__name__ == '_lock_factory'\n"
        "from ray_tpu_torch.serve._private.router import ReplicaSet\n"
        "assert isinstance(ReplicaSet.__dict__.get('_replicas'),\n"
        "                  runtime.GuardedAttr)\n"
        "from ray_tpu_torch._private.rpc import ConnectionContext\n"
        "import socket\n"
        "a, b = socket.socketpair()\n"
        "ctx = ConnectionContext(a, ('x', 0))\n"
        "assert ctx._send_lock.escape, 'designed escape lost'\n"
        "assert ctx._send_lock.name == 'ConnectionContext._send_lock'\n"
        "a.close(); b.close()\n"
        "runtime.uninstall()\n"
        "assert threading.Lock is runtime._real_lock\n"
        "import time\n"
        "assert time.sleep is runtime._real_sleep\n"
        "print('ARM-OK')\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=180,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert "ARM-OK" in proc.stdout


def test_uninstall_restores_factories(tmp_path):
    violations, _ = _run_scenario(tmp_path, """
assert threading.Lock.__name__ == "_lock_factory"
runtime.uninstall()
assert threading.Lock is runtime._real_lock
assert threading.RLock is runtime._real_rlock
assert threading.Condition is runtime._real_condition
assert time.sleep is runtime._real_sleep
lk = threading.Lock()
assert type(lk).__module__ == "_thread"
""")
    assert violations == []


# -- observed-pair export & --diff ------------------------------------------


def test_observed_pairs_diff_cli(tmp_path):
    """Pairs the sanitizer observed but no `# lock-order:` covers are
    reported by the --diff CLI (exit 1); covered pairs exit 0."""
    obs = tmp_path / "observed.jsonl"
    _run_scenario(tmp_path, """
A = threading.Lock()
B = threading.Lock()
with A:
    with B:
        pass
""", env={"RTPU_SANITIZE_OBSERVED": str(obs)})
    assert obs.exists() and obs.read_text().strip(), (
        "observed-pair dump missing")
    rec = json.loads(obs.read_text().splitlines()[0])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.sanitizer",
         "--diff", str(obs)],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert rec["held"] in proc.stdout
    # a manifest declaring exactly that order covers the pair
    man = tmp_path / "covering.json"
    man.write_text(json.dumps({
        "version": 1,
        "orders": [{"path": "x", "line": 1, "elements": [],
                    "nodes": [rec["held"], rec["acquired"]]}]}))
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.sanitizer",
         "--diff", str(obs), "--manifest", str(man)],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- documentation agreement ------------------------------------------------


def test_docs_lock_order_table_matches_declarations():
    """Every row of the per-module lock-order table in
    ray_tpu_torch/docs/static_analysis.md must have a machine-readable
    `# lock-order:` declaration with the same elements in the named
    source file — prose and contract cannot drift apart."""
    doc = open(os.path.join(ROOT, "ray_tpu_torch", "docs",
                            "static_analysis.md"),
               encoding="utf-8").read()
    rows = re.findall(r"^\|\s*`([\w/.]+\.py)`\s*\|\s*`([^`]+)`",
                      doc, flags=re.M)
    rows = [(p, o) for p, o in rows if "->" in o]
    assert len(rows) >= 4, f"lock-order table went missing: {rows}"
    for path, order in rows:
        src = open(os.path.join(ROOT, "ray_tpu_torch", path),
                   encoding="utf-8").read()
        declared = [re.sub(r"\s+", " ", m).strip() for m in
                    re.findall(r"#\s*lock-order:\s*(.+)", src)]
        want = re.sub(r"\s+", " ", order).strip()
        assert any(want == d for d in declared), (
            f"docs claim `{want}` for {path} but the file declares "
            f"{declared} — fix the docs or the annotation")


def test_docs_table_covers_all_declarations():
    """...and the other direction: every multi-element declared order
    in the runtime tree appears in the docs table."""
    from ray_tpu_torch.devtools.analysis import contracts

    m = contracts.load_manifest()
    doc = open(os.path.join(ROOT, "ray_tpu_torch", "docs",
                            "static_analysis.md"),
               encoding="utf-8").read()
    for decl in m["orders"]:
        if decl["path"].startswith("tests/"):
            continue
        want = " -> ".join(decl["elements"])
        assert want in doc, (
            f"declared order `{want}` ({decl['path']}:{decl['line']}) "
            "is missing from the ray_tpu_torch/docs/static_analysis.md "
            "table")


# -- sanitized chaos smoke --------------------------------------------------


@pytest.mark.slow
def test_chaos_suite_clean_under_sanitizer(tmp_path):
    """The port's chaos tests run under RTPU_SANITIZE=1 with zero
    violations: fault injection drives the runtime through
    retry/sever/dup paths while every declared contract holds. The
    conftest autouse fixture fails any test that produces one, so a
    plain exit-0 run IS the zero-violations assertion."""
    log = tmp_path / "graftsan.jsonl"
    env = dict(os.environ, PYTHONPATH=ROOT, RTPU_SANITIZE="1",
               RTPU_SANITIZE_LOG=str(log), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-x",
         "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_torch_chaos.py")],
        capture_output=True, text=True, timeout=570, env=env,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    leftover = [ln for ln in
                (log.read_text().splitlines() if log.exists() else [])
                if ln.strip()]
    assert not leftover, f"sanitized chaos run logged: {leftover}"


# -- regressions found by the sanitizer -------------------------------------


def test_complete_task_stores_outside_manager_lock():
    """Regression for a graftsan-caught AB/BA inversion: the
    store_result callback fans out to NodeManagerGroup._lock
    (on_object_available) while the steal path holds the group lock
    and calls back into get_record — so complete_task must invoke the
    callback only AFTER TaskManager._lock releases, exactly like it
    already did for the resubmit callback."""
    from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID
    from ray_tpu_torch._private.task_manager import TaskManager
    from ray_tpu_torch._private.task_spec import (FunctionDescriptor,
                                            TaskSpec, TaskType)

    held_during_store = []
    tm = TaskManager(
        store_result=lambda oid, entry: held_during_store.append(
            tm._lock._is_owned()),
        resubmit=lambda spec: None,
        on_task_arg_release=lambda oid: None)
    job = JobID.from_int(1)
    tid = TaskID.for_normal_task(job)
    spec = TaskSpec(
        task_id=tid, job_id=job, task_type=TaskType.NORMAL_TASK,
        function=FunctionDescriptor(b"f" * 28, "mod", "fn"),
        args=[], kwargs_keys=[], num_returns=1, resources={},
        return_ids=[ObjectID.from_index(tid, 1)])
    tm.add_pending_task(spec)
    tm.mark_running(tid)
    tm.complete_task(
        tid, [(spec.return_ids[0].binary(), "inline", b"x", ())], None)
    assert held_during_store == [False], (
        "result stored while TaskManager._lock was still held")
    # failure path defers the same way
    tid2 = TaskID.for_normal_task(job)
    spec2 = TaskSpec(
        task_id=tid2, job_id=job, task_type=TaskType.NORMAL_TASK,
        function=FunctionDescriptor(b"g" * 28, "mod", "fn"),
        args=[], kwargs_keys=[], num_returns=1, resources={},
        return_ids=[ObjectID.from_index(tid2, 1)])
    tm.add_pending_task(spec2)
    import pickle
    tm.complete_task(tid2, [], pickle.dumps(ValueError("boom")))
    assert held_during_store == [False, False]


# -- the port beside the JAX package ----------------------------------------


_REF_PRELUDE = _PRELUDE.replace("ray_tpu_torch.devtools", "ray_tpu.devtools")

_SEEDED = {
    "abba": """
A = threading.Lock()
B = threading.Lock()

def t1():
    with A:
        with B:
            pass

th = threading.Thread(target=t1)
th.start()
th.join()
with B:
    with A:
        pass
""",
    "guarded_write": """
class Box:
    def __init__(self):
        self.lk = threading.Lock()
        self.val = 0

runtime.arm_class(Box, {"val": "lk"})
b = Box()
with b.lk:
    b.val = 1
b.val = 2
""",
    "sleep_under_lock": """
L = threading.Lock()
with L:
    time.sleep(0.001)
""",
}


@pytest.mark.parametrize("name", sorted(_SEEDED))
def test_seeded_scenarios_match_reference(tmp_path, name):
    """The same seeded script gives the same violations (kind and
    message) under both packages' sanitizers."""
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    ours, _ = _run_scenario(tmp_path / "port", _SEEDED[name])
    theirs, _ = _run_scenario(tmp_path / "ref", _SEEDED[name],
                              prelude=_REF_PRELUDE)
    assert ours, name
    assert sorted(v["kind"] for v in ours) == \
        sorted(v["kind"] for v in theirs)

    def text(v, root):
        return v["message"].replace(str(root), "<root>")

    assert sorted(text(v, tmp_path / "port") for v in ours) == \
        sorted(text(v, tmp_path / "ref") for v in theirs)


def test_reference_locks_stay_raw(tmp_path):
    """A process that imports both packages under the port's sanitizer
    wraps only the port's locks: the JAX package's module-level lock in
    ``ray_tpu/_private/native_loader.py`` stays a raw lock (its
    directory's name is a prefix of the port's), the port's is a proxy
    named by the committed manifest."""
    from ray_tpu_torch.devtools.analysis import contracts

    man = contracts.load_manifest()
    violations, proc = _run_scenario(tmp_path, """
import ray_tpu._private.native_loader as ref_loader
import ray_tpu_torch._private.native_loader as port_loader
assert type(ref_loader._lock).__module__ == "_thread", ref_loader._lock
assert isinstance(port_loader._lock, runtime._RLockProxy), port_loader._lock
print("NAME:" + port_loader._lock.name)
""", manifest={"lock_sites": man["lock_sites"]})
    assert violations == []
    assert ("NAME:mod:ray_tpu_torch/_private/native_loader.py._lock"
            in proc.stdout), proc.stdout


def test_durable_probe_fires_for_foreign_lock(tmp_path):
    """The env-gated durable tail wraps the atomic writers: a durable
    write while holding an instrumented lock is a violation."""
    violations, _ = _run_scenario(tmp_path, """
import os
from ray_tpu_torch._private import durable

assert getattr(durable.atomic_write_bytes, "__graftsan_wrapped__", None), (
    "durable probe tail not installed")
FOREIGN = threading.Lock()
with FOREIGN:
    durable.atomic_write_bytes(os.path.join(os.getcwd(), "blob"), b"x")
""", env={"RTPU_SANITIZE": "1"})
    # the outer writer and the two probed calls it makes, each once
    b = sorted(v["key"].split("|")[0] for v in violations
               if v["kind"] == "blocking-under-lock")
    assert b == ["durable.atomic_write", "durable.atomic_write_bytes",
                 "durable.fsync_dir"], violations


def test_log_is_read_by_the_reference_reader(tmp_path):
    """The port's JSONL violation log keeps the JAX package's format:
    ``tests/conftest.py`` reads it with the reference's ``read_log``, so
    a port child's violation fails the test that produced it."""
    from ray_tpu.devtools.sanitizer.report import read_log

    log = tmp_path / "graftsan.jsonl"
    violations, _ = _run_scenario(tmp_path, _SEEDED["sleep_under_lock"],
                                  env={"RTPU_SANITIZE_LOG": str(log)})
    logged, offset = read_log(str(log), 0)
    assert offset == os.path.getsize(log)
    assert [(r["kind"], r["key"]) for r in logged] == \
        [(v["kind"], v["key"]) for v in violations]
    assert logged[0]["kind"] == "blocking-under-lock"
