"""graftcheck self-tests on the port: the cases of
``tests/test_static_analysis.py`` pointed at
``ray_tpu_torch.devtools.analysis``, and each fixture of
``tests/analysis_fixtures/`` held finding for finding against the JAX
package's analysis.

Each fixture test pins one pass's detection on a seeded violation; the
clean fixture pins the false-positive floor. The whole-tree gates (the
port's tree is clean, ``--ci``, the contract manifest in sync, the
warm-cache bounds) are in ``test_torch_static_analysis_tree.py``, so
that ``--dist loadfile`` runs the two files side by side.

Adaptations of the port, each held by a case here: the cache file is
``.rtpu_torch_analysis_cache.json``; the metric and chaos doc contracts
read ``ray_tpu_torch/docs/*.md``; chaos coverage reads only
``tests/test_torch_*.py``; ref-leak knows the name ``ray_tpu_torch``.
"""

import json
import os

import pytest

from ray_tpu_torch.devtools.analysis import run_analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "analysis_fixtures")


def _fixture(name: str) -> str:
    return os.path.join(FIXTURES, name)


def _run(paths, **kw):
    kw.setdefault("use_cache", False)
    return run_analysis(paths, **kw)




def test_lock_discipline_flags_unlocked_mutation():
    unsuppressed, _ = _run([_fixture("bad_lock.py")])
    hits = [f for f in unsuppressed if f.pass_id == "lock-discipline"]
    assert len(hits) == 1
    assert "_entries" in hits[0].message
    assert hits[0].context == "Ledger.drop"


def test_async_blocking_flags_sync_sleep():
    unsuppressed, _ = _run([_fixture("bad_async.py")])
    hits = [f for f in unsuppressed if f.pass_id == "async-blocking"]
    assert len(hits) == 1
    assert "asyncio.sleep" in hits[0].message
    assert hits[0].context == "Poller.poll"


def test_rpc_surface_flags_drift_both_ways():
    unsuppressed, _ = _run([_fixture("bad_rpc.py")])
    hits = [f for f in unsuppressed if f.pass_id == "rpc-surface"]
    messages = " | ".join(f.message for f in hits)
    assert "not_registered_anywhere" in messages   # orphaned caller
    assert "orphaned_handler" in messages          # orphaned handler
    assert len(hits) == 2


def test_silent_exception_flags_undocumented_swallow():
    unsuppressed, _ = _run([_fixture("bad_silent.py")])
    hits = [f for f in unsuppressed if f.pass_id == "silent-exception"]
    assert len(hits) == 1
    assert hits[0].context == "risky"


def test_ref_leak_flags_dead_and_discarded_refs():
    unsuppressed, _ = _run([_fixture("bad_refleak.py")])
    hits = [f for f in unsuppressed if f.pass_id == "ref-leak"]
    assert len(hits) == 2
    messages = " | ".join(f.message for f in hits)
    assert "'ref'" in messages                     # dead local
    assert "discarded" in messages                 # bare expression


def test_retry_discipline_flags_deadlineless_call():
    unsuppressed, _ = _run([_fixture("bad_retry.py")])
    hits = [f for f in unsuppressed if f.pass_id == "retry-discipline"]
    assert len(hits) == 1
    assert "'fetch_state'" in hits[0].message
    assert hits[0].context == "Courier.bad"


def test_retry_discipline_scoped_to_private_tree(tmp_path):
    """Outside _private/ (and the fixture tree) the pass stays quiet:
    library layers talk through already-deadlined seams."""
    mod = tmp_path / "lib.py"
    mod.write_text("def f(c):\n    return c.call('x')\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    assert [f for f in unsuppressed
            if f.pass_id == "retry-discipline"] == []
    priv = tmp_path / "_private"
    priv.mkdir()
    mod2 = priv / "lib.py"
    mod2.write_text("def f(c):\n    return c.call('x')\n")
    unsuppressed, _ = _run([str(mod2)], root=str(tmp_path))
    assert len([f for f in unsuppressed
                if f.pass_id == "retry-discipline"]) == 1


def test_bounded_queue_flags_unbounded_constructions():
    unsuppressed, _ = _run([_fixture("bad_queue.py")])
    hits = [f for f in unsuppressed if f.pass_id == "bounded-queue"]
    # bare deque(), bare Queue(), and Queue(0) — the stdlib's
    # spelled-out-infinite maxsize — are all flagged
    assert len(hits) == 3
    messages = " | ".join(f.message for f in hits)
    assert "deque()" in messages and "Queue()" in messages
    assert all(h.context == "Mailbox.__init__" for h in hits)


def test_bounded_queue_scoped_to_private_tree(tmp_path):
    """Outside _private/ (and the fixture tree) the pass stays quiet:
    library layers buffer user data under user-visible knobs."""
    mod = tmp_path / "lib.py"
    mod.write_text("from collections import deque\nq = deque()\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    assert [f for f in unsuppressed
            if f.pass_id == "bounded-queue"] == []
    priv = tmp_path / "_private"
    priv.mkdir()
    mod2 = priv / "lib.py"
    mod2.write_text("from collections import deque\nq = deque()\n")
    unsuppressed, _ = _run([str(mod2)], root=str(tmp_path))
    assert len([f for f in unsuppressed
                if f.pass_id == "bounded-queue"]) == 1


def test_bounded_queue_accepts_annotation_block_above(tmp_path):
    """The unbounded-ok annotation may sit in the contiguous comment
    block above the construction — but an unrelated comment block, or
    one separated by code, does not suppress."""
    priv = tmp_path / "_private"
    priv.mkdir()
    mod = priv / "mod.py"
    mod.write_text(
        "from collections import deque\n"
        "# unbounded-ok: drained by the loop below\n"
        "a = deque()\n"
        "# some unrelated comment\n"
        "b = deque()\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "bounded-queue"]
    assert len(hits) == 1 and hits[0].line == 5
    # a CODE line with a trailing comment ends the block: the
    # annotation above it must not leak through to later constructions
    mod2 = priv / "mod2.py"
    mod2.write_text(
        "from collections import deque\n"
        "# unbounded-ok: only for the next line\n"
        "a = deque()  # the annotated one\n"
        "b = deque()\n")
    unsuppressed, _ = _run([str(mod2)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "bounded-queue"]
    assert len(hits) == 1 and hits[0].line == 4


def test_deadline_discipline_flags_clockless_poll_loop():
    """The fixture's `bad` loop (sleep-poll, no clock) is flagged; the
    deadline-checking `good` loop and the `# no-deadline:` annotated
    daemon loop are not."""
    unsuppressed, _ = _run([_fixture("bad_deadline.py")])
    hits = [f for f in unsuppressed if f.pass_id == "deadline-discipline"]
    assert len(hits) == 1
    assert hits[0].context == "Poller.bad"
    assert "sleep-poll" in hits[0].message


def test_deadline_discipline_scoped_to_runtime_trees(tmp_path):
    """Outside _private/ and collective/ (and the fixtures) the pass
    stays quiet; inside either runtime tree it fires."""
    src = ("import time\n"
           "def f(flag):\n"
           "    while not flag():\n"
           "        time.sleep(0.01)\n")
    mod = tmp_path / "lib.py"
    mod.write_text(src)
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    assert [f for f in unsuppressed
            if f.pass_id == "deadline-discipline"] == []
    for tree in ("_private", "collective"):
        sub = tmp_path / tree
        sub.mkdir()
        mod2 = sub / "lib.py"
        mod2.write_text(src)
        unsuppressed, _ = _run([str(mod2)], root=str(tmp_path))
        assert len([f for f in unsuppressed
                    if f.pass_id == "deadline-discipline"]) == 1


def test_deadline_discipline_ignores_event_wait_loops(tmp_path):
    """Only bare sleep polling is in scope: Event.wait(timeout) loops
    carry their own bound, and a nested function's sleep belongs to
    whatever scope runs it."""
    priv = tmp_path / "_private"
    priv.mkdir()
    mod = priv / "mod.py"
    mod.write_text(
        "import time\n"
        "def f(ev, q):\n"
        "    while not ev.is_set():\n"
        "        ev.wait(0.1)\n"
        "    while q:\n"
        "        def cb():\n"
        "            time.sleep(1)\n"
        "        q.pop()(cb)\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    assert [f for f in unsuppressed
            if f.pass_id == "deadline-discipline"] == []


def test_deadline_discipline_accepts_from_import_clock(tmp_path):
    """A compliant loop written with `from time import monotonic,
    sleep` must not be flagged: the clock check accepts the same
    bare-name spellings the sleep check does."""
    priv = tmp_path / "_private"
    priv.mkdir()
    mod = priv / "mod.py"
    mod.write_text(
        "from time import monotonic, sleep\n"
        "def f(flag):\n"
        "    deadline = monotonic() + 5.0\n"
        "    while not flag():\n"
        "        if monotonic() > deadline:\n"
        "            raise TimeoutError\n"
        "        sleep(0.01)\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    assert [f for f in unsuppressed
            if f.pass_id == "deadline-discipline"] == []


def test_retry_and_queue_passes_cover_collective_tree(tmp_path):
    """The retry-discipline and bounded-queue scopes include
    collective/ (the gang plane is runtime core too)."""
    coll = tmp_path / "collective"
    coll.mkdir()
    mod = coll / "mod.py"
    mod.write_text(
        "from collections import deque\n"
        "q = deque()\n"
        "def f(c):\n"
        "    return c.call('x')\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    ids = sorted(f.pass_id for f in unsuppressed)
    assert "bounded-queue" in ids and "retry-discipline" in ids


def test_durable_write_flags_raw_binary_writes():
    """bad_durable.py: the raw open-wb, the pickle.dump (and the raw
    open feeding it), and the in-place np.savez are flagged; reads,
    text writes, the annotated append stream, and the helper-routed
    write are not."""
    unsuppressed, _ = _run([_fixture("bad_durable.py")])
    hits = [f for f in unsuppressed if f.pass_id == "durable-write"]
    assert len(hits) == 4
    messages = " | ".join(f.message for f in hits)
    assert "open(..., 'wb')" in messages
    assert "pickle.dump(...)" in messages
    assert "np.savez(...)" in messages
    assert {h.context for h in hits} == {"bad_open", "bad_pickle",
                                         "bad_savez"}


def test_durable_write_scoped_to_private_and_train(tmp_path):
    """Outside _private/ and train/ (and the fixtures) the pass stays
    quiet; inside either tree it fires; the durable helper module
    itself is exempt (it IS the tmp+fsync+rename pattern)."""
    src = "def f(path, b):\n    open(path, 'wb').write(b)\n"
    mod = tmp_path / "lib.py"
    mod.write_text(src)
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    assert [f for f in unsuppressed
            if f.pass_id == "durable-write"] == []
    for tree in ("_private", "train"):
        sub = tmp_path / tree
        sub.mkdir(exist_ok=True)
        mod2 = sub / "lib.py"
        mod2.write_text(src)
        unsuppressed, _ = _run([str(mod2)], root=str(tmp_path))
        assert len([f for f in unsuppressed
                    if f.pass_id == "durable-write"]) == 1
    exempt = tmp_path / "_private" / "durable.py"
    exempt.write_text(src)
    unsuppressed, _ = _run([str(exempt)], root=str(tmp_path))
    assert [f for f in unsuppressed
            if f.pass_id == "durable-write"] == []


def test_durable_write_ignores_computed_modes(tmp_path):
    """A non-literal mode can't be judged statically: out of scope
    (the reviewer owns it), as are bare reads and text writes."""
    priv = tmp_path / "_private"
    priv.mkdir()
    mod = priv / "mod.py"
    mod.write_text(
        "def f(path, mode, b):\n"
        "    open(path, mode).write(b)\n"
        "    open(path).read()\n"
        "    open(path, 'w').write('x')\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    assert [f for f in unsuppressed
            if f.pass_id == "durable-write"] == []


def test_clean_fixture_produces_zero_findings():
    unsuppressed, all_findings = _run([_fixture("clean.py")])
    assert all_findings == [], [f.render() for f in all_findings]


def test_baseline_suppression_workflow(tmp_path):
    """--update-baseline accepts current findings; a later run is
    clean; a NEW finding still fails."""
    baseline = str(tmp_path / "baseline.json")
    unsuppressed, _ = _run([_fixture("bad_silent.py")],
                           baseline_path=baseline,
                           update_baseline=True)
    assert unsuppressed == []
    data = json.load(open(baseline))
    assert len(data["findings"]) == 1
    # suppressed on re-run
    unsuppressed, all_findings = _run([_fixture("bad_silent.py")],
                                      baseline_path=baseline)
    assert unsuppressed == [] and len(all_findings) == 1
    # a different file's findings are NOT suppressed
    unsuppressed, _ = _run([_fixture("bad_refleak.py")],
                           baseline_path=baseline)
    assert len(unsuppressed) == 2


def test_baseline_update_merges_unscanned_paths(tmp_path):
    """Updating from a partial scan must not erase suppressions for
    files the scan never looked at."""
    baseline = str(tmp_path / "baseline.json")
    _run([_fixture("bad_silent.py")], baseline_path=baseline,
         update_baseline=True)
    _run([_fixture("bad_refleak.py")], baseline_path=baseline,
         update_baseline=True)
    data = json.load(open(baseline))
    paths = {e["path"] for e in data["findings"]}
    assert any("bad_silent" in p for p in paths)       # preserved
    assert any("bad_refleak" in p for p in paths)      # added
    # both files now fully suppressed
    for name in ("bad_silent.py", "bad_refleak.py"):
        unsuppressed, _ = _run([_fixture(name)], baseline_path=baseline)
        assert unsuppressed == []


def test_baseline_does_not_suppress_new_identical_finding(tmp_path):
    """One accepted swallow must not suppress a SECOND identical one
    added later in the same scope (fingerprints carry an occurrence
    ordinal)."""
    mod = tmp_path / "mod.py"
    baseline = str(tmp_path / "baseline.json")
    one = ("def f(fn):\n"
           "    try:\n"
           "        return fn()\n"
           "    except Exception:\n"
           "        pass\n")
    mod.write_text(one)
    _run([str(mod)], root=str(tmp_path), baseline_path=baseline,
         update_baseline=True)
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path),
                           baseline_path=baseline)
    assert unsuppressed == []
    # a second identical violation appears in the same function
    mod.write_text(one.replace("        pass\n",
                               "        pass\n"
                               "    try:\n"
                               "        return fn()\n"
                               "    except Exception:\n"
                               "        pass\n"))
    unsuppressed, all_findings = _run([str(mod)], root=str(tmp_path),
                                      baseline_path=baseline)
    assert len(all_findings) == 2
    assert len(unsuppressed) == 1      # only the NEW one fails


def test_update_baseline_refuses_pass_subset(tmp_path):
    import pytest
    with pytest.raises(ValueError):
        _run([_fixture("bad_silent.py")],
             baseline_path=str(tmp_path / "b.json"),
             update_baseline=True, pass_ids=["silent-exception"])


def test_lock_discipline_async_with(tmp_path):
    """`async with self._lock:` counts as holding the lock."""
    src = (
        "import asyncio\n"
        "class A:\n"
        "    def __init__(self):\n"
        "        self._lock = asyncio.Lock()\n"
        "        self._items = {}  # guarded-by: _lock\n"
        "    async def good(self, k):\n"
        "        async with self._lock:\n"
        "            self._items[k] = 1\n"
        "    async def bad(self, k):\n"
        "        self._items[k] = 1\n")
    p = tmp_path / "mod.py"
    p.write_text(src)
    unsuppressed, _ = _run([str(p)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "lock-discipline"]
    assert [h.context for h in hits] == ["A.bad"]


def test_per_file_cache_reused(tmp_path):
    """Second run with the cache enabled reproduces identical findings
    (the cache stores per-file results keyed on mtime/size)."""
    import shutil
    root = tmp_path / "proj"
    root.mkdir()
    shutil.copy(_fixture("bad_silent.py"), root / "bad_silent.py")
    first, _ = _run([str(root)], root=str(root), use_cache=True)
    assert (root / ".rtpu_torch_analysis_cache.json").exists()
    second, _ = _run([str(root)], root=str(root), use_cache=True)
    assert [f.to_json() for f in first] == [f.to_json() for f in second]


def test_rpc_introspection_matches_static_scan():
    """The runtime half of the rpc-surface check: every registration
    the static pass sees in gcs_server.py exists in a live GcsServer's
    handler table."""
    from ray_tpu_torch._private.gcs_server import GcsServer
    from ray_tpu_torch.devtools.analysis.core import parse_file
    from ray_tpu_torch.devtools.analysis.passes.rpc_surface import _scan_file

    src = os.path.join(ROOT, "ray_tpu_torch", "_private", "gcs_server.py")
    ctx = parse_file(src, ROOT)
    static_regs, _calls = _scan_file(ctx)
    gs = GcsServer()
    try:
        live = set(gs.rpc_methods())
    finally:
        gs.shutdown()
    missing = set(static_regs) - live
    assert not missing, f"statically registered but not live: {missing}"


def test_registered_methods_hook():
    from ray_tpu_torch._private.rpc import RpcServer
    server = RpcServer()
    try:
        server.register("beta", lambda ctx: None)
        server.register("alpha", lambda ctx: None)
        assert server.registered_methods() == ("alpha", "beta")
    finally:
        server.shutdown()


# -- graftcheck v2: whole-program passes ------------------------------------


def test_sixteen_passes_registered():
    from ray_tpu_torch.devtools.analysis.passes import load_passes
    ids = [p.PASS_ID for p in load_passes()]
    assert len(ids) == 16
    for new in ("lock-order", "blocking-under-lock", "wire-shape",
                "sanitizer-coverage", "error-flow", "metric-discipline",
                "chaos-coverage"):
        assert new in ids


def test_lock_order_fixture():
    """One declared-order inversion (transitive, via the helper call)
    and one undeclared cycle; the good twins stay quiet."""
    unsuppressed, _ = _run([_fixture("bad_lockorder.py")])
    hits = [f for f in unsuppressed if f.pass_id == "lock-order"]
    assert len(hits) == 2
    inversions = [h for h in hits if "inversion" in h.message]
    cycles = [h for h in hits if "cycle" in h.message]
    assert len(inversions) == 1 and len(cycles) == 1
    assert inversions[0].context == "BadNest.bad"
    assert "_a_lock" in inversions[0].message
    assert "BadNest.bad -> BadNest._grab_a" in inversions[0].message
    assert cycles[0].context == "CycleRing.one"
    assert "_x_lock" in cycles[0].message


def test_blocking_under_lock_fixture():
    """Direct sleep, direct RPC, and a transitive subprocess reach are
    flagged; post-release blocking and the annotated stall are not."""
    unsuppressed, _ = _run([_fixture("bad_blocking_lock.py")])
    hits = [f for f in unsuppressed
            if f.pass_id == "blocking-under-lock"]
    assert len(hits) == 3
    by_ctx = {h.context: h.message for h in hits}
    assert set(by_ctx) == {"Gate.bad_sleep", "Gate.bad_rpc",
                           "Gate.bad_transitive"}
    assert "time.sleep" in by_ctx["Gate.bad_sleep"]
    assert "'fetch_state'" in by_ctx["Gate.bad_rpc"]
    assert "subprocess.run" in by_ctx["Gate.bad_transitive"]
    assert "Gate.bad_transitive -> Gate._spawn" \
        in by_ctx["Gate.bad_transitive"]


def test_wire_shape_fixture():
    """Tuple-only gates on fastframe-tainted values are flagged — the
    handler's own param, a type(...)-is gate, and a helper the value
    flows into; (tuple, list) gates, non-fastframe handlers, and the
    annotated gate are not."""
    unsuppressed, _ = _run([_fixture("bad_wire_shape.py")])
    hits = [f for f in unsuppressed if f.pass_id == "wire-shape"]
    assert len(hits) == 3
    contexts = sorted(h.context for h in hits)
    assert contexts == ["_forward", "handle_submit", "handle_submit"]
    messages = " | ".join(h.message for h in hits)
    assert "'submit'" in messages            # traced wire method
    assert "type(...) is tuple" in messages
    assert all("handle_plain" != h.context for h in hits)


def test_lock_order_catches_inverted_raylet_flush(tmp_path):
    """The acceptance scenario: take a scratch copy of the live
    raylet, delete the machine-readable ordering declaration, and
    invert the `_flush_pushes` acquisition — the cycle against the
    surviving `_push_order_lock -> _push_lock` paths is caught with
    no declaration in sight. With the declaration retained the same
    edit is reported as an inversion."""
    src = open(os.path.join(ROOT, "ray_tpu_torch", "_private",
                            "raylet_server.py")).read()
    decl = ("# lock-order: _push_order_lock -> _push_lock -> "
            "ConnectionContext._send_lock")
    assert decl in src
    old = ("    def _flush_pushes(self) -> None:\n"
           "        with self._push_order_lock:\n"
           "            self._flush_pushes_locked()\n")
    assert old in src
    inverted = src.replace(old, (
        "    def _flush_pushes(self) -> None:\n"
        "        with self._push_lock:\n"
        "            with self._push_order_lock:\n"
        "                self._flush_pushes_locked()\n"))
    priv = tmp_path / "_private"
    priv.mkdir()
    scratch = priv / "raylet_server.py"

    # declaration deleted: cycle detection alone must catch it
    scratch.write_text(inverted.replace(decl, "#"))
    unsuppressed, _ = _run([str(scratch)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "lock-order"]
    assert hits, "inverted flush not caught without declaration"
    assert any("cycle" in h.message and "_push_order_lock" in h.message
               for h in hits)

    # declaration retained: reported as an inversion against it
    scratch.write_text(inverted)
    unsuppressed, _ = _run([str(scratch)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "lock-order"]
    assert any("inversion" in h.message
               and "_push_order_lock" in h.message for h in hits)


def test_whole_program_cache_invalidation(tmp_path):
    """Editing file A must invalidate a phase-2 finding whose evidence
    spans A and B even when B's summary is a cache hit: phase 2 always
    relinks the freshest summaries."""
    priv = tmp_path / "_private"
    priv.mkdir()
    handlers = priv / "handlers.py"
    reg = priv / "reg.py"
    handlers.write_text(
        "def handle_submit(ctx, spec):\n"
        "    if isinstance(spec, tuple):\n"
        "        return spec\n"
        "    return None\n")
    reg_src = (
        '_FASTFRAME_SAFE = frozenset(("submit",))\n'
        "def wire(server):\n"
        '    server.register("submit", handle_submit)  # rpc: external\n')
    reg.write_text(reg_src)

    unsuppressed, _ = _run([str(priv)], root=str(tmp_path),
                           use_cache=True)
    hits = [f for f in unsuppressed if f.pass_id == "wire-shape"]
    assert len(hits) == 1 and "handlers.py" in hits[0].path

    # edit A (the registration side) so the method is no longer
    # fastframe-safe; B is untouched and its summary stays cache-hit
    b_stat = os.stat(handlers)
    reg.write_text(reg_src.replace('frozenset(("submit",))',
                                   'frozenset(("other",))'))
    unsuppressed, _ = _run([str(priv)], root=str(tmp_path),
                           use_cache=True)
    assert [f for f in unsuppressed if f.pass_id == "wire-shape"] == []
    cache = json.load(open(tmp_path / ".rtpu_torch_analysis_cache.json"))
    entry = cache["files"][str(handlers)]
    assert entry["stat"] == [b_stat.st_mtime, b_stat.st_size]

    # and back: the finding returns, B still cache-hit
    reg.write_text(reg_src)
    unsuppressed, _ = _run([str(priv)], root=str(tmp_path),
                           use_cache=True)
    hits = [f for f in unsuppressed if f.pass_id == "wire-shape"]
    assert len(hits) == 1


def test_git_changed_file_discovery(tmp_path):
    """--changed collects staged, unstaged, and untracked .py files —
    including files inside a brand-new untracked DIRECTORY, which
    plain `git status` collapses to one `dir/` entry — and reports
    deletions separately (non-Python files excluded), all without
    needing any commit."""
    import subprocess as sp

    from ray_tpu_torch.devtools.analysis.__main__ import _git_changed_files

    sp.run(["git", "init", "-q"], cwd=tmp_path, check=True)
    (tmp_path / "a.py").write_text("x = 1\n")
    (tmp_path / "b.txt").write_text("not python\n")
    sub = tmp_path / "newpkg"
    sub.mkdir()
    (sub / "mod.py").write_text("z = 3\n")
    existing, deleted = _git_changed_files(str(tmp_path))
    assert existing == [str(tmp_path / "a.py"), str(sub / "mod.py")]
    assert deleted == []
    sp.run(["git", "add", "a.py"], cwd=tmp_path, check=True)
    (tmp_path / "c.py").write_text("y = 2\n")
    existing, _deleted = _git_changed_files(str(tmp_path))
    assert str(tmp_path / "c.py") in existing
    # a committed-then-deleted file lands in the deleted bucket
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")
    sp.run(["git", "commit", "-qm", "x"], cwd=tmp_path, check=True,
           env=env)
    (tmp_path / "a.py").unlink()
    existing, deleted = _git_changed_files(str(tmp_path))
    assert str(tmp_path / "a.py") not in existing
    assert deleted == [str(tmp_path / "a.py")]


def test_prune_never_judges_link_only_files(tmp_path):
    """A --changed-style run (file A scanned, file B link-only) must
    not prune B's per-file suppression: B surfaces only its phase-2
    findings in that run, and judging its baseline on that partial
    view would delete a valid entry and break the next full run."""
    priv = tmp_path / "_private"
    priv.mkdir()
    a = priv / "a.py"
    b = priv / "b.py"
    a.write_text("x = 1\n")
    b.write_text("def f(fn):\n"
                 "    try:\n"
                 "        return fn()\n"
                 "    except Exception:\n"
                 "        pass\n")
    baseline = str(tmp_path / "baseline.json")
    _run([str(priv)], root=str(tmp_path), baseline_path=baseline,
         update_baseline=True)
    assert len(json.load(open(baseline))["findings"]) == 1

    report = {}
    unsuppressed, _ = _run([str(a)], root=str(tmp_path),
                           baseline_path=baseline,
                           link_paths=[str(priv)],
                           prune_stale=True, report=report)
    assert unsuppressed == []
    assert report["stale_pruned"] == []
    assert len(json.load(open(baseline))["findings"]) == 1
    # and the full-tree run is still clean afterwards
    unsuppressed, _ = _run([str(priv)], root=str(tmp_path),
                           baseline_path=baseline)
    assert unsuppressed == []


def test_wire_shape_taint_killed_by_overwrite(tmp_path):
    """An unconditional overwrite after a conditional taint must kill
    the taint in source order: a gate on the overwritten value is not
    a wire-shape finding (the flow map is a forward pass, not a
    breadth-first walk that would resurrect dead taint)."""
    priv = tmp_path / "_private"
    priv.mkdir()
    mod = priv / "mod.py"
    mod.write_text(
        '_FASTFRAME_SAFE = frozenset(("submit",))\n'
        "def wire(server):\n"
        '    server.register("submit", handle)  # rpc: external\n'
        "def compute():\n"
        "    return ()\n"
        "def handle(ctx, spec):\n"
        "    if ctx:\n"
        "        y = spec\n"
        "    y = compute()\n"
        "    if isinstance(y, tuple):\n"
        "        return y\n"
        "    return None\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    assert [f for f in unsuppressed if f.pass_id == "wire-shape"] == []


def test_link_paths_feed_whole_program_passes(tmp_path):
    """The --changed contract at the run_analysis level: scanning only
    file B with A in the link set still produces the cross-file
    finding, while A's own per-file findings are not reported."""
    priv = tmp_path / "_private"
    priv.mkdir()
    handlers = priv / "handlers.py"
    reg = priv / "reg.py"
    handlers.write_text(
        "def handle_submit(ctx, spec):\n"
        "    if isinstance(spec, tuple):\n"
        "        return spec\n"
        "    return None\n")
    reg.write_text(
        '_FASTFRAME_SAFE = frozenset(("submit",))\n'
        "import time\n"
        "def wire(server):\n"
        '    server.register("submit", handle_submit)  # rpc: external\n')
    unsuppressed, _ = _run([str(handlers)], root=str(tmp_path),
                           link_paths=[str(priv)])
    hits = [f for f in unsuppressed if f.pass_id == "wire-shape"]
    assert len(hits) == 1 and "handlers.py" in hits[0].path


def test_timings_report():
    report = {}
    _run([_fixture("clean.py")], report=report)
    t = report["timings"]
    assert "parse+summarize" in t
    for pass_id in ("lock-order", "blocking-under-lock", "wire-shape",
                    "rpc-surface", "lock-discipline"):
        assert pass_id in t and t[pass_id] >= 0.0


def test_stale_baseline_pruning(tmp_path):
    """A baselined finding that no longer fires is reported and
    removed; entries for files the run never analyzed survive."""
    baseline = str(tmp_path / "baseline.json")
    mod = tmp_path / "mod.py"
    mod.write_text("def f(fn):\n"
                   "    try:\n"
                   "        return fn()\n"
                   "    except Exception:\n"
                   "        pass\n")
    _run([str(mod)], root=str(tmp_path), baseline_path=baseline,
         update_baseline=True)
    _run([_fixture("bad_silent.py")], baseline_path=baseline,
         update_baseline=True)
    assert len(json.load(open(baseline))["findings"]) == 2

    # fix mod.py: its accepted finding no longer fires
    mod.write_text("def f(fn):\n    return fn()\n")
    report = {}
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path),
                           baseline_path=baseline, prune_stale=True,
                           report=report)
    assert unsuppressed == []
    stale = report["stale_pruned"]
    assert len(stale) == 1 and stale[0]["path"] == "mod.py"
    kept = json.load(open(baseline))["findings"]
    assert len(kept) == 1                      # unscanned entry kept
    assert "bad_silent" in kept[0]["path"]
    # the fixture's suppression still works after the prune
    unsuppressed, _ = _run([_fixture("bad_silent.py")],
                           baseline_path=baseline)
    assert unsuppressed == []




# -- graftsan: contract compilation & coverage ------------------------------


def test_sanitizer_coverage_fixture():
    """Each seeded rot case fires exactly once; the good twins stay
    quiet (see the fixture's docstring for the four cases)."""
    unsuppressed, _ = _run([_fixture("bad_sancov.py")])
    hits = [f for f in unsuppressed if f.pass_id == "sanitizer-coverage"]
    assert len(hits) == 4, [f.to_json() for f in hits]
    msgs = "\n".join(f.message for f in hits)
    assert "orphaned" in msgs
    assert "_t_lok" in msgs                # typo'd guarded-by lock
    assert "_ghost_order_lock" in msgs     # unresolvable order element
    assert "_h_lok" in msgs                # dead lock-held suppression
    for f in hits:
        assert "`_g_lock`" not in f.message    # good twin stays quiet


def test_cache_prunes_deleted_files(tmp_path):
    """A deleted file must not haunt later runs through its cached
    summary: its cache entry is pruned and the call graph loses its
    edges (a ghost caller would otherwise keep satisfying—or keep
    violating—whole-program checks forever)."""
    import shutil
    root = tmp_path / "proj"
    priv = root / "_private"
    priv.mkdir(parents=True)
    shutil.copy(_fixture("bad_lockorder.py"), priv / "bad_lockorder.py")
    (priv / "extra.py").write_text(
        "import threading\n\n\n"
        "class Extra:\n"
        "    def __init__(self):\n"
        "        self._e_lock = threading.Lock()\n"
        "        self._f_lock = threading.Lock()\n\n"
        "    def nest(self):\n"
        "        with self._e_lock:\n"
        "            with self._f_lock:\n"
        "                return 1\n")
    first, _ = _run([str(root)], root=str(root), use_cache=True)
    cache_path = root / ".rtpu_torch_analysis_cache.json"
    cached = json.load(open(cache_path))["files"]
    assert any("extra.py" in p for p in cached)
    (priv / "extra.py").unlink()
    second, _ = _run([str(root)], root=str(root), use_cache=True)
    cached = json.load(open(cache_path))["files"]
    assert not any("extra.py" in p for p in cached), (
        "deleted file's summary still cached")
    # the survivor's findings are unchanged — no ghost edges either way
    assert ([f.to_json() for f in second]
            == [f.to_json() for f in first
                if "extra.py" not in f.path])






# -- graftflow: error-flow / metric-discipline / chaos-coverage -------------


def test_error_flow_fixture():
    """Each seeded rot case fires exactly once; the good twins stay
    quiet (see the fixture's docstring for the four cases)."""
    unsuppressed, _ = _run([_fixture("bad_errorflow.py")])
    hits = [f for f in unsuppressed if f.pass_id == "error-flow"]
    assert len(hits) == 4, [f.to_json() for f in hits]
    by_ctx = {h.context: h.message for h in hits}
    assert "LostShardError" in by_ctx
    assert "no matching __reduce__" in by_ctx["LostShardError"]
    assert "BadShedError" in by_ctx
    assert "retryable" in by_ctx["BadShedError"]
    assert "backoff_s" in by_ctx["BadShedError"]
    assert "swallow_badly" in by_ctx
    assert "swallow-ok" in by_ctx["swallow_badly"]
    dead = [h for h in hits if h.context == "<module>"]
    assert len(dead) == 1 and "GhostError" in dead[0].message
    # good twins: quiet across the board
    messages = " | ".join(h.message for h in hits)
    assert "GoodWireError" not in messages
    assert "PlainChildError" not in messages
    assert "GoodShedError" not in messages
    assert all(h.context not in ("swallow_annotated", "swallow_reraises")
               for h in hits)


def test_error_flow_links_cross_file_changed(tmp_path):
    """The --changed contract for error-flow: the class definition in
    link-only A plus the raise in scanned B yields the pickle-safety
    finding anchored at A; without the link set the raise is just an
    unknown name and nothing fires."""
    priv = tmp_path / "_private"
    priv.mkdir()
    exc = priv / "exc.py"
    uses = priv / "uses.py"
    exc.write_text(
        "class RayTpuError(Exception):\n"
        "    pass\n"
        "class DroppedError(RayTpuError):\n"
        "    def __init__(self, key):\n"
        "        super().__init__(key)\n"
        "        self.key = key\n")
    uses.write_text(
        "def boom(key):\n"
        "    raise DroppedError(key)\n")
    unsuppressed, _ = _run([str(uses)], root=str(tmp_path),
                           link_paths=[str(priv)])
    hits = [f for f in unsuppressed if f.pass_id == "error-flow"]
    assert len(hits) == 1, [f.to_json() for f in hits]
    assert hits[0].context == "DroppedError"
    assert "exc.py" in hits[0].path
    assert "uses.py:2" in hits[0].message     # raise site cited
    # the same scan without the link set sees no taxonomy at all
    unsuppressed, _ = _run([str(uses)], root=str(tmp_path))
    assert [f for f in unsuppressed if f.pass_id == "error-flow"] == []


def test_metric_discipline_fixture():
    """The rogue ray_tpu_* constructor outside the stats modules
    fires; the user-namespace and computed-name twins stay quiet."""
    unsuppressed, _ = _run([_fixture("bad_metric.py")])
    hits = [f for f in unsuppressed if f.pass_id == "metric-discipline"]
    assert len(hits) == 1, [f.to_json() for f in hits]
    assert hits[0].context == "install_rogue_gauge"
    assert "ray_tpu_fixture_rogue_depth" in hits[0].message
    assert "outside the stats modules" in hits[0].message


def test_metric_label_consistency(tmp_path):
    """The same gauge re-declared with different tag_keys inside a
    stats module is a shape conflict."""
    priv = tmp_path / "_private"
    priv.mkdir()
    stats = priv / "stats.py"
    stats.write_text(
        'a = Gauge("ray_tpu_fx_dup", "d", tag_keys=("node",))\n'
        'b = Gauge("ray_tpu_fx_dup", "d", tag_keys=("node", "zone"))\n')
    unsuppressed, _ = _run([str(stats)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "metric-discipline"]
    assert len(hits) == 1, [f.to_json() for f in hits]
    assert "re-declared with tag_keys" in hits[0].message
    assert "dropping labels" in hits[0].message


def test_metric_doc_contract_both_ways(tmp_path):
    """Docs-table contract, all four failure shapes at once: a ghost
    row, an undocumented declaration, a double-owned gauge, and a doc
    label the declaration does not carry."""
    priv = tmp_path / "_private"
    priv.mkdir()
    docs = tmp_path / "ray_tpu_torch" / "docs"
    docs.mkdir(parents=True)
    stats = priv / "stats.py"
    stats.write_text(
        'doc = Gauge("ray_tpu_fx_documented", "d", tag_keys=("node",))\n'
        'und = Gauge("ray_tpu_fx_undocumented", "d")\n'
        'twi = Gauge("ray_tpu_fx_twice", "d")\n')
    (docs / "metrics.md").write_text(
        "# registry\n"
        "\n"
        "| gauge | meaning |\n"
        "|---|---|\n"
        "| `ray_tpu_fx_documented{node,zone}` | zone is not declared |\n"
        "| `ray_tpu_fx_ghost` | nobody declares this |\n"
        "| `ray_tpu_fx_twice` | first owner |\n"
        "| `ray_tpu_fx_twice` | second owner |\n"
        "\n"
        "prose mention of ray_tpu_fx_undocumented must NOT count\n")
    unsuppressed, _ = _run([str(stats)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "metric-discipline"]
    msgs = {h.message for h in hits}
    assert len(hits) == 4, [f.to_json() for f in hits]
    assert any("ghost gauge" in m and "ray_tpu_fx_ghost" in m
               for m in msgs)
    assert any("appears in no docs table" in m
               and "ray_tpu_fx_undocumented" in m for m in msgs)
    assert any("2 docs table rows" in m and "ray_tpu_fx_twice" in m
               for m in msgs)
    assert any("zone" in m and "does not carry" in m for m in msgs)


def test_chaos_coverage_fixture():
    """The uncovered point reports once per missing direction; the
    annotated-unreachable and really-covered twins stay quiet."""
    unsuppressed, _ = _run([_fixture("bad_chaoscov.py")])
    hits = [f for f in unsuppressed if f.pass_id == "chaos-coverage"]
    assert len(hits) == 2, [f.to_json() for f in hits]
    # concatenation keeps the needle itself out of this test file —
    # the pass scans tests/ and must not find the key here
    needle = "fixture_zone" + "." + "nowhere"
    assert all(needle in h.message for h in hits)
    msgs = " | ".join(h.message for h in hits)
    assert "no docs chaos-matrix" in msgs
    assert "no test literal" in msgs
    assert "unreachable" not in needle and all(
        ("fixture_zone" + ".unreachable") not in h.message for h in hits)


def test_chaos_coverage_directions_and_grammar(tmp_path):
    """Per-direction reporting plus the degrading needle grammar: an
    f-string detail matches by prefix and a dynamic component matches
    any `.point.` rule line."""
    priv = tmp_path / "_private"
    priv.mkdir()
    docs = tmp_path / "ray_tpu_torch" / "docs"
    docs.mkdir(parents=True)
    (tmp_path / "tests").mkdir()
    mod = priv / "mod.py"
    mod.write_text(
        "from ray_tpu._private import chaos\n"
        "def f(component, tag):\n"
        "    chaos.fire('zoneA', 'alpha')\n"
        "    chaos.fire('zoneB', 'beta')\n"
        "    chaos.fire('zoneC', 'save', f'save_{tag}')\n"
        "    chaos.fire(component, 'send')\n")
    (docs / "chaos.md").write_text(
        "| `zoneA.alpha` | documented but untested |\n"
        "| `zoneC.save.save_weights` | prefix-matches the f-string |\n"
        "| `wire.send.echo` | matches the dynamic component |\n")
    (tmp_path / "tests" / "test_torch_fx.py").write_text(
        "RULES = 'zoneB.beta:drop@1;zoneC.save.save_opt:drop@1'\n"
        "MORE = 'wire.send.echo:delay=0.1@1'\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "chaos-coverage"]
    assert len(hits) == 2, [f.to_json() for f in hits]
    by_key = {h.message.split("`")[1]: h.message for h in hits}
    assert set(by_key) == {"zoneA.alpha", "zoneB.beta"}
    assert "no test literal" in by_key["zoneA.alpha"]
    assert "no docs chaos-matrix" in by_key["zoneB.beta"]


# -- the port's adaptations -------------------------------------------------


def test_chaos_coverage_reads_only_port_tests(tmp_path):
    """A chaos key that only a test file outside ``test_torch_*.py``
    names (a JAX-package test) is not exercised in the port: the pass
    reports it."""
    priv = tmp_path / "_private"
    priv.mkdir()
    docs = tmp_path / "ray_tpu_torch" / "docs"
    docs.mkdir(parents=True)
    (tmp_path / "tests").mkdir()
    mod = priv / "mod.py"
    mod.write_text(
        "def f():\n"
        "    chaos.fire('zoneD', 'gamma')\n")
    (docs / "chaos.md").write_text("| `zoneD.gamma` | documented |\n")
    (tmp_path / "tests" / "test_fx.py").write_text(
        "RULES = 'zoneD.gamma:drop@1'\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "chaos-coverage"]
    assert len(hits) == 1 and "no test literal" in hits[0].message
    (tmp_path / "tests" / "test_torch_fx.py").write_text(
        "RULES = 'zoneD.gamma:drop@1'\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    assert [f for f in unsuppressed if f.pass_id == "chaos-coverage"] == []


def test_doc_contracts_read_port_docs_only(tmp_path):
    """The metric registry the port's pass reads is
    ``ray_tpu_torch/docs/``; a table in the repo's ``docs/`` (the JAX
    package's) documents nothing for the port."""
    priv = tmp_path / "_private"
    priv.mkdir()
    (tmp_path / "docs").mkdir()
    stats = priv / "stats.py"
    stats.write_text('g = Gauge("ray_tpu_fx_only_in_ref_docs", "d")\n')
    (tmp_path / "docs" / "metrics.md").write_text(
        "| `ray_tpu_fx_only_in_ref_docs` | the JAX package's table |\n")
    port_docs = tmp_path / "ray_tpu_torch" / "docs"
    port_docs.mkdir(parents=True)
    (port_docs / "metrics.md").write_text("# no table rows\n")
    unsuppressed, _ = _run([str(stats)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "metric-discipline"]
    assert len(hits) == 1, [f.to_json() for f in hits]
    assert "appears in no docs table" in hits[0].message
    (port_docs / "metrics.md").write_text(
        "| `ray_tpu_fx_only_in_ref_docs` | the port's table |\n")
    unsuppressed, _ = _run([str(stats)], root=str(tmp_path))
    assert [f for f in unsuppressed
            if f.pass_id == "metric-discipline"] == []


def test_ref_leak_knows_the_port_name(tmp_path):
    """``ray_tpu_torch.put(...)`` produces a ref like ``ray_tpu.put``:
    a discarded one is a finding."""
    mod = tmp_path / "mod.py"
    mod.write_text(
        "import ray_tpu_torch\n"
        "def f(x):\n"
        "    ray_tpu_torch.put(x)\n")
    unsuppressed, _ = _run([str(mod)], root=str(tmp_path))
    hits = [f for f in unsuppressed if f.pass_id == "ref-leak"]
    assert len(hits) == 1 and hits[0].context == "f"


# -- held against the JAX package's analysis --------------------------------


FIXTURE_FILES = [
    "bad_async.py", "bad_blocking_lock.py", "bad_chaoscov.py",
    "bad_deadline.py", "bad_durable.py", "bad_errorflow.py",
    "bad_lock.py", "bad_lockorder.py", "bad_metric.py", "bad_queue.py",
    "bad_refleak.py", "bad_retry.py", "bad_rpc.py", "bad_sancov.py",
    "bad_silent.py", "bad_wire_shape.py", "clean.py",
]


def test_fixture_list_is_whole():
    assert sorted(n for n in os.listdir(FIXTURES)
                  if n.endswith(".py")) == FIXTURE_FILES


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_match_reference(name):
    """Both packages' ``run_analysis`` give the same findings (pass,
    line, context, message) on each shared fixture: the repo root's
    docs and tests differ between the two (each reads its own), and
    the fixtures' covered chaos and metric twins are covered in both."""
    from ray_tpu.devtools.analysis import run_analysis as ref_run

    def key(f):
        return (f.pass_id, f.path, f.line, f.context, f.message)

    _, ours = _run([_fixture(name)])
    _, theirs = ref_run([_fixture(name)], use_cache=False)
    assert [key(f) for f in ours] == [key(f) for f in theirs]
    assert bool(ours) == (name != "clean.py")
