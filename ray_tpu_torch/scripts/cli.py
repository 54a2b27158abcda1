"""CLI: cluster bootstrap + introspection.

Reference: ``python/ray/scripts/scripts.py`` (``ray start/stop/status/
timeline``) [UNVERIFIED — mount empty, SURVEY.md §0]. argparse-based:

  python -m ray_tpu_torch start --head [--session NAME]
  python -m ray_tpu_torch start --address HOST:PORT --num-cpus 8
  python -m ray_tpu_torch status --address HOST:PORT
  python -m ray_tpu_torch stop [--session NAME]
  python -m ray_tpu_torch workflows [--storage DIR]

``start --head`` spawns a standalone GCS process and prints its
address; ``start --address`` spawns a raylet process that registers
there; a driver joins with ``ray_tpu_torch.init(address="HOST:PORT")``.
A raylet process sees no card, so ``start --address`` refuses
``--num-gpus`` (GPU work runs on a driver's threads). Every file the
commands read or write lives in the session directories under
``TMPDIR`` (``_private/session_dir.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from ray_tpu_torch._private.session_dir import session_dir


def _install_token(args) -> None:
    """--token wins; else env; else the same-host token file (via the
    session name when given, else the rtpt_current pointer)."""
    from ray_tpu_torch._private import rpc as _rpc
    if getattr(args, "token", ""):
        _rpc.set_session_token(args.token)
        return
    if _rpc.get_session_token():
        return
    file_token = _rpc.load_session_token_file(
        getattr(args, "session", None) or None)
    if file_token:
        _rpc.set_session_token(file_token)


def _cmd_start(args) -> int:
    from ray_tpu_torch._private import rpc as _rpc
    from ray_tpu_torch._private.config import get_config

    session = args.session
    if args.token:
        _rpc.set_session_token(args.token)
    elif not args.head and not _rpc.get_session_token():
        # same-host join with no --token and no env: pick up the token
        # the head persisted into the session dir (that file exists for
        # exactly this) — cross-host joiners still need --token
        file_token = _rpc.load_session_token_file(session)
        if file_token:
            _rpc.set_session_token(file_token)
    if args.head:
        from ray_tpu_torch._private.gcs_server import spawn_gcs_process
        token = _rpc.ensure_session_token(session)
        proc, addr = spawn_gcs_process(session, get_config().serialize(),
                                       persist=True)
        print(f"GCS started (pid {proc.pid}) at {addr[0]}:{addr[1]}")
        print(f"Session token (required by joiners): {token}")
        print(f"Join a driver with: RTPU_SESSION_TOKEN={token} and "
              f"ray_tpu_torch.init(address=\"{addr[0]}:{addr[1]}\")")
        print(f"Add a node with: python -m ray_tpu_torch start "
              f"--address {addr[0]}:{addr[1]} --token {token} "
              f"--num-cpus 4")
        return 0
    if not args.address:
        print("start needs --head or --address HOST:PORT",
              file=sys.stderr)
        return 2
    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch._private.raylet_server import spawn_raylet_process
    from ray_tpu_torch.cluster_utils import refuse_remote_gpu
    host, port = args.address.rsplit(":", 1)
    resources = {"CPU": float(args.num_cpus)}
    if args.num_gpus:
        resources["GPU"] = float(args.num_gpus)
    if args.resources:
        resources.update({k: float(v)
                          for k, v in json.loads(args.resources).items()})
    try:
        refuse_remote_gpu(resources)
    except ValueError as e:
        print(f"start --address: {e}", file=sys.stderr)
        return 2
    node_id = NodeID.from_random()
    node_session = f"{session}_{node_id.hex()[:8]}"
    proc, addr = spawn_raylet_process(
        node_session, node_id, resources, gcs_addr=(host, int(port)),
        max_process_workers=args.max_workers)
    print(f"raylet started (pid {proc.pid}) node {node_id.hex()[:12]} "
          f"at {addr[0]}:{addr[1]} resources={resources}")
    return 0


def _cmd_status(args) -> int:
    from ray_tpu_torch._private.gcs_client import GcsClient
    _install_token(args)
    host, port = args.address.rsplit(":", 1)
    client = GcsClient((host, int(port)))
    try:
        nodes = client.get_all_node_info()
        print(f"{'NODE':14} {'ALIVE':6} {'ADDRESS':22} RESOURCES")
        for info in nodes:
            addr = (f"{info.rpc_addr[0]}:{info.rpc_addr[1]}"
                    if info.rpc_addr else "-")
            print(f"{info.node_id.hex()[:12]:14} "
                  f"{str(info.alive):6} {addr:22} "
                  f"{info.resources_total}")
        actors = client.list_actors()
        if actors:
            print(f"\n{'ACTOR':14} {'CLASS':20} STATE")
            for a in actors:
                print(f"{a.actor_id.hex()[:12]:14} "
                      f"{a.class_name:20} {a.state}")
    finally:
        client.close()
    return 0


def _render_table(rows, columns) -> None:
    """Fixed-width table over selected columns of state-API rows."""
    if not rows:
        print("(none)")
        return
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns}
    print("  ".join(c.upper().ljust(widths[c]) for c in columns))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c])
                        for c in columns))


_LIST_COLUMNS = {
    "nodes": ["node_id", "alive", "is_head", "remote",
              "resources_total"],
    "actors": ["actor_id", "class_name", "state", "name",
               "num_restarts"],
    "tasks": ["task_id", "name", "status", "attempt", "resources"],
    "objects": ["object_id", "location", "reference_counts"],
    "workers": ["node_id", "kind"],
}


def _fetch_state(args, kind: str):
    """State rows: from a running driver's dashboard API
    (``--dashboard``, the live source covering every kind), else from
    the GCS (``--address``: nodes/actors only — tasks and objects are
    driver-owned state the GCS does not hold)."""
    import json as _json
    import urllib.request
    if getattr(args, "dashboard", ""):
        url = f"http://{args.dashboard}/api/{kind}"
        with urllib.request.urlopen(url, timeout=30) as r:
            return _json.loads(r.read().decode())
    if not getattr(args, "address", ""):
        raise SystemExit("pass --dashboard HOST:PORT (live driver) or "
                         "--address GCS_HOST:PORT")
    if kind not in ("nodes", "actors"):
        raise SystemExit(
            f"'{kind}' is driver-owned state: reach a live driver with "
            f"--dashboard HOST:PORT (the GCS only has nodes/actors)")
    from ray_tpu_torch._private.gcs_client import GcsClient
    _install_token(args)
    host, port = args.address.rsplit(":", 1)
    client = GcsClient((host, int(port)))
    try:
        if kind == "nodes":
            # rpc_addr is None exactly for in-driver (head) logical
            # nodes (gcs.NodeInfo contract); raylet processes carry
            # their lease endpoint.
            return [{
                "node_id": i.node_id.hex(), "alive": i.alive,
                "is_head": i.rpc_addr is None,
                "remote": i.rpc_addr is not None,
                "resources_total": dict(i.resources_total),
            } for i in client.get_all_node_info()]
        return [{
            "actor_id": a.actor_id.hex(), "class_name": a.class_name,
            "state": a.state, "name": a.name or "",
            "num_restarts": a.num_restarts,
        } for a in client.list_actors()]
    finally:
        client.close()


def _cmd_list(args) -> int:
    """``ray_tpu_torch list tasks|actors|objects|nodes|workers`` — the
    reference's ``ray list`` surface over util/state."""
    rows = _fetch_state(args, args.what)
    if args.format == "json":
        import json as _json
        print(_json.dumps(rows, indent=2, default=str))
        return 0
    cols = _LIST_COLUMNS[args.what]
    if rows and not any(c in rows[0] for c in cols):
        cols = list(rows[0].keys())[:6]
    _render_table(rows, cols)
    print(f"\n{len(rows)} row(s)")
    return 0


def _cmd_memory(args) -> int:
    """``ray_tpu_torch memory`` — object-store usage + per-object reference
    breakdown from a live driver (the reference's ``ray memory``)."""
    summary = _fetch_state(args, "summary")
    objs = _fetch_state(args, "objects")
    print("OBJECT STORE")
    for store in ("objects", "device_objects"):
        stats = summary.get(store, {})
        if stats:
            print(f"  {store}: " + ", ".join(
                f"{k}={v}" for k, v in sorted(stats.items())))
    by_loc: dict = {}
    for o in objs:
        by_loc.setdefault(o.get("location", "?"), []).append(o)
    # the list endpoint caps at 500 rows; the summary total is
    # authoritative — never report a truncated length as the total
    total = summary.get("live_refs", len(objs))
    print(f"\n{total} live object reference(s); by location"
          + (f" (newest {len(objs)} shown)" if len(objs) < total
             else "") + ":")
    for loc in sorted(by_loc):
        print(f"  {loc}: {len(by_loc[loc])}")
    if args.verbose:
        print()
        _render_table(objs, _LIST_COLUMNS["objects"])
    return 0


def _cmd_timeline(args) -> int:
    """``ray_tpu_torch timeline`` — export the task timeline as Chrome-trace
    JSON (open in chrome://tracing / Perfetto), the reference's
    ``ray timeline``."""
    import json as _json
    import urllib.request
    if not args.dashboard:
        raise SystemExit("timeline needs a live driver: "
                         "--dashboard HOST:PORT")
    url = f"http://{args.dashboard}/api/timeline"
    with urllib.request.urlopen(url, timeout=30) as r:
        events = _json.loads(r.read().decode())
    with open(args.out, "w") as f:
        _json.dump(events, f)
    print(f"wrote {len(events)} span(s) to {args.out}")
    return 0


def _cmd_stop(args) -> int:
    """Terminate this session's GCS/raylet processes (by port files +
    process table). Without ``--session``: every session whose files
    live under this ``TMPDIR``."""
    import glob
    import subprocess
    killed = 0
    pattern = session_dir(args.session)
    out = subprocess.run(
        ["pgrep", "-af", "ray_tpu_torch._private.(gcs_server|raylet_server)"],
        capture_output=True, text=True).stdout
    for line in out.splitlines():
        pid_s, _, cmd = line.partition(" ")
        if pattern in cmd:
            try:
                os.kill(int(pid_s), signal.SIGTERM)
                killed += 1
            except (ProcessLookupError, ValueError):
                pass
    for d in glob.glob(f"{pattern}*"):
        pass  # session dirs cleaned by their owners; addresses go stale
    print(f"terminated {killed} process(es)")
    return 0


def _cmd_job(args) -> int:
    from ray_tpu_torch.job_submission import JobSubmissionClient
    # the GCS refuses a client without the session's token: take it as
    # status and list do (--token, env, then the same-host token file)
    _install_token(args)
    client = JobSubmissionClient(args.address)
    try:
        if args.job_command == "submit":
            entrypoint = " ".join(args.entrypoint).lstrip("- ")
            job_id = client.submit_job(entrypoint=entrypoint)
            print(f"submitted {job_id}: {entrypoint}")
            if not args.no_wait:
                info = client.wait_until_finished(job_id,
                                                  timeout=args.timeout)
                print(client.get_job_logs(job_id), end="")
                print(f"{job_id} {info.status} (rc={info.return_code})")
                return 0 if info.status == "SUCCEEDED" else 1
            return 0
        if args.job_command == "list":
            for info in client.list_jobs():
                print(f"{info.job_id:20} {info.status:10} "
                      f"{info.entrypoint}")
            return 0
        if args.job_command == "status":
            print(client.get_job_status(args.job_id))
            return 0
        if args.job_command == "logs":
            print(client.get_job_logs(args.job_id), end="")
            return 0
        return 2
    finally:
        client.close()


def _cmd_logs(args) -> int:
    """List or tail session daemon + worker logs. ``--follow`` streams
    live, including each REMOTE raylet's worker output via its
    ``read_logs`` RPC (per-node agent log plane)."""
    import glob
    if args.follow:
        return _follow_logs(args)
    # the jobs' logs (session dir "jobs") match the first pattern
    paths = sorted(glob.glob(session_dir("*", "*.log"))
                   + glob.glob(session_dir("*", "logs", "*.out")))
    if args.session:
        paths = [p for p in paths if args.session in p]
    if not paths:
        print("no logs found")
        return 0
    if args.list:
        for p in paths:
            print(f"{os.path.getsize(p):>10}  {p}")
        return 0
    for p in paths:
        print(f"==> {p} <==")
        with open(p, "r", errors="replace") as f:
            lines = f.readlines()
        for line in lines[-args.tail:]:
            print(line, end="")
        print()
    return 0


def _remote_log_sources(address: str):
    """[(node_hex, rpc_client)] for every reachable raylet registered
    at the GCS (the LogMonitor's remote-source shape)."""
    from ray_tpu_torch._private.gcs_client import GcsClient
    from ray_tpu_torch._private.rpc import RpcClient
    host, port = address.rsplit(":", 1)
    gcs = GcsClient((host, int(port)))
    sources = []
    try:
        for info in gcs.get_all_node_info():
            if not info.alive or info.rpc_addr is None:
                continue
            try:
                client = RpcClient(tuple(info.rpc_addr))
            except OSError:
                continue       # node listed but unreachable: skip it
            sources.append((info.node_id.hex(), client))
    finally:
        gcs.close()
    return sources


def _follow_logs(args) -> int:
    """The driver's LogMonitor, run in the foreground with a stdout
    sink — one shared tail implementation (cursoring, rotation, UTF-8
    boundaries live in log_monitor.py only)."""
    import glob
    import time as _time

    from ray_tpu_torch._private.log_monitor import LogMonitor
    if args.address:
        _install_token(args)
    # Eager first fetch: a bad address/token should ERROR at startup,
    # not produce a silent empty stream.
    initial = _remote_log_sources(args.address) if args.address else []
    remote_state = {"sources": initial, "ts": _time.monotonic()}

    def remote_sources():
        # Re-query the GCS every ~10s: nodes that join (or become
        # reachable) after the command starts get streamed too.
        if not args.address:
            return []
        now = _time.monotonic()
        if now - remote_state["ts"] > 10.0:
            remote_state["ts"] = now
            try:
                known = {h for h, _c in remote_state["sources"]}
                for node_hex, client in _remote_log_sources(
                        args.address):
                    if node_hex not in known:
                        remote_state["sources"].append((node_hex,
                                                        client))
            except Exception:
                pass    # node flapped mid-poll: retry next tick
            remote_state["sources"] = [
                (h, c) for h, c in remote_state["sources"] if c.alive]
        return remote_state["sources"]

    pattern = session_dir(f"{args.session or ''}*", "logs")
    monitor = LogMonitor(
        local_dirs=lambda: glob.glob(pattern),
        remote_sources=remote_sources,
        sink=lambda line: print(line, flush=True),
        start=False)
    try:
        while True:
            monitor.poll_once()
            _time.sleep(0.5)
    except KeyboardInterrupt:
        return 0


def _cmd_client_server(args) -> int:
    """Start a client server: remote drivers connect with
    ``ray_tpu_torch.init(address="rtpu://HOST:PORT")`` + the session token."""
    import subprocess
    import sys as _sys
    import time as _time

    from ray_tpu_torch._private import rpc as _rpc
    from ray_tpu_torch._private.config import get_config
    _install_token(args)
    d = session_dir("client_server")
    os.makedirs(d, exist_ok=True)
    port_file = os.path.join(d, f"cs_{os.getpid()}.addr")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    if args.token:
        env["RTPU_SESSION_TOKEN"] = args.token
    proc = subprocess.Popen(
        [_sys.executable, "-m", "ray_tpu_torch._private.client_server",
         "--address", args.address, "--port-file", port_file,
         "--config", get_config().serialize()],
        env=env, start_new_session=True)
    deadline = _time.monotonic() + 60
    while _time.monotonic() < deadline:
        if os.path.exists(port_file):
            addr = open(port_file).read().strip()
            print(f"client server started (pid {proc.pid}); connect "
                  f"remote drivers with "
                  f"ray_tpu_torch.init(address=\"rtpu://{addr}\")")
            return 0
        if proc.poll() is not None:
            print(f"client server died on startup "
                  f"(rc={proc.returncode})", file=sys.stderr)
            return 1
        _time.sleep(0.05)
    print("client server did not report its address", file=sys.stderr)
    return 1


def _cmd_workflows(args) -> int:
    from ray_tpu_torch import workflow
    rows = workflow.list_all(args.storage)
    if not rows:
        print("no workflows")
        return 0
    for wid, status in rows:
        print(f"{wid:32} {status}")
    return 0


def _cmd_stack(args) -> int:
    """Live Python stacks from every raylet node (or one): the
    py-spy-style on-demand host profiler, served by each raylet's
    ``dump_stacks`` RPC."""
    from ray_tpu_torch._private.gcs_client import GcsClient
    from ray_tpu_torch._private.rpc import RpcClient
    _install_token(args)
    host, port = args.address.rsplit(":", 1)
    gcs = GcsClient((host, int(port)))
    try:
        shown = 0
        for info in gcs.get_all_node_info():
            hexid = info.node_id.hex()
            if args.node and not hexid.startswith(args.node):
                continue
            if not info.alive or info.rpc_addr is None:
                continue
            client = RpcClient(tuple(info.rpc_addr))
            try:
                stacks = client.call("dump_stacks", timeout=15)
            finally:
                client.close()
            for proc, text in stacks.items():
                print(f"===== node {hexid[:12]} {proc} =====")
                print(text)
                shown += 1
        if not shown:
            print("no addressable raylet matched (head-node stacks: "
                  "ray_tpu_torch.dump_stacks() from the driver)")
            return 1
        return 0
    finally:
        gcs.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("start", help="start a GCS head or a raylet")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", default="",
                    help="GCS address to join (HOST:PORT)")
    sp.add_argument("--session", default="cli")
    sp.add_argument("--num-cpus", type=float, default=4)
    sp.add_argument("--num-gpus", type=float, default=0,
                    help="GPUs of the node (refused with --address: a "
                         "raylet process sees no card)")
    sp.add_argument("--resources", default="",
                    help="extra resources as JSON")
    sp.add_argument("--max-workers", type=int, default=2)
    sp.add_argument("--token", default="",
                    help="session token (joiners: as printed by --head)")
    sp.set_defaults(fn=_cmd_start)

    sp = sub.add_parser("list", help="list tasks/actors/objects/nodes/"
                                     "workers (ray list analog)")
    sp.add_argument("what", choices=sorted(_LIST_COLUMNS))
    sp.add_argument("--dashboard", default="",
                    help="live driver's dashboard HOST:PORT (all kinds)")
    sp.add_argument("--address", default="",
                    help="GCS HOST:PORT (nodes/actors only)")
    sp.add_argument("--token", default="")
    sp.add_argument("--format", choices=("table", "json"),
                    default="table")
    sp.set_defaults(fn=_cmd_list)

    sp = sub.add_parser("memory",
                        help="object-store usage + live refs "
                             "(ray memory analog)")
    sp.add_argument("--dashboard", required=True,
                    help="live driver's dashboard HOST:PORT")
    sp.add_argument("--verbose", action="store_true",
                    help="also print the per-object table")
    sp.set_defaults(fn=_cmd_memory)

    sp = sub.add_parser("timeline",
                        help="export Chrome-trace task timeline")
    sp.add_argument("--dashboard", required=True,
                    help="live driver's dashboard HOST:PORT")
    sp.add_argument("--out", default="timeline.json")
    sp.set_defaults(fn=_cmd_timeline)

    sp = sub.add_parser("status", help="cluster state from the GCS")
    sp.add_argument("--address", required=True)
    sp.add_argument("--token", default="")
    sp.set_defaults(fn=_cmd_status)

    sp = sub.add_parser("stop", help="terminate cluster processes")
    sp.add_argument("--session", default="")
    sp.set_defaults(fn=_cmd_stop)

    sp = sub.add_parser("stack",
                        help="live Python stacks from raylet nodes "
                             "(host profiler)")
    sp.add_argument("--address", required=True, help="GCS host:port")
    sp.add_argument("--node", default="",
                    help="hex node-id prefix to restrict to")
    sp.add_argument("--token", default="", help="session token")
    sp.set_defaults(fn=_cmd_stack)

    sp = sub.add_parser("workflows", help="list workflows")
    sp.add_argument("--storage", default=None)
    sp.set_defaults(fn=_cmd_workflows)

    sp = sub.add_parser("client-server",
                        help="serve proxied remote drivers (rtpu://)")
    sp.add_argument("--address", required=True, help="GCS host:port")
    sp.add_argument("--token", default="", help="session token")
    sp.set_defaults(fn=_cmd_client_server)

    sp = sub.add_parser("logs", help="list/tail session daemon logs")
    sp.add_argument("--session", default="")
    sp.add_argument("--list", action="store_true")
    sp.add_argument("--tail", type=int, default=50)
    sp.add_argument("--follow", action="store_true",
                    help="stream live, incl. remote raylets' worker "
                         "output (needs --address for remote nodes)")
    sp.add_argument("--address", default="",
                    help="GCS host:port for remote-node log streaming")
    sp.add_argument("--token", default="", help="session token")
    sp.set_defaults(fn=_cmd_logs)

    sp = sub.add_parser("job", help="submit/track jobs")
    jsub = sp.add_subparsers(dest="job_command", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--address", required=True)
    js.add_argument("--token", default="", help="session token")
    js.add_argument("--no-wait", action="store_true")
    js.add_argument("--timeout", type=float, default=600.0)
    js.add_argument("entrypoint", nargs=argparse.REMAINDER)
    js.set_defaults(fn=_cmd_job)
    for name in ("list", "status", "logs"):
        jp = jsub.add_parser(name)
        jp.add_argument("--address", required=True)
        jp.add_argument("--token", default="", help="session token")
        if name in ("status", "logs"):
            jp.add_argument("job_id")
        jp.set_defaults(fn=_cmd_job)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
