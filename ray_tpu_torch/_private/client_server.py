"""Client server: hosts a proxied remote driver for ``rtpu://`` clients.

Reference: ``python/ray/util/client/server/proxier.py`` [UNVERIFIED —
mount empty, SURVEY.md §0] — a server inside the cluster that remote
"thin" drivers connect to. Here the server joins the cluster as a
normal driver (``init(address=GCS)``) and its nested-API surface (the
same RPC protocol task workers use) IS the client protocol, so clients
get tasks/actors/objects/PGs/streaming with no second code path.
Connections are gated by the session token like every other channel.

The port's copy of ``ray_tpu/_private/client_server.py``. ``--num-gpus``
goes to ``init``: left out, the server's driver counts the cards as
``init`` does (and, like ``init``, refuses to start on a host with
none); ``--num-gpus 0`` starts a CPU-only driver. ``GPU`` tasks of its
clients run on this driver's threads.

One embedded driver serves all clients of this server (the reference
runs one driver per client; run several client-servers for isolation).

    python -m ray_tpu_torch._private.client_server \
        --address GCS_HOST:PORT --port-file /path
"""

from __future__ import annotations

import argparse
import os
import signal
import threading


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--address", required=True, help="GCS host:port")
    p.add_argument("--port-file", required=True)
    p.add_argument("--config", default="")
    p.add_argument("--num-gpus", type=float, default=None,
                   help="GPUs of the server's driver (default: count the "
                        "cards; 0 for a CPU-only driver)")
    args = p.parse_args(argv)

    from ray_tpu_torch._private.config import get_config
    if args.config:
        get_config().load_serialized(args.config)

    from ray_tpu_torch._private.worker import init, shutdown
    w = init(address=args.address, num_gpus=args.num_gpus)
    host, port = w.node_group.object_server_addr
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{host}:{port}")
    os.replace(tmp, args.port_file)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        shutdown()


if __name__ == "__main__":
    main()
