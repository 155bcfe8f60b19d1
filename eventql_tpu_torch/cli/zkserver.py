"""evql-zkserver — embedded ZooKeeper-protocol coordination server.

The reference deploys against a ZooKeeper ensemble (vendored client in
deps/3rdparty/zookeeper); this build ships a single-node server
speaking the same wire protocol (eventql_tpu_torch/config/zookeeper.py), so
a cluster can run the ZooKeeper coordination path with no external
dependency:

    python -m eventql_tpu_torch.cli.zkserver --listen 127.0.0.1:2181
    python -m eventql_tpu_torch.cli.evqld --zookeeper_addr 127.0.0.1:2181/prod ...
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(prog="evql-zkserver")
    ap.add_argument(
        "--listen",
        default="127.0.0.1:2181",
        help="host:port to listen on (default 127.0.0.1:2181)",
    )
    args = ap.parse_args(argv)

    from eventql_tpu_torch.config.zookeeper import ZooKeeperServer

    host, _, port = args.listen.partition(":")
    srv = ZooKeeperServer(host or "127.0.0.1", int(port or 2181)).start()
    print(f"zookeeper server listening on {srv.address}", flush=True)

    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
