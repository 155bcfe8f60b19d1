"""Networked load generator (reference: evqlslap.cc + cli/benchmark.h:
N threads, rate control, rolling RPS/latency stats, query & insert
modes) against the HTTP or native-TCP transport."""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request


class RollingStats:
    # reference: cli/benchmark.h:37-58 rolling RPS + latency window
    def __init__(self):
        self.lock = threading.Lock()
        self.count = 0
        self.errors = 0
        self.total_latency = 0.0
        self.max_latency = 0.0

    def record(self, latency: float, error: bool):
        with self.lock:
            self.count += 1
            if error:
                self.errors += 1
            self.total_latency += latency
            self.max_latency = max(self.max_latency, latency)

    def snapshot_and_reset(self):
        with self.lock:
            snap = (self.count, self.errors, self.total_latency, self.max_latency)
            self.count = 0
            self.errors = 0
            self.total_latency = 0.0
            self.max_latency = 0.0
        return snap


def main(argv=None):
    ap = argparse.ArgumentParser(prog="evqlslap")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("-p", "--port", type=int, default=9175)
    ap.add_argument("-m", "--mode", choices=["query", "insert"], default="query")
    ap.add_argument("-q", "--query", default="select 1;")
    ap.add_argument("--table", default=None, help="insert-mode target table")
    ap.add_argument("-t", "--threads", type=int, default=4)
    ap.add_argument("-r", "--rate", type=int, default=0, help="target requests/s (0 = unthrottled)")
    ap.add_argument("-d", "--duration", type=float, default=5.0, help="seconds")
    args = ap.parse_args(argv)

    stats = RollingStats()
    stop = threading.Event()
    url = f"http://{args.host}:{args.port}/api/v1/sql"
    insert_url = f"http://{args.host}:{args.port}/api/v1/tables/insert"
    per_thread_interval = (
        args.threads / args.rate if args.rate > 0 else 0.0
    )

    seq = [0]
    seq_lock = threading.Lock()

    def one_request():
        with seq_lock:
            seq[0] += 1
            i = seq[0]
        t0 = time.perf_counter()
        err = False
        try:
            if args.mode == "query":
                req = urllib.request.Request(
                    url, data=json.dumps({"query": args.query}).encode()
                )
            else:
                req = urllib.request.Request(
                    insert_url,
                    data=json.dumps(
                        [{"table": args.table, "data": {"id": i, "value": i * 7}}]
                    ).encode(),
                )
            with urllib.request.urlopen(req, timeout=30) as resp:
                resp.read()
        except Exception:
            err = True
        stats.record(time.perf_counter() - t0, err)

    def worker():
        while not stop.is_set():
            t0 = time.perf_counter()
            one_request()
            if per_thread_interval:
                sleep = per_thread_interval - (time.perf_counter() - t0)
                if sleep > 0:
                    stop.wait(sleep)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(args.threads)]
    start = time.time()
    for t in threads:
        t.start()

    try:
        while time.time() - start < args.duration:
            time.sleep(1.0)
            count, errors, total_lat, max_lat = stats.snapshot_and_reset()
            avg = total_lat / count * 1e3 if count else 0.0
            print(
                f"rps: {count}  errors: {errors}  avg latency: {avg:.2f} ms"
                f"  max: {max_lat * 1e3:.2f} ms",
                flush=True,
            )
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
