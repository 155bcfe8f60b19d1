"""Leader election + leader duties.

The reference elects a leader through the coordination service and the
leader thread runs the rebalance pass every cluster.rebalance_interval
(reference: db/leader.cc:42-56; election via
config_directory.h:64-66). The standalone registry's analog of an
ephemeral coordination lock is an fcntl file lock: whichever process
holds <registry>.leader IS the leader (the lock dies with the process,
so leadership fails over automatically), and the holder runs the
rebalance pass on an interval.
"""

from __future__ import annotations

import fcntl
import os
import threading
from typing import Optional


class Leader:
    def __init__(
        self,
        config_dir_path: str,
        server_name: str,
        rebalance_interval: float = 30.0,
    ):
        self.config_dir_path = config_dir_path
        self.server_name = server_name
        self.rebalance_interval = rebalance_interval
        self._lockf = None
        self._zk_leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def is_leader(self) -> bool:
        return self._lockf is not None or self._zk_leader

    def try_acquire(self) -> bool:
        """Non-blocking leadership attempt (idempotent)."""
        if self.config_dir_path.startswith("zk://"):
            # ZooKeeper backend: create-race on the ephemeral /leader
            # node (reference: config_directory_zookeeper.cc:991-1012)
            from eventql_tpu_torch.config.config_directory import ConfigDirectory

            self._zk_leader = ConfigDirectory(
                self.config_dir_path).try_acquire_leader(self.server_name)
            return self._zk_leader
        if self._lockf is not None:
            return True
        path = self.config_dir_path + ".leader"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        f = open(path, "w")
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            f.close()
            return False
        f.write(self.server_name)
        f.flush()
        self._lockf = f
        return True

    def release(self):
        if self.config_dir_path.startswith("zk://"):
            from eventql_tpu_torch.config.config_directory import ConfigDirectory

            if self._zk_leader:
                self._zk_leader = False
                try:
                    ConfigDirectory(self.config_dir_path).release_leader()
                except Exception:
                    pass
            return
        if self._lockf is not None:
            fcntl.flock(self._lockf, fcntl.LOCK_UN)
            self._lockf.close()
            self._lockf = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.rebalance_interval + 5)
        self.release()

    def _run(self):
        try:
            # contest leadership at boot (reference: the leader thread
            # starts electing immediately, db/leader.cc:42-56), so
            # leader-gated workers don't wait a full interval
            self.try_acquire()
        except Exception:
            pass
        while not self._stop.wait(self.rebalance_interval):
            try:
                if self.try_acquire():
                    self.run_leader_duties()
            except Exception:
                pass  # registry contention; retry next tick

    def run_leader_duties(self):
        """One leader pass: rebalance placements (reference: the leader
        thread's Rebalance::runOnce, db/leader.cc:48-55)."""
        from eventql_tpu_torch.config.config_directory import ConfigDirectory
        from eventql_tpu_torch.db.rebalance import rebalance

        rebalance(ConfigDirectory(self.config_dir_path))
