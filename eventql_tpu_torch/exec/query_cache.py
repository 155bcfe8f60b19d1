"""On-disk query cache for partial aggregation results.

Mirrors the reference's QueryCache (reference: sql/runtime/query_cache
.{h,cc}; used to cache PartialGroupBy outputs keyed by the table scan's
cache key + the expression fingerprint, groupby.cc:255-432). A cache
entry here is a serialized Relation (.npz), keyed by SHA1 of the
backing file identity (path, mtime, size) and the plan fingerprint.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np

from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec.relation import Column, Relation


class QueryCache:
    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    # -- keys -----------------------------------------------------------
    @staticmethod
    def file_cache_key(path: str) -> Optional[str]:
        """Identity of an on-disk table file; None if volatile."""
        try:
            st = os.stat(path)
        except OSError:
            return None
        return f"{os.path.abspath(path)}:{st.st_mtime_ns}:{st.st_size}"

    @staticmethod
    def fingerprint(*parts: str) -> str:
        h = hashlib.sha1()
        for p in parts:
            h.update(p.encode("utf-8"))
            h.update(b"\x00")
        return h.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, key + ".npz")

    # -- entries --------------------------------------------------------
    def get(self, key: str) -> Optional[Relation]:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=True) as z:
                names = [str(n) for n in z["__names__"]]
                stypes = [SType(int(t)) for t in z["__stypes__"]]
                num_rows = int(z["__num_rows__"])
                cols: List[Column] = []
                for i, (name, stype) in enumerate(zip(names, stypes)):
                    data = z[f"data_{i}"]
                    valid = z[f"valid_{i}"]
                    dictionary = (
                        z[f"dict_{i}"] if f"dict_{i}" in z.files else None
                    )
                    cols.append(Column(stype, data, valid, dictionary))
                return Relation(names, cols, num_rows)
        except Exception:
            return None

    def store(self, key: str, rel: Relation):
        arrays = {
            "__names__": np.array(rel.names, dtype=object),
            "__stypes__": np.array([int(c.stype) for c in rel.columns]),
            "__num_rows__": np.array(rel.num_rows),
        }
        for i, c in enumerate(rel.columns):
            arrays[f"data_{i}"] = c.data
            arrays[f"valid_{i}"] = c.valid
            if c.dictionary is not None:
                arrays[f"dict_{i}"] = c.dictionary
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, self._path(key))

    # -- raw entries ------------------------------------------------------
    # (serialized partial-aggregate frames on the distributed path —
    # the reference caches PartialGroupBy outputs the same way,
    # groupby.cc:255-295,411-432)
    def _blob_path(self, key: str) -> str:
        return os.path.join(self.cache_dir, key + ".bin")

    def get_blob(self, key: str):
        path = self._blob_path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            return None

    def store_blob(self, key: str, data: bytes):
        tmp = self._blob_path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._blob_path(key))
