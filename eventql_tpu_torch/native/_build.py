"""Build the port's C side: the C client library, the embedded server
library and its C host.

``native/evql_client.c`` (the C client, read where it lies, with
``-I native`` for ``evql.h``), and this directory's ``evql_server.c``
(the C server API over ``eventql_tpu_torch.server.embedded``) and
``embedded_server_smoke.c`` (a C host program of it) are compiled with
``cc`` at first use into ``build/<hash>/`` (not under version control),
the hash taken over the sources, the header and the flags, so an
unchanged checkout compiles once. Nothing is written under ``native/``.

The server library leaves the ``Py*`` symbols undefined: a Python
process that loads it with ``ctypes`` resolves them from its own
interpreter, whether that links libpython dynamically or statically, so
no second libpython is loaded. The C host links libpython itself (the
flags ``python3-config --ldflags --embed`` gives, taken from the running
interpreter's ``sysconfig``). A missing compiler or a failed compile
raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")
NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native")

CLIENT_LIB = "libevql_client.so"
SERVER_LIB = "libevql_server.so"
SMOKE_BIN = "embedded_server_smoke"

CFLAGS = ["-O2", "-fPIC", "-Wall", "-Wextra"]

_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def _python_includes() -> List[str]:
    paths = sysconfig.get_paths()
    return [f"-I{d}" for d in dict.fromkeys((paths["include"], paths["platinclude"]))]


def _python_embed_ldflags() -> List[str]:
    """What ``python3-config --ldflags --embed`` prints for the running
    interpreter, plus an rpath to its library directory."""
    var = sysconfig.get_config_var
    libdir = var("LIBDIR")
    flags = [f"-L{libdir}"]
    if not var("Py_ENABLE_SHARED"):
        flags.append(f"-L{var('LIBPL')}")
    flags.append(f"-lpython{var('VERSION')}{sys.abiflags}")
    flags += (var("LIBS") or "").split() + (var("SYSLIBS") or "").split()
    flags += (var("LINKFORSHARED") or "").split()
    return flags + [f"-Wl,-rpath,{libdir}"]


def _sources() -> Dict[str, str]:
    return {
        "evql_client.c": os.path.join(NATIVE_DIR, "evql_client.c"),
        "evql.h": os.path.join(NATIVE_DIR, "evql.h"),
        "evql_server.c": os.path.join(_HERE, "evql_server.c"),
        "embedded_server_smoke.c": os.path.join(_HERE, "embedded_server_smoke.c"),
    }


def _commands(cc: str, out: str) -> List[List[str]]:
    src = _sources()
    include = ["-I", NATIVE_DIR]
    return [
        [cc, *CFLAGS, "-shared", "-o", os.path.join(out, CLIENT_LIB), src["evql_client.c"]],
        [cc, *CFLAGS, *_python_includes(), "-shared", "-o", os.path.join(out, SERVER_LIB),
         src["evql_server.c"]],
        [cc, *CFLAGS, *include, *_python_includes(), "-o", os.path.join(out, SMOKE_BIN),
         src["embedded_server_smoke.c"], f"-L{out}", "-levql_server", "-levql_client",
         "-lpthread", *_python_embed_ldflags(), "-Wl,-rpath,$ORIGIN"],
    ]


def find_cc() -> str:
    path = shutil.which("cc")
    if path is None:
        raise NativeBuildError(
            "no C compiler (cc) on $PATH: the C client and the embedded"
            " server cannot be built"
        )
    return path


def _out_dir(cc: str) -> str:
    h = hashlib.sha256()
    for name, path in sorted(_sources().items()):
        with open(path, "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    for cmd in _commands(cc, "<out>"):
        h.update(" ".join(cmd[1:]).encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16])


def build() -> str:
    """The directory that holds the three built files, compiling them
    first if this checkout has not; raises NativeBuildError."""
    with _LOCK:
        cc = find_cc()
        out = _out_dir(cc)
        if os.path.isdir(out):
            return out
        # built in a directory of this process's own and renamed whole, so
        # a process that finds ``out`` finds all three files
        tmp = f"{out}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            for cmd in _commands(cc, tmp):
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise NativeBuildError(
                        f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                    )
            try:
                os.rename(tmp, out)
            except OSError:
                if not os.path.isdir(out):  # else another process built it first
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return out


def path(name: str) -> str:
    """The built file ``name`` (CLIENT_LIB, SERVER_LIB or SMOKE_BIN)."""
    return os.path.join(build(), name)


def host_env() -> Dict[str, str]:
    """The environment for the C host: this interpreter's ``sys.path`` on
    PYTHONPATH, so its embedded interpreter finds this checkout's package
    and the same torch."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    return env
