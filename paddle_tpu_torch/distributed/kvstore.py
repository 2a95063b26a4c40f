"""TCP key-value store — the port of paddle_tpu/distributed/kvstore.py, a
ctypes binding over `paddle_tpu_torch/csrc/kvstore.cc`.

The coordination substrate the reference gets from etcd3
(`fleet/elastic/manager.py:103,147`) and gloo rendezvous: one
authoritative store process (host 0 or a sidecar), every node a TCP
client. Atomic `add` gives barriers and rank assignment; `list(prefix)`
gives membership views for the elastic manager (`distributed.elastic`,
`ElasticManager(store=KVClient(...))`).

The library is host code: `ops/_build.load_host` compiles it with g++
at first use (never at import) into `build/paddle_tpu_torch/`. Its wire
protocol is the JAX package's, so this client talks to a JAX
`KVServer` and a JAX `KVClient` to this server.
"""
import ctypes
import threading
import time

__all__ = ["KVServer", "KVClient"]

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ..ops import _build
        lib = _build.load_host("kvstore")
        lib.kvs_server_start.restype = ctypes.c_void_p
        lib.kvs_server_start.argtypes = [ctypes.c_int]
        lib.kvs_server_port.restype = ctypes.c_int
        lib.kvs_server_port.argtypes = [ctypes.c_void_p]
        lib.kvs_server_stop.argtypes = [ctypes.c_void_p]
        lib.kvs_connect.restype = ctypes.c_void_p
        lib.kvs_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int]
        lib.kvs_set.restype = ctypes.c_int64
        lib.kvs_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_int64]
        lib.kvs_get.restype = ctypes.c_int64
        lib.kvs_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.kvs_del.restype = ctypes.c_int64
        lib.kvs_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.kvs_add.restype = ctypes.c_int64
        lib.kvs_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int64]
        lib.kvs_list.restype = ctypes.c_int64
        lib.kvs_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.kvs_copy.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int64]
        lib.kvs_client_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class KVServer:
    """Authoritative store; run one per job (host 0 / launcher)."""

    def __init__(self, port=0):
        lib = _load()
        self._h = lib.kvs_server_start(port)
        if not self._h:
            raise RuntimeError(f"kvstore: cannot bind port {port}")
        self.port = lib.kvs_server_port(self._h)

    def stop(self):
        if self._h:
            _load().kvs_server_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class KVClient:
    """TCP client. Values are bytes; str convenience on top."""

    def __init__(self, host="127.0.0.1", port=0, timeout_s=30.0,
                 retry_s=10.0):
        self.host, self.port = host, port
        lib = _load()
        deadline = time.monotonic() + retry_s
        self._h = None
        while True:
            self._h = lib.kvs_connect(host.encode(), port,
                                      int(timeout_s * 1000))
            if self._h or time.monotonic() > deadline:
                break
            time.sleep(0.1)                    # server may still be binding
        if not self._h:
            raise ConnectionError(f"kvstore: cannot reach {host}:{port}")

    def _fetch(self, n):
        buf = ctypes.create_string_buffer(int(n))
        _load().kvs_copy(self._h, buf, n)
        return buf.raw[:n]

    def set(self, key, value):
        v = value.encode() if isinstance(value, str) else bytes(value)
        st = _load().kvs_set(self._h, key.encode(), v, len(v))
        if st != 0:
            raise ConnectionError("kvstore: set failed")

    def get(self, key, default=None):
        n = _load().kvs_get(self._h, key.encode())
        if n == -1:
            return default
        if n < 0:
            raise ConnectionError("kvstore: get failed")
        return self._fetch(n)

    def get_str(self, key, default=None):
        v = self.get(key)
        return default if v is None else v.decode()

    def delete(self, key):
        return _load().kvs_del(self._h, key.encode()) == 0

    def add(self, key, delta=1):
        out = _load().kvs_add(self._h, key.encode(), int(delta))
        if out == -(2 ** 63):
            raise ConnectionError("kvstore: add failed")
        return out

    def list(self, prefix=""):
        n = _load().kvs_list(self._h, prefix.encode())
        if n < 0:
            raise ConnectionError("kvstore: list failed")
        raw = self._fetch(n).decode()
        return raw.split("\n") if raw else []

    # ---- coordination primitives ----
    def barrier(self, name, world_size, timeout_s=60.0, poll_s=0.05):
        """All `world_size` callers block until everyone arrived.
        Reference analog: gloo barrier in fleet launch. Two-phase
        (arrive + observe full count) on one atomic counter."""
        n = self.add(f"__barrier__/{name}/count", 1)
        deadline = time.monotonic() + timeout_s
        while n < world_size:
            if time.monotonic() > deadline:
                raise TimeoutError(f"barrier {name}: {n}/{world_size}")
            time.sleep(poll_s)
            n = self.add(f"__barrier__/{name}/count", 0)
        return True

    def rank_assign(self, name, world_size, timeout_s=60.0):
        """First-come rank assignment: returns a unique rank in
        [0, world_size); blocks until all ranks are claimed."""
        rank = self.add(f"__rank__/{name}", 1) - 1
        if rank >= world_size:
            raise RuntimeError(f"rank_assign {name}: more than "
                               f"{world_size} participants")
        self.barrier(f"__rank_assign__/{name}", world_size, timeout_s)
        return int(rank)

    def wait(self, key, timeout_s=60.0, poll_s=0.05):
        """Block until `key` exists; returns its value."""
        deadline = time.monotonic() + timeout_s
        while True:
            v = self.get(key)
            if v is not None:
                return v
            if time.monotonic() > deadline:
                raise TimeoutError(f"kvstore: wait({key}) timed out")
            time.sleep(poll_s)

    def close(self):
        if self._h:
            _load().kvs_client_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
