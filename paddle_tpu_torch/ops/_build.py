"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain `extern "C"` interface and is compiled
on its own, at first use, into `build/paddle_tpu_torch/` at the root of
the checkout:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
         -o build/paddle_tpu_torch/<name>-<hash>.so
         paddle_tpu_torch/csrc/<name>.cu

The library name carries a hash of the source, of every header it
includes from `csrc/` (`#include "..."`, followed through the headers'
own includes) and of the flags, so a changed source or header is
rebuilt and an unchanged one is loaded as it is. A
library that includes no PyTorch header builds in seconds, where
`torch.utils.cpp_extension.load` takes minutes. `build(names)` starts
one nvcc per source, all at once; `ptxas_info(name)` reads back each
kernel's registers, spills and static shared memory from the build's
`-Xptxas -v` report, which is kept beside the library
(`<name>-<hash>.log`), so a library built by an earlier process still
has it.

Processes that share a checkout (the fleet's replica processes) build
under one file lock, `build/paddle_tpu_torch/.lock` (`fcntl.flock`,
released by the kernel when its holder exits, so a killed build leaves
no stale lock): a process that finds another building waits, then loads
what that one built. The in-process `threading.Lock` alone guards only
this process's threads.
"""
import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["build", "load", "launcher", "check_launch", "build_dir",
           "nvcc_path", "ptxas_info"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}


def build_dir():
    return _PKG.parent / "build" / "paddle_tpu_torch"


def nvcc_path():
    """nvcc from PATH, else from the CUDA toolkit under CUDA_HOME or its
    usual install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and under "
                       f"{home}/bin); the CUDA toolkit is needed to "
                       "build the port's kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src):
    """`src` and the local headers it includes, each once, in the order
    they are first reached."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def _target(name):
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for path in _sources(src):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name):
    """Start nvcc for `name` unless its library exists with its ptxas
    report beside it; returns (process or None, temporary output, final
    path)."""
    src, so = _target(name)
    if so.exists() and _report_path(so).exists():
        return None, None, so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name, proc, tmp, so):
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    # the report first: a library in place always has its report beside it
    _report_path(so).write_text(out)
    os.replace(tmp, so)


def _report_path(so):
    return so.with_suffix(".log")


@contextlib.contextmanager
def _file_lock():
    """Hold the checkout's build lock (exclusive, across processes)."""
    d = build_dir()
    d.mkdir(parents=True, exist_ok=True)
    with open(d / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names):
    """Compile every named kernel source that is not built yet, one
    nvcc process per source, all running at once."""
    with _lock, _file_lock():
        started = [(n, *_start(n)) for n in names]
        errors = []
        for name, proc, tmp, so in started:
            try:
                _finish(name, proc, tmp, so)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name):
    """The ctypes library of kernel `name`, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            with _file_lock():
                _finish(name, *_start(name))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _loaded[name] = lib
        return lib


def launcher(name, symbol, argtypes):
    """(launch function `symbol` of library `name`, the library's
    `<name>_error_string`). Every launch function returns a cudaError_t
    as an int; its argument types are declared on first use."""
    lib = load(name)
    fn = getattr(lib, symbol)
    err = getattr(lib, f"{name}_error_string")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return fn, err


def check_launch(kernel, rc, err):
    """Raise unless the launch returned cudaSuccess (0)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {err(rc).decode()} "
                           f"(cudaError {rc})")


def ptxas_info(name):
    """{kernel function: {registers, smem, spills, and the ptxas
    "Potential Performance Loss" notes if any}} from `-Xptxas -v` for
    source `name`, read from the report kept beside its library ({} when
    it is not built)."""
    report = _report_path(_target(name)[1])
    text = report.read_text() if report.exists() else ""
    info, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\((C\d+)\) Potential Performance Loss.*function "
                      r"'(\S+)'", line)
        if m:
            info.setdefault(m.group(2), {}).setdefault(
                "performance_loss", []).append(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if fn and m:
            info.setdefault(fn, {})["spills"] = (int(m.group(1)),
                                                 int(m.group(2)))
        m = re.search(r"Used (\d+) registers(.*)", line)
        if fn and m:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            info.setdefault(fn, {}).update(
                registers=int(m.group(1)),
                smem=int(smem.group(1)) if smem else 0)
    return info
