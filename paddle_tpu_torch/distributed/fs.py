"""Filesystem abstraction for distributed checkpoint and dataset IO —
the port of paddle_tpu/distributed/fs.py (reference
`python/paddle/distributed/fleet/utils/fs.py`: the `FS` base `:57`,
`LocalFS` `:102`, `HDFSClient` `:214`).

The JAX module uses nothing of JAX, and this is its copy, with the
port's `resilience.retry` and `resilience.chaos` underneath:

- `LocalFS` is the local filesystem with the reference's semantics
  (`ls_dir` -> (dirs, files), sorted; `mv` refuses an existing
  destination unless `overwrite`; a local "upload" is a copy).
- `HDFSClient` shells out to `<hadoop_home>/bin/hadoop fs`. Its
  constructor raises `ExecuteError` when that binary is absent, rather
  than failing on first use. Every command but a probe (`-test`) runs
  under `with_retry`: a failure whose stderr does not name the path as
  the problem (`_hdfs_transient`) backs off and retries, `sleep_inter`
  (ms) being the base delay, and each attempt passes the chaos hook
  `inject("fs")`. A probe runs once: a nonzero exit is its answer. A
  command that fails for good raises the CLI's `ExecuteError`.

It is reached as `paddle_tpu_torch.distributed.LocalFS` / `HDFSClient`
and through fleet (`fleet.utils.fs`, `fleet.LocalFS`,
`fleet.HDFSClient`), as in the JAX package; the checkpoints of
`resilience/ckpt.py` write the local disk directly, as JAX's do.
"""
import os
import shutil
import subprocess

__all__ = ["ExecuteError", "FSFileExistsError", "FSFileNotExistsError",
           "FS", "LocalFS", "HDFSClient"]


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FS:
    """Abstract filesystem (reference `fs.py:57`)."""

    def ls_dir(self, path):
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def rename(self, src, dst):
        raise NotImplementedError

    def mv(self, src, dst, overwrite=False):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def touch(self, path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """Local filesystem (reference `fs.py:102`)."""

    def ls_dir(self, path):
        """(dirs, files) under `path`, each sorted; ([], []) when `path`
        does not exist."""
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            if os.path.isdir(os.path.join(path, name)):
                dirs.append(name)
            else:
                files.append(name)
        return dirs, files

    def is_file(self, path):
        return os.path.isfile(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def need_upload_download(self):
        return False

    def rename(self, src, dst):
        os.rename(src, dst)

    def mv(self, src, dst, overwrite=False, test_exists=True):
        if test_exists and not self.is_exist(src):
            raise FSFileNotExistsError(f"{src} not found")
        if self.is_exist(dst):
            if not overwrite:
                raise FSFileExistsError(f"{dst} exists")
            self.delete(dst)
        shutil.move(src, dst)

    def upload(self, local_path, fs_path):
        # local -> local: a copy, as the reference's
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path)
        else:
            shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        self.upload(fs_path, local_path)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path):
            if not exist_ok:
                raise FSFileExistsError(f"{path} exists")
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a"):
            pass

    def list_dirs(self, path):
        return self.ls_dir(path)[0]


# stderr that names the path itself as the problem: retrying cannot
# change the answer, only delay it
_HDFS_PERMANENT = ("no such file", "file exists", "permission denied",
                   "does not exist", "not a directory", "is a directory")


def _hdfs_transient(stderr):
    low = (stderr or "").lower()
    return not any(t in low for t in _HDFS_PERMANENT)


class HDFSClient(FS):
    """HDFS through the hadoop CLI (reference `fs.py:214`; see the module
    docstring). `time_out` and `sleep_inter` are milliseconds;
    `retry_policy` (a `resilience.retry.RetryPolicy`) replaces the
    default of 3 attempts from a `sleep_inter` base delay."""

    def __init__(self, hadoop_home, configs=None, time_out=5 * 60 * 1000,
                 sleep_inter=1000, retry_policy=None):
        self._base = os.path.join(hadoop_home, "bin", "hadoop")
        if not os.path.exists(self._base):
            raise ExecuteError(
                f"hadoop CLI not found at {self._base}; HDFSClient needs a "
                "hadoop install (unavailable in this environment)")
        self._cfg = []
        for k, v in (configs or {}).items():
            self._cfg += ["-D", f"{k}={v}"]
        self._timeout = time_out / 1000.0
        if retry_policy is None:
            from ..resilience.retry import RetryPolicy
            retry_policy = RetryPolicy(max_attempts=3,
                                       base_delay_s=sleep_inter / 1000.0,
                                       max_delay_s=30.0)
        self._retry = retry_policy

    def _run_once(self, cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=self._timeout)
        if proc.returncode != 0:
            err = ExecuteError(f"{' '.join(cmd)}: {proc.stderr}")
            err.transient = _hdfs_transient(proc.stderr)
            raise err
        return proc.stdout

    def _run(self, *args, _retry=True):
        from ..resilience.retry import with_retry
        cmd = [self._base, "fs"] + self._cfg + list(args)
        if not _retry:
            # a probe skips the chaos hook too: an injected OSError would
            # get past the callers' `except ExecuteError`, which no real
            # CLI failure can
            return self._run_once(cmd)

        def attempt():
            from ..resilience import chaos
            chaos.inject("fs")
            return self._run_once(cmd)

        try:
            return with_retry(attempt, policy=self._retry,
                              label=f"hdfs {args[0]}")
        except Exception as e:
            last = getattr(e, "last", None)
            if last is not None:
                raise last from e     # the caller sees the CLI's error
            raise

    def ls_dir(self, path):
        out = self._run("-ls", path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, path):
        try:
            self._run("-test", "-e", path, _retry=False)
            return True
        except ExecuteError:
            return False

    def is_dir(self, path):
        try:
            self._run("-test", "-d", path, _retry=False)
            return True
        except ExecuteError:
            return False

    def is_file(self, path):
        return self.is_exist(path) and not self.is_dir(path)

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        if self.is_exist(path):
            self._run("-rm", "-r", path)

    def need_upload_download(self):
        return True

    def mv(self, src, dst, overwrite=False, test_exists=True):
        if overwrite and self.is_exist(dst):
            self.delete(dst)
        self._run("-mv", src, dst)

    rename = mv

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path):
            if not exist_ok:
                raise FSFileExistsError(path)
            return
        self._run("-touchz", path)
