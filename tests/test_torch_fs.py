"""The port's filesystem layer (`paddle_tpu_torch.distributed.fs`)
against the JAX package's, on the CPU, in one process.

- `LocalFS`: the same sequence of calls on two temporary trees (one
  each) gives the same answers, the same errors and the same trees;
- `HDFSClient` without a hadoop binary raises `ExecuteError` at
  construction, with JAX's message; against a fake `bin/hadoop` script
  (tests/test_resilience.py's): a transient failure is retried until it
  lands, a probe runs once, a permanent error fails at once, and the
  chaos hook `inject("fs")` fires on every attempt of a command and on
  no probe; the stderr classifier is JAX's;
- the exports: `paddle_tpu_torch.distributed.LocalFS`/`HDFSClient` and
  fleet's `utils.fs`, `utils.LocalFS`, `utils.HDFSClient` (JAX's
  `fleet.utils` namespace), as the JAX package reaches them.
"""
import os

import pytest

from paddle_tpu.distributed import fs as jfs

from paddle_tpu_torch.distributed import fs as tfs
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.retry import RetryPolicy


def _fast(**kw):
    kw.setdefault("max_attempts", 4)
    kw.setdefault("base_delay_s", 0.0005)
    kw.setdefault("max_delay_s", 0.001)
    return RetryPolicy(**kw)


def _tree(root):
    """{relative path: file text or None for a directory} under root."""
    out = {}
    for d, dirs, files in os.walk(root):
        for n in dirs:
            out[os.path.relpath(os.path.join(d, n), root)] = None
        for n in files:
            with open(os.path.join(d, n)) as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _script(fs, root):
    """One walk over LocalFS's API -> [(call, answer or error name)]."""
    def p(*a):
        return os.path.join(root, *a)

    steps = [
        ("ls_dir missing", lambda: fs.ls_dir(p("nope"))),
        ("mkdirs", lambda: fs.mkdirs(p("a", "b"))),
        ("mkdirs again", lambda: fs.mkdirs(p("a", "b"))),
        ("touch", lambda: fs.touch(p("a", "f.txt"))),
        ("touch exists ok", lambda: fs.touch(p("a", "f.txt"))),
        ("touch exists", lambda: fs.touch(p("a", "f.txt"), exist_ok=False)),
        ("touch deep", lambda: fs.touch(p("c", "d", "g.txt"))),
        ("is_file", lambda: fs.is_file(p("a", "f.txt"))),
        ("is_dir", lambda: fs.is_dir(p("a"))),
        ("is_exist", lambda: fs.is_exist(p("a", "nope"))),
        ("ls_dir", lambda: fs.ls_dir(p("a"))),
        ("list_dirs", lambda: fs.list_dirs(root)),
        ("upload file", lambda: fs.upload(p("a", "f.txt"), p("u.txt"))),
        ("upload dir", lambda: fs.upload(p("a"), p("a2"))),
        ("download", lambda: fs.download(p("u.txt"), p("v.txt"))),
        ("mv", lambda: fs.mv(p("v.txt"), p("w.txt"))),
        ("mv missing", lambda: fs.mv(p("v.txt"), p("x.txt"))),
        ("mv onto", lambda: fs.mv(p("w.txt"), p("u.txt"))),
        ("mv overwrite", lambda: fs.mv(p("w.txt"), p("u.txt"),
                                       overwrite=True)),
        ("rename", lambda: fs.rename(p("a2"), p("a3"))),
        ("delete file", lambda: fs.delete(p("u.txt"))),
        ("delete dir", lambda: fs.delete(p("c"))),
        ("delete missing", lambda: fs.delete(p("nope"))),
        ("need_upload_download", fs.need_upload_download),
        ("ls_dir root", lambda: fs.ls_dir(root)),
    ]
    out = []
    for name, fn in steps:
        try:
            out.append((name, fn()))
        except Exception as e:
            out.append((name, type(e).__name__))
    return out


def test_localfs_matches_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _script(jfs.LocalFS(), str(tmp_path / "jax"))
    got = _script(tfs.LocalFS(), str(tmp_path / "port"))
    assert got == want
    assert dict(want)["mv missing"] == "FSFileNotExistsError"
    assert dict(want)["touch exists"] == "FSFileExistsError"
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))


def test_hdfs_without_hadoop_raises_as_jax_does(tmp_path):
    with pytest.raises(jfs.ExecuteError) as want:
        jfs.HDFSClient(str(tmp_path))
    with pytest.raises(tfs.ExecuteError) as got:
        tfs.HDFSClient(str(tmp_path))
    assert str(got.value) == str(want.value)
    assert "hadoop CLI not found" in str(got.value)


def _fake_hadoop(tmp_path, body):
    home = tmp_path / "hadoop"
    (home / "bin").mkdir(parents=True)
    hadoop = home / "bin" / "hadoop"
    hadoop.write_text("#!/bin/sh\n" + body)
    hadoop.chmod(0o755)
    return str(home)


def test_hdfs_retries_transient_failures_and_probes_once(tmp_path):
    """The fake CLI fails twice with a transient error, then succeeds:
    the command lands on its third attempt; a probe is one call."""
    state, calls = tmp_path / "attempts", tmp_path / "calls.log"
    home = _fake_hadoop(tmp_path, f"""echo "$@" >> {calls}
case "$*" in
  *-test*) exit 1 ;;
esac
n=$(cat {state} 2>/dev/null || echo 0)
echo $((n + 1)) > {state}
if [ "$n" -lt 2 ]; then
  echo "Connection refused" >&2
  exit 1
fi
echo "ok"
""")
    fs = tfs.HDFSClient(home, retry_policy=_fast(max_attempts=5))
    assert fs.mkdirs("/x") is None
    assert state.read_text().strip() == "3"
    n = len(calls.read_text().splitlines())
    assert fs.is_exist("/nope") is False
    assert len(calls.read_text().splitlines()) == n + 1


def test_hdfs_permanent_error_fails_at_once(tmp_path):
    calls = tmp_path / "calls.log"
    home = _fake_hadoop(tmp_path, f"""echo "$@" >> {calls}
echo "ls: '/x': No such file or directory" >&2
exit 1
""")
    fs = tfs.HDFSClient(home, retry_policy=_fast(max_attempts=5))
    with pytest.raises(tfs.ExecuteError, match="No such file"):
        fs.ls_dir("/x")
    assert len(calls.read_text().splitlines()) == 1


def test_hdfs_chaos_hook_fires_on_commands_not_probes(tmp_path):
    """Under a chaos monkey faulting every "fs" point twice, a command
    retries past both injected faults; a probe never meets the hook."""
    calls = tmp_path / "calls.log"
    home = _fake_hadoop(tmp_path, f"""echo "$@" >> {calls}
case "$*" in
  *-test*) exit 0 ;;
esac
printf 'drwxr-xr-x - u g 0 2026-01-01 00:00 /d/sub\\n'
printf -- '-rw-r--r-- 1 u g 5 2026-01-01 00:00 /d/f.txt\\n'
""")
    fs = tfs.HDFSClient(home, retry_policy=_fast(max_attempts=5))
    monkey = chaos.ChaosMonkey(chaos.ChaosConfig(
        io_error_rate=1.0, ops=("fs",), max_faults=2))
    with monkey.active():
        assert fs.ls_dir("/d") == (["sub"], ["f.txt"])
        assert monkey.faults == 2
        assert fs.is_exist("/d") is True and fs.is_dir("/d") is True
    assert monkey.faults == 2
    assert len(calls.read_text().splitlines()) == 3


@pytest.mark.parametrize("stderr", [
    "Connection refused by namenode", "java.net.SocketTimeoutException",
    "ls: `/x': No such file or directory", "put: Permission denied",
    "mkdir: `/y': File exists", "", None])
def test_hdfs_stderr_classifier_is_jax(stderr):
    assert tfs._hdfs_transient(stderr) == jfs._hdfs_transient(stderr)


def test_fs_is_exported_as_in_jax():
    from paddle_tpu.distributed import fleet as jfleet
    import paddle_tpu.distributed as jdist
    import paddle_tpu_torch.distributed as tdist
    from paddle_tpu_torch.distributed import fleet
    assert tdist.LocalFS is tfs.LocalFS and tdist.HDFSClient is \
        tfs.HDFSClient and tdist.fs is tfs
    assert fleet.utils.fs is tfs
    assert fleet.utils.LocalFS is tfs.LocalFS
    assert fleet.utils.HDFSClient is tfs.HDFSClient
    assert fleet.LocalFS is tfs.LocalFS and fleet.HDFSClient is \
        tfs.HDFSClient
    assert jdist.LocalFS is jfs.LocalFS and jfleet.utils.fs is jfs
    for name in ("FS", "LocalFS", "HDFSClient", "ExecuteError",
                 "FSFileExistsError", "FSFileNotExistsError"):
        assert hasattr(tfs, name) and hasattr(jfs, name)
    assert [m for m in dir(jfs.LocalFS) if not m.startswith("_")] == \
        [m for m in dir(tfs.LocalFS) if not m.startswith("_")]
    assert [m for m in dir(jfs.HDFSClient) if not m.startswith("_")] == \
        [m for m in dir(tfs.HDFSClient) if not m.startswith("_")]
