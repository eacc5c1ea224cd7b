"""Filesystem abstraction — a copy of
``paddle_tpu/distributed/fleet/fs.py`` (reference: fleet/utils/fs.py —
LocalFS + HDFSClient used by checkpoint/save paths).  LocalFS is fully
implemented; HDFSClient keeps the API and shells out to ``hadoop fs``
when available."""
from __future__ import annotations

import os
import shutil
import subprocess


class ExecuteError(Exception):
    pass


class FS:
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

    def mv(self, src, dst, overwrite=False):
        raise NotImplementedError


class LocalFS(FS):
    """reference: fleet/utils/fs.py LocalFS."""

    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name))
             else files).append(name)
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
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def mv(self, src, dst, overwrite=False, test_exists=True):
        if test_exists and not self.is_exist(src):
            raise ExecuteError(f"mv: source {src!r} does not exist")
        if self.is_exist(dst):
            if not overwrite:
                raise ExecuteError(f"mv: destination {dst!r} exists")
            self.delete(dst)
        shutil.move(src, dst)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path) and not exist_ok:
            raise ExecuteError(f"touch: {path!r} exists")
        open(path, "a").close()

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)


class HDFSClient(FS):
    """reference: fleet/utils/fs.py HDFSClient — shells out to
    ``hadoop fs`` with the configured name-node; every call raises
    ExecuteError when the binary is absent."""

    def __init__(self, hadoop_home=None, configs=None, time_out=5 * 60,
                 sleep_inter=1000):
        self._hadoop = os.path.join(hadoop_home or
                                    os.environ.get("HADOOP_HOME", ""),
                                    "bin", "hadoop")
        self._configs = configs or {}
        self._timeout = time_out
        self._sleep_inter = sleep_inter

    def _run(self, *args):
        cmd = [self._hadoop, "fs"]
        for k, v in self._configs.items():
            cmd += ["-D", f"{k}={v}"]
        cmd += list(args)
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=self._timeout)
        except (FileNotFoundError, subprocess.TimeoutExpired) as e:
            raise ExecuteError(
                f"hadoop binary unavailable or timed out: {e}") from e
        if res.returncode != 0:
            raise ExecuteError(res.stderr)
        return res.stdout

    def ls_dir(self, path):
        out = self._run("-ls", path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, path):
        try:
            self._run("-test", "-e", path)
            return True
        except ExecuteError:
            return False

    def is_file(self, path):
        try:
            self._run("-test", "-f", path)
            return True
        except ExecuteError:
            return False

    def is_dir(self, path):
        try:
            self._run("-test", "-d", path)
            return True
        except ExecuteError:
            return False

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", path)

    def mv(self, src, dst, overwrite=False):
        self._run("-mv", src, dst)

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)
