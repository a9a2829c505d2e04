"""File readers behind one ``fetch_file`` interface (dir / zip / tar / lmdb).

The counterpart of ``prometheus_tpu/datasets/file_readers.py``: a
uniform byte-fetch API so datasets can read from plain directories or packed
archives without code changes. Archive handles are opened lazily, per
process (a file offset shared by two processes would interleave their
reads) and, for zip, per thread; a reader pickles without them, so each
loader worker opens its own.
"""
from __future__ import annotations

import os
import tarfile
import threading
import zipfile


class DirReader:
    """Reads ``root/name`` from the filesystem."""

    def __init__(self, root: str):
        self.root = root

    def fetch(self, name: str) -> bytes:
        with open(os.path.join(self.root, name), "rb") as fp:
            return fp.read()

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.root, name))

    def list(self, prefix: str = "") -> list[str]:
        base = os.path.join(self.root, prefix)
        out = []
        for dirpath, _, files in os.walk(base):
            rel = os.path.relpath(dirpath, self.root)
            for f in files:
                out.append(os.path.join(rel, f) if rel != "." else f)
        return sorted(out)


class ZipReader:
    """Reads members from a zip archive (a handle per process and thread)."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()

    def __getstate__(self):          # handles are reopened where used
        return {"path": self.path}

    def __setstate__(self, state):
        self.__init__(state["path"])

    def _zf(self) -> zipfile.ZipFile:
        if getattr(self._local, "pid", None) != os.getpid():
            self._local.zf = zipfile.ZipFile(self.path)
            self._local.pid = os.getpid()
        return self._local.zf

    def fetch(self, name: str) -> bytes:
        return self._zf().read(name)

    def exists(self, name: str) -> bool:
        try:
            self._zf().getinfo(name)
            return True
        except KeyError:
            return False

    def list(self, prefix: str = "") -> list[str]:
        return sorted(n for n in self._zf().namelist() if n.startswith(prefix)
                      and not n.endswith("/"))


class TarReader:
    """Reads members from an (uncompressed) tar archive; the index is built
    once, the handle opened per process."""

    def __init__(self, path: str):
        self.path = path
        self._open()
        self._index = {m.name: m for m in self._tf.getmembers() if m.isfile()}

    def __getstate__(self):          # the handle is reopened where used
        return {"path": self.path, "_index": self._index, "_pid": None}

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _open(self) -> None:
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._tf = tarfile.open(self.path)

    def fetch(self, name: str) -> bytes:
        if self._pid != os.getpid():
            self._open()
        with self._lock:  # tarfile handles are not thread-safe
            fp = self._tf.extractfile(self._index[name])
            return fp.read()

    def exists(self, name: str) -> bool:
        return name in self._index

    def list(self, prefix: str = "") -> list[str]:
        return sorted(n for n in self._index if n.startswith(prefix))


class LmdbReader:
    """Reads values from an LMDB environment (keys are utf-8 names)."""

    def __init__(self, path: str):
        import lmdb  # optional dependency; gated

        self.env = lmdb.open(path, readonly=True, lock=False,
                             readahead=False, meminit=False)

    def fetch(self, name: str) -> bytes:
        with self.env.begin(write=False) as txn:
            data = txn.get(name.encode("utf-8"))
        if data is None:
            raise KeyError(name)
        return bytes(data)

    def exists(self, name: str) -> bool:
        with self.env.begin(write=False) as txn:
            return txn.get(name.encode("utf-8")) is not None


def make_reader(root: str):
    """Pick a reader from the path: dir, .zip, .tar, .lmdb."""
    if root.endswith(".zip"):
        return ZipReader(root)
    if root.endswith(".tar"):
        return TarReader(root)
    if root.endswith(".lmdb") or os.path.isfile(os.path.join(root,
                                                              "data.mdb")):
        return LmdbReader(root)
    return DirReader(root)


def fetch_file(reader, name: str) -> bytes:
    return reader.fetch(name)
