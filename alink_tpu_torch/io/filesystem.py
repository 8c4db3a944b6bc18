"""Pluggable filesystem abstraction — every file-touching op works on any
``scheme://`` URI (port of ``alink_tpu.io.filesystem``).

Capability parity with the reference's filesystem layer (reference:
core/src/main/java/com/alibaba/alink/common/io/filesystem/BaseFileSystem.java
— local/HDFS/OSS/S3 behind one interface; AkUtils.java:52 reads ``.ak`` files
off any of them; the remote drivers arrive through the plugin downloader).

Scheme-dispatched: plain paths (no ``://``) and ``file://`` use the standard
library's local implementation; a scheme registered with
:func:`register_file_system` uses its factory; ``memory://`` is the port's
own in-process store (:class:`MemoryFileSystem`, the test double for a
remote store). The reference routes every other scheme through fsspec and
its driver packages; the port has neither, so an unregistered scheme raises
:class:`~alink_tpu_torch.common.exceptions.AkPluginNotExistException`
naming the missing driver, as the reference does when the driver is absent.
"""

from __future__ import annotations

import contextlib
import io
import os
import posixpath
import shutil
import threading
from typing import IO, Callable, Dict, List

from ..common.exceptions import (AkIllegalArgumentException,
                                 AkPluginNotExistException)


def _has_scheme(path: str) -> bool:
    if "://" not in path:
        return False
    scheme = path.split("://", 1)[0]
    return bool(scheme) and all(c.isalnum() or c in "+-." for c in scheme)


class BaseFileSystem:
    """The surface the framework needs: open / exists / list / mkdir /
    delete / rename. Subclass + :func:`register_file_system` to add a
    scheme."""

    scheme: str = ""

    def open(self, path: str, mode: str = "r") -> IO:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        """Basenames of entries in ``path`` (not full URIs)."""
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Atomic where the store supports it (local POSIX)."""
        raise NotImplementedError

    def join(self, *parts: str) -> str:
        return posixpath.join(*parts)


class LocalFileSystem(BaseFileSystem):
    """(reference: common/io/filesystem/LocalFileSystem.java)"""

    scheme = "file"

    @staticmethod
    def _strip(path: str) -> str:
        return path[len("file://"):] if path.startswith("file://") else path

    def open(self, path: str, mode: str = "r") -> IO:
        return open(self._strip(path), mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def isdir(self, path: str) -> bool:
        return os.path.isdir(self._strip(path))

    def listdir(self, path: str) -> List[str]:
        return os.listdir(self._strip(path))

    def makedirs(self, path: str) -> None:
        os.makedirs(self._strip(path), exist_ok=True)

    def delete(self, path: str, recursive: bool = False) -> None:
        p = self._strip(path)
        if os.path.isdir(p):
            if recursive:
                shutil.rmtree(p)
            else:
                os.rmdir(p)
        elif os.path.exists(p):
            os.remove(p)

    def rename(self, src: str, dst: str) -> None:
        os.replace(self._strip(src), self._strip(dst))

    def join(self, *parts: str) -> str:
        return os.path.join(*parts)


class _MemoryWriter(io.BytesIO):
    """A file being written into the memory store: its bytes land under
    the path when it closes (a reader never sees a half-written file)."""

    def __init__(self, store: "MemoryFileSystem", key: str):
        super().__init__()
        self._store, self._key = store, key

    def close(self):
        if not self.closed:
            self._store._put(self._key, self.getvalue())
        super().close()


class MemoryFileSystem(BaseFileSystem):
    """In-process store for ``memory://`` paths (the role fsspec's memory
    filesystem plays in the reference): files are byte strings keyed by
    their normalized path, directories are implied by the files under them
    or made explicitly; files open for reading or writing (``r``, ``rb``,
    ``w``, ``wb``). One store per process; thread-safe."""

    scheme = "memory"

    def __init__(self):
        self._files: Dict[str, bytes] = {}
        self._dirs: set = {"/"}
        self._lock = threading.Lock()

    @staticmethod
    def _key(path: str) -> str:
        rest = path.split("://", 1)[1] if "://" in path else path
        return posixpath.normpath("/" + rest.lstrip("/"))

    def _put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._files[key] = data
            d = posixpath.dirname(key)
            while d not in self._dirs:
                self._dirs.add(d)
                d = posixpath.dirname(d)

    def _is_dir(self, key: str) -> bool:
        prefix = key.rstrip("/") + "/"
        return key in self._dirs or any(k.startswith(prefix)
                                        for k in self._files)

    def open(self, path: str, mode: str = "r") -> IO:
        key = self._key(path)
        if mode in ("r", "rb"):
            with self._lock:
                if key not in self._files:
                    raise FileNotFoundError(path)
                f = io.BytesIO(self._files[key])
        elif mode in ("w", "wb"):
            f = _MemoryWriter(self, key)
        else:
            raise AkIllegalArgumentException(
                f"memory:// does not support mode {mode!r}")
        return f if "b" in mode else io.TextIOWrapper(f, encoding="utf-8")

    def exists(self, path: str) -> bool:
        key = self._key(path)
        with self._lock:
            return key in self._files or self._is_dir(key)

    def isdir(self, path: str) -> bool:
        key = self._key(path)
        with self._lock:
            return key not in self._files and self._is_dir(key)

    def listdir(self, path: str) -> List[str]:
        key = self._key(path)
        prefix = key.rstrip("/") + "/"
        with self._lock:
            names = {k[len(prefix):].split("/", 1)[0]
                     for k in list(self._files) + list(self._dirs)
                     if k.startswith(prefix) and k != prefix}
        return sorted(names)

    def makedirs(self, path: str) -> None:
        key = self._key(path)
        with self._lock:
            while key not in self._dirs:
                self._dirs.add(key)
                key = posixpath.dirname(key)

    def delete(self, path: str, recursive: bool = False) -> None:
        key = self._key(path)
        prefix = key.rstrip("/") + "/"
        with self._lock:
            if key in self._files:
                del self._files[key]
                return
            under = [k for k in self._files if k.startswith(prefix)]
            if under and not recursive:
                raise OSError(f"directory not empty: {path}")
            for k in under:
                del self._files[k]
            self._dirs = {d for d in self._dirs
                          if d != key and not d.startswith(prefix)} | {"/"}

    def rename(self, src: str, dst: str) -> None:
        s, d = self._key(src), self._key(dst)
        with self._lock:
            if s not in self._files:
                raise FileNotFoundError(src)
            data = self._files.pop(s)
        self._put(d, data)


_registry: Dict[str, Callable[[], BaseFileSystem]] = {
    "file": LocalFileSystem,
    "memory": MemoryFileSystem,
}
_instances: Dict[str, BaseFileSystem] = {}
_registry_lock = threading.Lock()


def register_file_system(scheme: str,
                         factory: Callable[[], BaseFileSystem]) -> None:
    """Register a custom scheme (tests and embedded stores)."""
    with _registry_lock:
        _registry[scheme] = factory
        _instances.pop(scheme, None)


def get_file_system(path: str) -> BaseFileSystem:
    """Scheme-dispatch: plain paths and ``file://`` → local; a registered
    scheme → its factory (one instance per scheme); anything else raises
    :class:`AkPluginNotExistException`."""
    scheme = path.split("://", 1)[0] if _has_scheme(path) else "file"
    with _registry_lock:
        fs = _instances.get(scheme)
        if fs is None:
            factory = _registry.get(scheme)
            if factory is None:
                raise AkPluginNotExistException(
                    f"filesystem scheme '{scheme}://' has no driver: the "
                    "port ships file:// and memory:// only; register a "
                    "driver for it with io.filesystem.register_file_system")
            fs = _instances[scheme] = factory()
    return fs


@contextlib.contextmanager
def file_open(path: str, mode: str = "r"):
    """Open ``path`` on whatever filesystem its scheme names."""
    if not isinstance(path, (str, os.PathLike)):
        raise AkIllegalArgumentException(f"not a path: {path!r}")
    f = get_file_system(str(path)).open(str(path), mode)
    try:
        yield f
    finally:
        f.close()


def path_join(base: str, *parts: str) -> str:
    return get_file_system(base).join(base, *parts)
