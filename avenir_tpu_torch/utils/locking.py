"""Cross-process exclusion and atomic rewrites for files that several
processes may write — port of ``avenir_tpu/utils/locking.py``.

- :class:`FileLock` serializes writers with an advisory ``flock`` on a
  sidecar ``<path>.lock``; contention past ``timeout_s`` raises
  :class:`LockHeldError` instead of letting two writers interleave (the
  native encoder's first build, the LR coefficient history).
- :func:`atomic_write` writes a same-directory temp file and
  ``os.replace``s it, so a reader sees the old file or the new one, never a
  torn one, and a crash mid-write leaves the old one in place (the LR
  coefficient history's rewrite, regress/LogisticRegressionJob.java
  :238-255).
"""

from __future__ import annotations

import contextlib
import errno
import os
import stat
import tempfile
import time
from typing import IO, Iterator, Optional

try:
    import fcntl
except ImportError:                      # non-POSIX: degrade to lockless
    fcntl = None  # type: ignore[assignment]


class LockHeldError(RuntimeError):
    """Another process holds the lock — a concurrent writer was detected."""

    def __init__(self, path: str, timeout_s: float):
        super().__init__(
            f"lock {path!r} held by another process (waited {timeout_s}s); "
            "refusing to interleave writes")
        self.path = path


class FileLock:
    """Advisory exclusive lock on ``<target>.lock``.

    ``timeout_s=0`` means try once; positive values poll until acquired or
    :class:`LockHeldError`.  Not reentrant within one process: the point
    is cross-process exclusion.
    """

    def __init__(self, target: str, timeout_s: float = 0.0,
                 poll_s: float = 0.05):
        self.lock_path = target + ".lock"
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self._fh: Optional[IO] = None

    def acquire(self) -> "FileLock":
        if fcntl is None:
            return self
        deadline = time.monotonic() + self.timeout_s
        fh = open(self.lock_path, "a+")
        while True:
            try:
                fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                self._fh = fh
                return self
            except OSError as e:
                # only genuine contention polls or raises LockHeldError; a
                # filesystem that cannot flock (ENOLCK/EOPNOTSUPP on some
                # NFS/FUSE mounts) surfaces its real error
                if e.errno not in (errno.EWOULDBLOCK, errno.EAGAIN,
                                   errno.EACCES):
                    fh.close()
                    raise
                if time.monotonic() >= deadline:
                    fh.close()
                    raise LockHeldError(self.lock_path, self.timeout_s) from None
                time.sleep(self.poll_s)

    def release(self) -> None:
        if self._fh is not None:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "FileLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w") -> Iterator[IO]:
    """Write ``path`` through a same-directory temp file and
    ``os.replace``; the file keeps its mode (a new one gets the umask's)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        try:
            os.chmod(tmp, stat.S_IMODE(os.stat(path).st_mode))
        except FileNotFoundError:
            umask = os.umask(0)
            os.umask(umask)
            os.chmod(tmp, 0o666 & ~umask)
        with os.fdopen(fd, mode) as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
