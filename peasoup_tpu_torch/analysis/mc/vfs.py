"""Virtual filesystem + determinism seams for the model checker.

The modules under test are run unmodified: :func:`interpose` swaps
their module-level ``os``/``time``/``uuid``/``tempfile``/``socket``
references (and injects a module-global ``open``) for proxies bound
to one :class:`MCEnv`. Every filesystem operation funnels through
:meth:`MCEnv.op`, which — when a cooperative scheduler is active —
parks the calling task at a scheduling point before executing, so the
explorer controls exactly which process-step happens next.

Semantics modelled (the load-bearing subset of POSIX):

* ``os.open(path, O_CREAT|O_EXCL|O_WRONLY)`` creates the entry
  *immediately* (the O_EXCL race is visible to peers) but with empty
  content; writes buffer in the file object and **publish on close**.
  A crash between create and close therefore leaves a torn (empty)
  file — exactly the state the reap protocols must survive.
* File descriptors bind the *inode* (:class:`VFile`), not the path: a
  rename mid-write means close publishes into the renamed file, and
  an unlink mid-write orphans the data — both real POSIX behaviours
  the tombstone dances rely on.
* ``os.rename``/``os.replace`` overwrite the destination (POSIX
  rename) and bump the inode's **st_ctime but not st_mtime** — sweeps
  that age tombstones must use ``st_ctime``.
* ``os.link`` aliases the inode (``FileExistsError`` when the name
  exists) — the exactly-once publish primitive.
* Durability: content is volatile until ``os.fsync``;
  :meth:`VirtualFS.host_crash` drops never-synced files and reverts
  synced ones to their last-synced content. Name-space metadata
  (renames) is treated as journaled.

The virtual clock never ticks on its own — it advances only through
an explicit ``advance`` scheduling op — so identical schedules
produce bit-identical traces and state hashes dedup across runs.
"""

from __future__ import annotations

import hashlib
import os as _real_os
import posixpath
import types
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Iterator

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .scheduler import Scheduler

# op kinds that mutate the namespace/content they touch
_MUTATORS = frozenset(
    {"create", "publish", "unlink", "rename", "link", "fsync", "append"}
)
# op kinds that conflict with everything (time reads are ambient; marks
# delimit invariant-visible critical sections)
_GLOBAL = frozenset({"advance", "mark"})
# inode-bound ops: their descriptor names the *open-time* path, which a
# concurrent rename can make stale — conservatively conflict with any
# namespace edit
_INODE_BOUND = frozenset({"publish", "fsync"})
_NAMESPACE = frozenset({"rename", "link", "unlink", "create"})


@dataclass(frozen=True)
class OpDesc:
    """One filesystem operation, as the scheduler/explorer see it."""

    kind: str
    path: str
    reads: frozenset[str] = frozenset()
    writes: frozenset[str] = frozenset()
    lists: str | None = None

    @property
    def key(self) -> str:
        return f"{self.kind}:{self.path}"


def conflicts(a: OpDesc, b: OpDesc) -> bool:
    """May the order of ``a`` and ``b`` matter? (Used by the partial-
    order reduction; conservative = sound, just less reduction.)"""
    if a.kind in _GLOBAL or b.kind in _GLOBAL:
        return True
    if (a.kind in _INODE_BOUND and b.kind in _NAMESPACE | _INODE_BOUND) or (
        b.kind in _INODE_BOUND and a.kind in _NAMESPACE | _INODE_BOUND
    ):
        return True
    if a.writes & (b.reads | b.writes) or b.writes & (a.reads | a.writes):
        return True
    for lister, other in ((a, b), (b, a)):
        if lister.lists is not None and any(
            posixpath.dirname(p) == lister.lists
            or p.startswith(lister.lists + "/")
            for p in other.writes
        ):
            return True
    return False


class VFile:
    """One inode: live content + last-fsynced content + POSIX times."""

    __slots__ = ("content", "durable", "ctime", "mtime")

    def __init__(self, now: float) -> None:
        self.content = ""
        self.durable: str | None = None
        self.ctime = now
        self.mtime = now


class VirtualFS:
    """Path -> :class:`VFile`. Directories are implicit (``makedirs``
    is a no-op; ``listdir`` of an absent dir is empty)."""

    def __init__(self) -> None:
        self.files: dict[str, VFile] = {}

    # -- queries ------------------------------------------------------
    def exists(self, path: str) -> bool:
        if path in self.files:
            return True
        prefix = path.rstrip("/") + "/"
        return any(p.startswith(prefix) for p in self.files)

    def read(self, path: str) -> str:
        vf = self.files.get(path)
        if vf is None:
            raise FileNotFoundError(2, "No such file or directory", path)
        return vf.content

    def listdir(self, path: str) -> list[str]:
        d = path.rstrip("/")
        out = set()
        for p in self.files:
            if posixpath.dirname(p) == d:
                out.add(posixpath.basename(p))
            elif p.startswith(d + "/"):
                out.add(p[len(d) + 1 :].split("/", 1)[0])
        return sorted(out)

    def stat(self, path: str) -> Any:
        vf = self.files.get(path)
        if vf is None:
            if self.exists(path):  # implicit directory
                return types.SimpleNamespace(
                    st_ctime=0.0, st_mtime=0.0, st_size=0
                )
            raise FileNotFoundError(2, "No such file or directory", path)
        return types.SimpleNamespace(
            st_ctime=vf.ctime, st_mtime=vf.mtime, st_size=len(vf.content)
        )

    # -- mutations ----------------------------------------------------
    def create(self, path: str, now: float, excl: bool) -> VFile:
        vf = self.files.get(path)
        if vf is not None:
            if excl:
                raise FileExistsError(17, "File exists", path)
            vf.content = ""
            vf.durable = None
            vf.ctime = vf.mtime = now
            return vf
        vf = VFile(now)
        self.files[path] = vf
        return vf

    def publish(self, vf: VFile, data: str, now: float) -> None:
        vf.content = data
        vf.mtime = now
        vf.ctime = now

    def unlink(self, path: str) -> None:
        if path not in self.files:
            raise FileNotFoundError(2, "No such file or directory", path)
        del self.files[path]

    def rename(self, src: str, dst: str, now: float) -> None:
        vf = self.files.pop(src, None)
        if vf is None:
            raise FileNotFoundError(2, "No such file or directory", src)
        vf.ctime = now  # POSIX: rename bumps ctime, NOT mtime
        self.files[dst] = vf

    def link(self, src: str, dst: str, now: float) -> None:
        vf = self.files.get(src)
        if vf is None:
            raise FileNotFoundError(2, "No such file or directory", src)
        if dst in self.files:
            raise FileExistsError(17, "File exists", dst)
        vf.ctime = now
        self.files[dst] = vf

    def fsync(self, vf: VFile) -> None:
        vf.durable = vf.content

    def host_crash(self) -> None:
        """Power loss: never-synced files vanish, synced ones revert
        to their last-synced content. Renames (metadata) survive."""
        for path in list(self.files):
            vf = self.files[path]
            if vf.durable is None:
                del self.files[path]
            else:
                vf.content = vf.durable


@dataclass
class _PendingWrite:
    """An open-for-write fd: buffered until close publishes."""

    fd: int
    vf: VFile
    path: str
    base: str = ""  # existing content for "a" mode
    buf: list[str] = field(default_factory=list)
    closed: bool = False


class MCEnv:
    """One model-checking universe: the VFS, the virtual clock, the
    deterministic id counters, the op trace, and the proxy objects
    :func:`interpose` injects into the modules under test."""

    def __init__(self) -> None:
        self.fs = VirtualFS()
        self.clock = 1_000_000.0
        self.skew: dict[str, float] = {}  # task name -> seconds
        self.uuid_n = 0
        self.tmp_n = 0
        self.scheduler: Scheduler | None = None
        self.trace: list[str] = []
        # every executed op's (task, descriptor), in execution order —
        # the partial-order reduction's view of each task's footprint
        self.ops: list[tuple[str, OpDesc]] = []
        self._pending: dict[int, _PendingWrite] = {}
        self._next_fd = 100
        self.os = VirtualOS(self)
        self.time = VirtualTime(self)
        self.uuid = VirtualUuid(self)
        self.tempfile = VirtualTempfile(self)
        self.socket = VirtualSocket(self)
        self.open = VirtualOpen(self)

    # -- scheduling seam ---------------------------------------------
    def op(self, desc: OpDesc, fn: Callable[[], Any]) -> Any:
        """Every FS operation funnels through here. With a scheduler
        active and the caller on a task thread, park at a scheduling
        point first; otherwise (setup / invariant phases) execute
        directly."""
        sch = self.scheduler
        task = sch.current_task() if sch is not None else None
        if task is None or sch is None:
            out = fn()
            self.trace.append(f"-:{desc.key}")
            self.ops.append(("-", desc))
            return out
        return sch.perform(task, desc, fn)

    def task_name(self) -> str:
        sch = self.scheduler
        task = sch.current_task() if sch is not None else None
        return task.name if task is not None else "-"

    def task_pid(self) -> int:
        sch = self.scheduler
        task = sch.current_task() if sch is not None else None
        return task.pid if task is not None else 1

    def now(self) -> float:
        """Skew-adjusted clock for the *calling task* (``time.time``
        through the proxy). File times always use the unskewed
        :attr:`clock` — the filesystem server's clock."""
        return self.clock + self.skew.get(self.task_name(), 0.0)

    def state_hash(self) -> str:
        """Content-addressed state: VFS + clock + id counters + each
        task's (status, op-history hash). Tasks are deterministic
        functions of their FS interaction history, so two runs that
        agree on this hash are in bisimilar states — the explorer
        dedups branches on it."""
        h = hashlib.sha1()
        h.update(
            f"c={self.clock!r};u={self.uuid_n};t={self.tmp_n};".encode()
        )
        for path, vf in sorted(self.fs.files.items()):
            h.update(
                f"{path}|{vf.content}|{vf.durable is not None}"
                f"|{vf.ctime!r}|{vf.mtime!r};".encode()
            )
        if self.scheduler is not None:
            for t in self.scheduler.tasks:
                h.update(f"{t.name}={t.status}:{t.hseq};".encode())
        return h.hexdigest()[:16]

    # -- fd plumbing --------------------------------------------------
    def new_fd(self, vf: VFile, path: str, base: str = "") -> int:
        fd = self._next_fd
        self._next_fd += 1
        self._pending[fd] = _PendingWrite(fd, vf, path, base=base)
        return fd


class VirtualWriteFile:
    """Write handle: buffers everything; close = the publish op."""

    def __init__(self, env: MCEnv, pending: _PendingWrite) -> None:
        self._env = env
        self._p = pending

    def write(self, s: str) -> int:
        self._p.buf.append(s)
        return len(s)

    def flush(self) -> None:
        pass

    def fileno(self) -> int:
        return self._p.fd

    @property
    def closed(self) -> bool:
        return self._p.closed

    def close(self) -> None:
        p = self._p
        if p.closed:
            return
        p.closed = True
        env = self._env
        env._pending.pop(p.fd, None)

        def fn() -> None:
            env.fs.publish(p.vf, p.base + "".join(p.buf), env.clock)

        env.op(
            OpDesc("publish", p.path, writes=frozenset({p.path})), fn
        )

    def __enter__(self) -> "VirtualWriteFile":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class VirtualReadFile:
    """Read handle over a content snapshot taken at the open op."""

    def __init__(self, content: str) -> None:
        self._content = content
        self._pos = 0

    def read(self, n: int = -1) -> str:
        if n < 0:
            out = self._content[self._pos :]
            self._pos = len(self._content)
            return out
        out = self._content[self._pos : self._pos + n]
        self._pos += len(out)
        return out

    def readlines(self) -> list[str]:
        return self.read().splitlines(keepends=True)

    def __iter__(self) -> Iterator[str]:
        return iter(self.readlines())

    def close(self) -> None:
        pass

    def __enter__(self) -> "VirtualReadFile":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class VirtualOpen:
    """The module-global ``open`` injected by :func:`interpose`."""

    def __init__(self, env: MCEnv) -> None:
        self._env = env

    def __call__(self, path: str, mode: str = "r", **kw: Any) -> Any:
        env = self._env
        if mode in ("r", "rt"):

            def rd() -> str:
                return env.fs.read(path)

            content = env.op(
                OpDesc("read", path, reads=frozenset({path})), rd
            )
            return VirtualReadFile(content)
        if mode in ("w", "wt"):

            def mk() -> int:
                vf = env.fs.create(path, env.clock, excl=False)
                return env.new_fd(vf, path)

            fd = env.op(
                OpDesc("create", path, writes=frozenset({path})), mk
            )
            return VirtualWriteFile(env, env._pending[fd])
        if mode in ("a", "at"):

            def ap() -> int:
                vf = env.fs.files.get(path)
                base = vf.content if vf is not None else ""
                if vf is None:
                    vf = env.fs.create(path, env.clock, excl=False)
                return env.new_fd(vf, path, base=base)

            fd = env.op(
                OpDesc(
                    "append",
                    path,
                    reads=frozenset({path}),
                    writes=frozenset({path}),
                ),
                ap,
            )
            return VirtualWriteFile(env, env._pending[fd])
        raise NotImplementedError(f"mc vfs: open mode {mode!r}")


class VirtualPath:
    """``os.path`` proxy: pure lexical helpers delegate to posixpath;
    ``exists`` is a real (scheduled) FS op."""

    sep = "/"

    def __init__(self, env: MCEnv) -> None:
        self._env = env

    def join(self, *parts: str) -> str:
        return posixpath.join(*parts)

    def dirname(self, p: str) -> str:
        return posixpath.dirname(p)

    def basename(self, p: str) -> str:
        return posixpath.basename(p)

    def normpath(self, p: str) -> str:
        return posixpath.normpath(p)

    def splitext(self, p: str) -> tuple[str, str]:
        return posixpath.splitext(p)

    def abspath(self, p: str) -> str:
        return posixpath.normpath(p if p.startswith("/") else "/" + p)

    def isabs(self, p: str) -> bool:
        return p.startswith("/")

    def exists(self, p: str) -> bool:
        env = self._env
        return bool(
            env.op(
                OpDesc("exists", p, reads=frozenset({p})),
                lambda: env.fs.exists(p),
            )
        )

    def isdir(self, p: str) -> bool:
        env = self._env
        return bool(
            env.op(
                OpDesc("exists", p, reads=frozenset({p})),
                lambda: env.fs.exists(p) and p not in env.fs.files,
            )
        )

    def isfile(self, p: str) -> bool:
        env = self._env
        return bool(
            env.op(
                OpDesc("exists", p, reads=frozenset({p})),
                lambda: p in env.fs.files,
            )
        )


class VirtualOS:
    """``os`` proxy covering the protocol modules' op surface."""

    O_CREAT = _real_os.O_CREAT
    O_EXCL = _real_os.O_EXCL
    O_WRONLY = _real_os.O_WRONLY
    O_RDONLY = _real_os.O_RDONLY
    O_RDWR = _real_os.O_RDWR
    O_APPEND = _real_os.O_APPEND
    O_TRUNC = _real_os.O_TRUNC
    sep = "/"
    environ = _real_os.environ  # read-only config peeks

    def __init__(self, env: MCEnv) -> None:
        self._env = env
        self.path = VirtualPath(env)

    # -- fd ops -------------------------------------------------------
    def open(self, path: str, flags: int, mode: int = 0o600) -> int:
        env = self._env
        if not (flags & self.O_CREAT) or not (flags & self.O_EXCL):
            raise NotImplementedError(
                f"mc vfs: os.open flags {flags:#x} (only O_CREAT|O_EXCL)"
            )

        def fn() -> int:
            vf = env.fs.create(path, env.clock, excl=True)
            return env.new_fd(vf, path)

        return int(
            env.op(OpDesc("create", path, writes=frozenset({path})), fn)
        )

    def fdopen(self, fd: int, mode: str = "w", **kw: Any) -> Any:
        if not mode.startswith("w"):
            raise NotImplementedError(f"mc vfs: fdopen mode {mode!r}")
        return VirtualWriteFile(self._env, self._env._pending[fd])

    def close(self, fd: int) -> None:
        # abandoning an fd publishes nothing (the torn-file model);
        # not a scheduling point — the visible op is what follows
        self._env._pending.pop(fd, None)

    def fsync(self, fd: int) -> None:
        env = self._env
        p = env._pending[fd]

        def fn() -> None:
            env.fs.publish(p.vf, p.base + "".join(p.buf), env.clock)
            env.fs.fsync(p.vf)

        env.op(OpDesc("fsync", p.path, writes=frozenset({p.path})), fn)

    # -- namespace ops ------------------------------------------------
    def unlink(self, path: str) -> None:
        env = self._env
        env.op(
            OpDesc("unlink", path, writes=frozenset({path})),
            lambda: env.fs.unlink(path),
        )

    remove = unlink

    def rename(self, src: str, dst: str) -> None:
        # desc path = destination: the published/tombstone name is what
        # invariants count; the source is still in ``writes`` for POR
        env = self._env
        env.op(
            OpDesc("rename", dst, writes=frozenset({src, dst})),
            lambda: env.fs.rename(src, dst, env.clock),
        )

    replace = rename  # POSIX rename overwrites

    def link(self, src: str, dst: str) -> None:
        env = self._env
        env.op(
            OpDesc(
                "link",
                dst,
                reads=frozenset({src}),
                writes=frozenset({src, dst}),
            ),
            lambda: env.fs.link(src, dst, env.clock),
        )

    def listdir(self, path: str) -> list[str]:
        env = self._env
        out = env.op(
            OpDesc("listdir", path, lists=path),
            lambda: env.fs.listdir(path),
        )
        return list(out)

    def stat(self, path: str) -> Any:
        env = self._env
        return env.op(
            OpDesc("stat", path, reads=frozenset({path})),
            lambda: env.fs.stat(path),
        )

    def makedirs(self, path: str, exist_ok: bool = False) -> None:
        # directories are implicit; deliberately not a scheduling point
        del path, exist_ok

    # -- process identity ---------------------------------------------
    def getpid(self) -> int:
        return self._env.task_pid()


class VirtualTime:
    """``time`` proxy: the virtual clock plus the caller's skew. Not a
    scheduling point — the clock only changes at explicit ``advance``
    ops, so reads between ops are deterministic."""

    def __init__(self, env: MCEnv) -> None:
        self._env = env

    def time(self) -> float:
        return self._env.now()

    def monotonic(self) -> float:
        return self._env.now()

    def sleep(self, s: float) -> None:
        del s  # virtual time does not pass while "sleeping"


class _FakeUuid:
    __slots__ = ("hex",)

    def __init__(self, hex_: str) -> None:
        self.hex = hex_

    def __str__(self) -> str:
        return self.hex


class VirtualUuid:
    """``uuid`` proxy: a deterministic counter. The counter repeats in
    every 8-hex-char block so the protocols' ``hex[:8]``/``hex[:12]``
    truncations stay unique — real uuid prefixes never collide, and a
    modelled collision would fault the tombstone dances for a reason
    the real system can't exhibit."""

    def __init__(self, env: MCEnv) -> None:
        self._env = env

    def uuid4(self) -> _FakeUuid:
        n = self._env.uuid_n
        self._env.uuid_n += 1
        return _FakeUuid(f"{n:08x}" * 4)


class VirtualTempfile:
    """``tempfile`` proxy: counter-named files in the target dir."""

    def __init__(self, env: MCEnv) -> None:
        self._env = env

    def mkstemp(
        self,
        suffix: str = "",
        prefix: str = "tmp",
        dir: str | None = None,
        text: bool = False,
    ) -> tuple[int, str]:
        del text
        env = self._env
        name = posixpath.join(
            dir or "/tmp", f"{prefix}{env.tmp_n:04d}{suffix}"
        )
        env.tmp_n += 1

        def fn() -> int:
            vf = env.fs.create(name, env.clock, excl=True)
            return env.new_fd(vf, name)

        fd = env.op(OpDesc("create", name, writes=frozenset({name})), fn)
        return int(fd), name


class VirtualSocket:
    def __init__(self, env: MCEnv) -> None:
        del env

    def gethostname(self) -> str:
        return "mc"


_SEAMS = ("os", "time", "uuid", "tempfile", "socket")
_MISSING = object()


@contextmanager
def interpose(env: MCEnv, modules: tuple[Any, ...]) -> Iterator[MCEnv]:
    """Swap each module's stdlib seams for ``env``'s proxies (and
    shadow the ``open`` builtin with a module global — module-global
    lookup beats builtins). Restores everything on exit, even when the
    run raises."""
    saved: list[tuple[Any, str, Any]] = []
    try:
        for mod in modules:
            for name in _SEAMS:
                cur = getattr(mod, name, _MISSING)
                if not isinstance(cur, types.ModuleType):
                    continue
                saved.append((mod, name, cur))
                setattr(mod, name, getattr(env, name))
            cur_open = mod.__dict__.get("open", _MISSING)
            saved.append((mod, "open", cur_open))
            mod.open = env.open
        yield env
    finally:
        for mod, name, cur in reversed(saved):
            if cur is _MISSING:
                try:
                    delattr(mod, name)
                except AttributeError:
                    pass
            else:
                setattr(mod, name, cur)
