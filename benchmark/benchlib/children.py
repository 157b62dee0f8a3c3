"""The child processes of this process, and their end on every path out of
a run: the run leaves nothing behind that a later run could meet."""
from __future__ import annotations

import os
import signal
import time


def children(pid: int | None = None) -> list[int]:
    """Process ids whose parent is `pid` (this process by default), zombies
    included, read from /proc."""
    pid = os.getpid() if pid is None else pid
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # after the command, which is in parentheses: the state, then the parent
        if int(stat.rpartition(")")[2].split()[1]) == pid:
            out.append(int(name))
    return out


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except OSError:
        return "?"


def _reaped(pid: int, wait_s: float) -> bool:
    """Waits up to wait_s for the child to end; True once it is reaped."""
    t_end = time.monotonic() + wait_s
    while True:
        try:
            done, _ = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            return True
        if done:
            return True
        if time.monotonic() >= t_end:
            return False
        time.sleep(0.05)


def end_all(log) -> list[str]:
    """Ends every child of this process and waits for each: the reference's
    resource tracker first, by its own pipe; then whatever else is left, by
    SIGTERM and, after 10 s, SIGKILL.  Returns the command lines of the
    children it found, each logged."""
    import sys

    if "multiprocessing.resource_tracker" in sys.modules:
        from benchref.clip import stop_resource_tracker

        stop_resource_tracker()
    found = []
    for pid in children():
        cmd = _cmdline(pid)
        found.append(cmd)
        log(f"run.py: a child process was left: {pid} {cmd!r}; ending it")
        for sig, wait_s in ((None, 0.0), (signal.SIGTERM, 10.0), (signal.SIGKILL, 60.0)):
            if sig is not None:
                try:
                    os.kill(pid, sig)
                except ProcessLookupError:
                    pass
            if _reaped(pid, wait_s):
                break
    return found
