"""Deterministic fault injection for crash-safety tests: the port's copy
of ``repro.testing.faults``, op for op, with the same ``REPRO_FAULTS``
variable, exit code and actions, so a fault spec arms either package.

Production modules expose *injection points* — named :func:`trip` calls at
the crash-critical lines of their commit protocols (e.g.
``"checkpoint.save.pre_replace"`` just before the atomic rename,
``"store.commit.pre_manifest"`` between the two replaces of the corpus
commit).  A disarmed point is a dict lookup and a return; production
behaviour is unchanged unless a test arms a fault.

Faults are deterministic by construction: a fault fires on the *nth* hit
of its point (hit counting is sequential program order, not wall clock),
so a given test arms the same crash at the same line every run.  Actions:

``raise``      raise :class:`InjectedCrash` (unwinds like any exception —
               models a failing commit thread)
``exit``       ``os._exit(EXIT_CODE)`` — die without unwinding, no atexit,
               no flushes (models a hard crash mid-protocol)
``kill``       ``SIGKILL`` ourselves — indistinguishable from ``kill -9``
``sleep:<s>``  sleep then continue (models a slow commit thread)
``call``       run an arbitrary callable at the point (compose torn-file
               truncation + kill, etc.)

Arming is either programmatic (:func:`inject` context manager /
:func:`arm`) or through the environment for subprocess tests: a child
interpreter started with ``REPRO_FAULTS="store.commit.pre_manifest=kill"``
crashes at that point with no test code in the child at all.  Helpers for
the subprocess pattern (:func:`run_child`, :func:`child_env`,
:func:`wait_for_marker`, :func:`sigkill`) and for torn-file corruption
(:func:`truncate_file`, :func:`flip_byte`) live here too.

The port's injection points: ``store.flush.*`` and ``store.commit.*``
(``data/store.py``), ``checkpoint.save.*`` (``checkpoint/store.py``) and
``svi.step`` (``core/svi.py``), as in the JAX package
(``docs/fault_tolerance.md``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Iterator, Optional

ENV_VAR = "REPRO_FAULTS"
#: Exit status used by the ``exit`` action so parents can tell an injected
#: crash apart from an ordinary failure.
EXIT_CODE = 57

_ACTIONS = ("raise", "exit", "kill", "call")


class InjectedCrash(RuntimeError):
    """Raised by the ``raise`` action at an armed injection point."""


@dataclasses.dataclass
class Fault:
    """One armed fault: fire ``action`` on the ``nth`` hit of ``point``."""

    point: str
    action: str = "raise"
    nth: int = 1
    fn: Optional[Callable[[], None]] = None
    sleep_s: float = 0.0
    hits: int = 0
    fired: bool = False

    def __post_init__(self) -> None:
        if self.action.startswith("sleep:"):
            self.sleep_s = float(self.action.split(":", 1)[1])
            self.action = "sleep"
        if self.action not in _ACTIONS + ("sleep",):
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.action == "call" and self.fn is None:
            raise ValueError("action='call' needs fn=")
        if self.nth < 1:
            raise ValueError("nth is 1-based")


_LOCK = threading.Lock()
_FAULTS: list[Fault] = []
_ENV_LOADED = False


def _parse_env(spec: str) -> list[Fault]:
    """``"point=action@nth,point2=action"`` -> faults (``@nth`` optional)."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        point, _, action = item.partition("=")
        action = action or "raise"
        nth = 1
        if "@" in action:
            action, _, n = action.partition("@")
            nth = int(n)
        out.append(Fault(point=point, action=action, nth=nth))
    return out


def _load_env_once() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    spec = os.environ.get(ENV_VAR, "")
    if spec:
        _FAULTS.extend(_parse_env(spec))


def arm(point: str, action: str = "raise", nth: int = 1,
        fn: Optional[Callable[[], None]] = None) -> Fault:
    """Arm a fault; returns the record (pass to :func:`disarm`)."""
    f = Fault(point=point, action=action, nth=nth, fn=fn)
    with _LOCK:
        _load_env_once()
        _FAULTS.append(f)
    return f


def disarm(fault: Fault) -> None:
    with _LOCK:
        if fault in _FAULTS:
            _FAULTS.remove(fault)


def reset() -> None:
    """Disarm everything (including env-armed faults)."""
    with _LOCK:
        _load_env_once()
        del _FAULTS[:]


@contextlib.contextmanager
def inject(point: str, action: str = "raise", nth: int = 1,
           fn: Optional[Callable[[], None]] = None) -> Iterator[Fault]:
    """Context manager: arm for the block, disarm on exit."""
    f = arm(point, action=action, nth=nth, fn=fn)
    try:
        yield f
    finally:
        disarm(f)


def trip(point: str) -> None:
    """Injection point hook — no-op unless a matching fault is armed.

    Called from production code at crash-critical lines; the disarmed
    fast path is a lock-free truthiness check.
    """
    if not _FAULTS and _ENV_LOADED:
        return
    to_fire = None
    with _LOCK:
        _load_env_once()
        for f in _FAULTS:
            if f.fired or f.point != point:
                continue
            f.hits += 1
            if f.hits == f.nth:
                f.fired = True
                to_fire = f
                break
    if to_fire is None:
        return
    if to_fire.action == "raise":
        raise InjectedCrash(f"injected crash at {point!r} (hit {to_fire.nth})")
    if to_fire.action == "exit":
        os._exit(EXIT_CODE)
    if to_fire.action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if to_fire.action == "sleep":
        time.sleep(to_fire.sleep_s)
        return
    if to_fire.action == "call":
        to_fire.fn()  # type: ignore[misc]


# ---------------------------------------------------------------------------
# torn-file corruption helpers


def truncate_file(path: str, keep) -> None:
    """Truncate ``path`` to ``keep`` bytes (int) or fraction (float < 1)."""
    size = os.path.getsize(path)
    n = int(size * keep) if isinstance(keep, float) and keep < 1 else int(keep)
    with open(path, "r+b") as fh:
        fh.truncate(max(0, n))


def flip_byte(path: str, offset: int = -1) -> None:
    """XOR one byte of ``path`` (default: the last byte) — a bit-rot model."""
    size = os.path.getsize(path)
    if offset < 0:
        offset += size
    with open(path, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# subprocess helpers


def child_env(faults: Optional[str] = None) -> dict:
    """Environment for a child interpreter, with ``REPRO_FAULTS`` set."""
    env = dict(os.environ)
    if faults:
        env[ENV_VAR] = faults
    else:
        env.pop(ENV_VAR, None)
    return env


def run_child(code: str, faults: Optional[str] = None, timeout: float = 120.0,
              ) -> subprocess.CompletedProcess:
    """Run ``python -c code`` with optional env-armed faults; never raises
    on non-zero exit (crash tests *expect* death — check ``returncode``)."""
    return subprocess.run([sys.executable, "-c", code], env=child_env(faults),
                          capture_output=True, text=True, timeout=timeout)


def spawn_child(code: str, faults: Optional[str] = None) -> subprocess.Popen:
    """Start ``python -c code`` with line-buffered stdout for marker sync."""
    return subprocess.Popen([sys.executable, "-u", "-c", code],
                            env=child_env(faults), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def wait_for_marker(proc: subprocess.Popen, marker: str,
                    timeout: float = 120.0) -> bool:
    """Read the child's stdout until a line containing ``marker`` (True) or
    EOF/timeout (False).  Used to SIGKILL a child at a known phase."""
    deadline = time.time() + timeout
    assert proc.stdout is not None
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            return False
        if marker in line:
            return True
    return False


def sigkill(proc: subprocess.Popen) -> int:
    """SIGKILL a child and reap it; returns the exit status (-9)."""
    proc.kill()
    proc.wait()
    with contextlib.suppress(Exception):
        proc.stdout and proc.stdout.close()
        proc.stderr and proc.stderr.close()
    return proc.returncode
