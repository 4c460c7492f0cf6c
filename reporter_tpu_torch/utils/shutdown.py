"""Shutdown-signal helpers shared by the CLIs (the port's copy of the JAX
package's module of the same name).

Two patterns, chosen per loop shape (see kafka_io.run_pipeline for the
original rationale):

- ``StopFlag`` -- cooperative: the handler only sets a flag; the loop polls
  it at SAFE points (between records), so a signal can never interrupt a
  pipeline mutation and then have half-applied state snapshotted.  Loops
  that block in syscalls must wake up periodically (poll timeouts,
  ``selectors`` with a timeout): PEP 475 retries interrupted reads after a
  non-raising handler runs, so a pure flag never unblocks a blocking read.
- ``term_to_keyboard_interrupt`` -- raise-based: converts SIGTERM into the
  KeyboardInterrupt path.  Only safe when the main thread sits in a loop
  that is interrupt-safe by design (e.g. ``serve_forever``'s select loop,
  with request handlers on other threads).

Both disarm to ``SIG_DFL`` on first delivery via ``once=True`` semantics
where requested: the first signal is graceful, a second one kills -- the
operator's escalation path, and it keeps a signal during CLEANUP from
unwinding the cleanup itself.
"""

from __future__ import annotations

import signal
from typing import Callable, Iterable, List

# best-effort hooks run on the FIRST delivery of a stop signal, before the
# flag flips / KeyboardInterrupt raises: the stream and batch CLIs register
# the flight recorder's disk dump here (obs.flight.shutdown_dump) so a
# SIGTERM'd process leaves its last traces behind.  Hooks must be fast, lock-free on the
# paths a handler can interrupt, and never raise (they run inside a signal
# handler); failures are swallowed -- shutdown must proceed regardless.
_HOOKS: List[Callable[[], None]] = []


def on_shutdown(fn: Callable[[], None]) -> None:
    """Register a hook to run once on the first SIGTERM/SIGINT delivery
    (and on explicit ``run_shutdown_hooks()`` calls from fatal paths)."""
    if fn not in _HOOKS:
        _HOOKS.append(fn)


def run_shutdown_hooks() -> None:
    """Run every registered hook, best-effort.  Safe to call repeatedly
    (fatal exit paths call it explicitly; signal handlers call it too)."""
    for fn in list(_HOOKS):
        try:
            fn()
        except Exception:  # noqa: BLE001 - shutdown must proceed
            pass


class StopFlag:
    """Set by the installed handlers; poll ``requested`` at safe points."""

    def __init__(self) -> None:
        self.requested = False
        self._prev = []

    def install(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT),
                escalate: bool = True) -> "StopFlag":
        """Install flag-setting handlers.  With ``escalate`` the handler
        disarms itself on first delivery (restores SIG_DFL), so a second
        signal terminates immediately instead of being swallowed while
        cleanup runs.  Returns self; no-ops off the main thread.  Library
        entry points that can be called repeatedly in one process should
        ``restore()`` in a finally."""

        def _handler(signum, frame):
            self.requested = True
            if escalate:
                try:
                    signal.signal(signum, signal.SIG_DFL)
                except (ValueError, OSError):  # pragma: no cover
                    pass
            run_shutdown_hooks()

        for sig in signals:
            try:
                self._prev.append((sig, signal.signal(sig, _handler)))
            except ValueError:  # not the main thread: caller handles stops
                break
        return self

    def restore(self) -> None:
        """Reinstall the handlers that were active before install()."""
        for sig, h in self._prev:
            try:
                signal.signal(sig, h)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev = []


def term_to_keyboard_interrupt() -> None:
    """SIGTERM -> KeyboardInterrupt (once: the handler disarms itself so a
    second SIGTERM during cleanup force-terminates instead of unwinding the
    cleanup).  No-op off the main thread."""

    def _term(signum, frame):
        try:
            signal.signal(signum, signal.SIG_DFL)
        except (ValueError, OSError):  # pragma: no cover
            pass
        run_shutdown_hooks()
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass
