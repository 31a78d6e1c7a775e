"""Terminal progress bar (ref: src/core/progressbar.c).

The port's copy of ``genometools_tpu/utils/progressbar.py``
(JAX-free host code; the port imports nothing of the reference
package).

Same visual contract as the reference:

     27% |*************                                   |    00:07 ETA
    100% |************************************************| 02:00:10

  * percent field (5 cols) + bar |****    | sized to the terminal
    (bar = window - 22 cols) + 14-col time field: ETA while running,
    elapsed when the counter reaches the total;
  * refreshed once per second (ref UPDATE_INTERVAL) — the reference
    uses SIGALRM ticks against a `volatile const GtUint64 *` counter;
    the rebuild polls a zero-argument getter from a daemon thread,
    which is the same contract (the engine just increments a counter,
    the bar samples it) without signal-handler constraints;
  * only drawn when stdout is a tty, exactly like the reference
    (tools call gt_progressbar_start unconditionally; drawing to a
    pipe would corrupt output).

Engines call `start(getter, total)` / `stop()`; `for_range` wraps an
iterable the way gt_progressbar_start wraps counting loops.
"""

from __future__ import annotations

import os
import shutil
import sys
import threading
import time

_DEFAULT_WINDOW = 80
_MAX_WINDOW = 512
_UPDATE_INTERVAL = 1.0


def _window_size() -> int:
    try:
        w = shutil.get_terminal_size((_DEFAULT_WINDOW, 24)).columns
    except OSError:
        w = _DEFAULT_WINDOW
    return min(max(w, 1), _MAX_WINDOW) + 1


def _fmt_time(seconds: int, eta: bool) -> str:
    """14-col right field (ref refresh_progressbar: ' %2u:%02u:%02u'
    with hours, '    %02u:%02u' without; running bars append ' ETA')."""
    hours, rem = divmod(max(0, int(seconds)), 3600)
    minutes, secs = divmod(rem, 60)
    if hours:
        core = f" {hours:2d}:{minutes:02d}:{secs:02d}"
    else:
        core = f"    {minutes:02d}:{secs:02d}"
    return core + (" ETA" if eta else "")


def render(processed: int, total: int, elapsed: float,
           window: int | None = None) -> str:
    """One bar frame (pure; unit-testable). Mirrors
    refresh_progressbar's layout: 5-col percent, bar of window-22
    stars, time field."""
    window = window or _window_size()
    percent = (processed / total) if total else 1.0
    percent = min(max(percent, 0.0), 1.0)
    out = f"\r{int(percent * 100):3d}% "
    bar_length = window - 22
    if bar_length >= 2:
        width = int(percent * bar_length)
        out += "|" + "*" * width + " " * (bar_length - width) + "|"
    if processed >= total:
        out += _fmt_time(int(elapsed), eta=False)
    elif processed and elapsed > 0:
        rate = processed / elapsed
        out += _fmt_time(int((total - processed) / rate), eta=True)
    return out


class _Bar:
    def __init__(self, getter, total: int, out):
        self.getter = getter
        self.total = int(total)
        self.out = out
        self.t0 = time.monotonic()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _draw(self):
        try:
            frame = render(int(self.getter()), self.total,
                           time.monotonic() - self.t0)
            self.out.write(frame)
            self.out.flush()
        except (OSError, ValueError):
            self._stop.set()

    def _run(self):
        while not self._stop.wait(_UPDATE_INTERVAL):
            self._draw()

    def finish(self):
        self._stop.set()
        self.thread.join(timeout=2.0)
        self._draw()
        try:
            self.out.write("\n")
            self.out.flush()
        except (OSError, ValueError):
            pass


_active: _Bar | None = None


def start(getter, total: int, out=None, force: bool = False) -> None:
    """gt_progressbar_start. Drawn only on a tty (or force=True /
    GT_PROGRESSBAR_FORCE for tests)."""
    global _active
    out = out or sys.stdout
    force = force or bool(os.environ.get("GT_PROGRESSBAR_FORCE"))
    if _active is not None or (not force and not out.isatty()):
        return
    _active = _Bar(getter, total, out)


def stop() -> None:
    """gt_progressbar_stop: final 100% frame + newline."""
    global _active
    if _active is not None:
        _active.finish()
        _active = None


def for_range(iterable, total: int, out=None):
    """Iterate with a live bar (the reference's counting-loop idiom,
    progressbar.h:30-38)."""
    count = [0]
    start(lambda: count[0], total, out=out)
    try:
        for item in iterable:
            yield item
            count[0] += 1
    finally:
        stop()
