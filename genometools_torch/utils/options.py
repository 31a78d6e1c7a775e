"""Option constraints, logger and phase timers for the CLI.

The port's copy of ``genometools_tpu/utils/options.py``
(JAX-free host code; the port imports nothing of the reference
package).

Capability equivalent of the reference's option machinery and
observability helpers:
  * gt_option_imply / gt_option_imply_either / gt_option_exclude with
    byte-matched error texts (ref: src/core/option.c:784-880
    gt_option_parser_check_implications/_exclusions)
  * GtLogger `-v` ("# " prefixed key/value lines on stdout,
    ref: src/core/logger.c) and `-debug` (stderr, also enabled by the
    GT_DEBUG environment variable, ref: src/core/log.c)
  * `-showtime` phase timers printing "# TIME <desc> <sec>.<cc>"
    (ref: src/core/timer.c:208 gt_timer_show_progress,
    src/core/showtime.c)
"""

from __future__ import annotations

import os
import sys
import time


class Constraints:
    """Declarative implications/exclusions checked against the raw
    argv (an option "is set" iff it appeared on the command line —
    the reference's is_set semantics)."""

    def __init__(self):
        self._imply: list[tuple[str, list[str]]] = []
        self._exclude: list[tuple[str, str]] = []
        self._mandatory: list[str] = []

    def imply(self, a: str, b: str) -> "Constraints":
        self._imply.append((a, [b]))
        return self

    def imply_either(self, a: str, *alts: str) -> "Constraints":
        self._imply.append((a, list(alts)))
        return self

    def exclude(self, a: str, b: str) -> "Constraints":
        self._exclude.append((a, b))
        return self

    def mandatory(self, a: str) -> "Constraints":
        self._mandatory.append(a)
        return self

    def check(self, argv: list[str], error) -> None:
        """error: callable(msg) that reports and exits (parser.error).
        Texts match gt_option_parser_check_* exactly."""
        present = {a.split("=")[0] for a in argv if a.startswith("-")}

        def is_set(name: str) -> bool:
            return f"-{name}" in present

        for a in self._mandatory:
            if not is_set(a):
                error(f'option "-{a}" is mandatory')
        for a, alts in self._imply:
            if is_set(a) and not any(is_set(x) for x in alts):
                if len(alts) == 1:
                    error(f'option "-{a}" requires option '
                          f'"-{alts[0]}"')
                else:
                    opts = " ".join(f'"-{x}"' for x in alts[:-1])
                    error(f'option "-{a}" requires option {opts} or '
                          f'"-{alts[-1]}"')
        for a, b in self._exclude:
            if is_set(a) and is_set(b):
                error(f'option "-{a}" and option "-{b}" exclude each '
                      f'other')


class Logger:
    """ref: src/core/logger.c — `-v` logger: "# "-prefixed lines."""

    def __init__(self, enabled: bool = False, prefix: str = "# ",
                 out=None):
        self.enabled = enabled
        self.prefix = prefix
        self.out = out if out is not None else sys.stdout

    def log(self, msg: str) -> None:
        if self.enabled:
            print(f"{self.prefix}{msg}", file=self.out)


def debug_enabled() -> bool:
    """ref: src/core/log.c — -debug or the GT_DEBUG env variable."""
    return bool(os.environ.get("GT_DEBUG"))


def debug(msg: str) -> None:
    if debug_enabled():
        print(f"debug: {msg}", file=sys.stderr)


class Showtime:
    """ref: src/core/timer.c gt_timer_show_progress — per-phase wall
    clocks printed as `# TIME <desc> <sec>.<centisec>` when enabled
    (gt_showtime_enable, src/core/showtime.c)."""

    def __init__(self, enabled: bool = False, out=None):
        # GT_ENV_OPTIONS=-showtime enables timers globally
        # (ref: src/core/init.c:58-60 + showtime.c gt_showtime_enable)
        self.enabled = enabled or bool(os.environ.get("GT_SHOWTIME"))
        self.out = out if out is not None else sys.stderr
        self._t0 = time.perf_counter()
        self._last = self._t0

    def phase(self, desc: str) -> None:
        """Close the running phase under `desc` (the reference prints
        at phase *switch*, attributing elapsed time since the last)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        el = now - self._last
        self._last = now
        print(f"# TIME {desc} {int(el)}.{int(el * 100) % 100:02d}",
              file=self.out)

    def overall(self, desc: str = "overall") -> None:
        if not self.enabled:
            return
        el = time.perf_counter() - self._t0
        print(f"# TIME {desc} {int(el)}.{int(el * 100) % 100:02d}",
              file=self.out)
