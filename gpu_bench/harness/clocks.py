"""What the card and the host did beside each chunk or step of a window:
the card's SM clock, temperature, power and clock-event reasons, sampled
by ``nvidia-smi`` in a loop (read only); this process's CPU time, the
host's stolen time (``/proc/stat``) and this process's garbage-collection
pauses. A window whose chunks run slow is then told apart: a clock held
down (power, thermal), a host that ran this process less, a pause of the
host, or none of these.

    watch = Watch(device)          # in set-up: finds nvidia-smi's fields
    with watch:                    # from the warm-up on
        ... the window: ``marks.append(watch.mark())`` after each unit ...
    watch.report(marks, "chunk")   # one line a unit on standard error
"""

import datetime
import gc
import os
import shutil
import subprocess
import sys
import time
from typing import Dict, List

FIELDS = "timestamp,clocks.sm,temperature.gpu,power.draw,{reasons}"
PERIOD_MS = 250


class Watch:
    """Samples the card every ``PERIOD_MS`` from a separate ``nvidia-smi``
    process, and times each garbage collection of this process, while
    the ``with`` block runs; the process is stopped and waited for on
    exit."""

    def __init__(self, device):
        self.device = device
        self.proc = None
        self.exe = shutil.which("nvidia-smi")
        self.query = None
        if self.exe:
            # newer drivers name the reasons "clocks_event_reasons"
            fields = subprocess.run([self.exe, "--help-query-gpu"], capture_output=True,
                                    text=True, timeout=30).stdout
            reasons = ("clocks_event_reasons.active" if "clocks_event_reasons.active" in fields
                       else "clocks_throttle_reasons.active")
            self.query = FIELDS.format(reasons=reasons)
        self.samples: List[Dict] = []
        self.pauses: List[tuple] = []
        self.host: Dict[float, tuple] = {}
        self._gc_t0 = None

    def mark(self) -> float:
        """``time.perf_counter()`` now, noting this process's CPU seconds
        and the host's stolen seconds at that time."""
        t = time.perf_counter()
        cpu = os.times()
        self.host[t] = (cpu.user + cpu.system, _steal())
        return t

    def _on_gc(self, phase, _info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.pauses.append((self._gc_t0, time.perf_counter()))
            self._gc_t0 = None

    def __enter__(self):
        import torch

        gc.callbacks.append(self._on_gc)
        if self.exe and torch.device(self.device).type == "cuda":
            index = torch.device(self.device).index or 0
            # the offset between the wall clock nvidia-smi stamps and perf_counter
            self._offset = time.time() - time.perf_counter()
            self.proc = subprocess.Popen(
                [self.exe, f"--id={index}", f"--query-gpu={self.query}",
                 "--format=csv,noheader,nounits", f"-lms={PERIOD_MS}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        if self.proc is not None:
            self.proc.terminate()
            out, _ = self.proc.communicate(timeout=30)
            for line in out.splitlines():
                self._parse(line)
        return False

    def _parse(self, line: str) -> None:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != 5:
            return
        try:
            wall = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
            self.samples.append({"t": wall - self._offset, "sm_mhz": float(parts[1]),
                                 "temp_c": float(parts[2]), "power_w": float(parts[3]),
                                 "reasons": int(parts[4], 16)})
        except ValueError:
            return

    def report(self, marks: List[float], unit: str) -> None:
        """One line a unit of the window: its ms, the least SM clock, the
        highest temperature and power, the clock-event reasons seen (OR of
        the masks; 0x1 is idle, 0x4 the power cap, 0x20/0x40 thermal), and
        the host's gc pauses in it."""
        if not self.samples:
            print("card samples: none (nvidia-smi absent or unread)", file=sys.stderr)
        for i, (a, b) in enumerate(zip(marks, marks[1:])):
            got = [s for s in self.samples if a <= s["t"] < b]
            gc_ms = 1e3 * sum(max(0.0, min(e, b) - max(s, a)) for s, e in self.pauses)
            host = ""
            if a in self.host and b in self.host:
                (c0, s0), (c1, s1) = self.host[a], self.host[b]
                host = f"; cpu {1e3 * (c1 - c0):.0f} ms, stolen {1e3 * (s1 - s0):.0f} ms"
            card = (f"sm {min(s['sm_mhz'] for s in got):.0f} MHz, "
                    f"{max(s['temp_c'] for s in got):.0f} C, "
                    f"{max(s['power_w'] for s in got):.1f} W, reasons "
                    f"{hex(_or(s['reasons'] for s in got))}" if got else "no card sample")
            print(f"{unit} {i}: {1e3 * (b - a):.1f} ms; {card}; gc {gc_ms:.1f} ms{host}",
                  file=sys.stderr)


def _or(masks) -> int:
    out = 0
    for m in masks:
        out |= m
    return out


def _steal() -> float:
    """Seconds the hypervisor took from all of the host's CPUs (0 where
    ``/proc/stat`` has no such count)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK") if len(fields) > 8 else 0.0
    except (OSError, ValueError):
        return 0.0
