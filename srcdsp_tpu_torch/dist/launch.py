"""Start, watch and stop the worker processes of a multi-process run.

The launchers (``dist.multihost_check``, ``dist.fault_injection_multihost``)
start each rank as a fresh interpreter (``python -m <module> --worker R``),
never a fork of a process that may hold a CUDA context. Ranks meet at a
``file://`` rendezvous in the run's work directory, so no port is fixed.
Each worker's output goes to a log file of its own (no pipe fills up), and
a worker reports its results on lines ``SRCDSP_REPORT {json}`` that the
parent parses (`reports`). `finish` waits until a deadline and kills every
worker still running when it passes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPORT = "SRCDSP_REPORT"
ROOT = Path(__file__).resolve().parents[2]     # the directory that holds the package


def report(**fields) -> None:
    """Print one report line for the parent."""
    print(f"{REPORT} {json.dumps(fields)}", flush=True)


def reports(text: str) -> list[dict]:
    """The report lines of a worker's output, parsed."""
    return [json.loads(line[len(REPORT) + 1:]) for line in text.splitlines()
            if line.startswith(REPORT + " ")]


@dataclasses.dataclass
class Run:
    """A group of workers: their processes, logs and deadline."""

    procs: list
    logs: list
    deadline: float
    work: Path
    t0: float = dataclasses.field(default_factory=time.perf_counter)


def start(module: str, nproc: int, argv: list[str], work: Path, timeout: float,
          tag: str = "run") -> Run:
    """Start `nproc` workers of `module`, rank r as ``python -m module
    --worker r --init file://<work>/<tag>.rdv <argv>``, each on one torch
    thread (``OMP_NUM_THREADS=1``), with the package on ``PYTHONPATH``."""
    work.mkdir(parents=True, exist_ok=True)
    rdv = work / f"{tag}.rdv"
    if rdv.exists():
        rdv.unlink()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT),
                                                        os.environ.get("PYTHONPATH")])))
    procs, logs = [], []
    for r in range(nproc):
        log = work / f"{tag}.rank{r}.log"
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, "--worker", str(r), "--init", f"file://{rdv}",
                 *argv], stdout=f, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)))
        logs.append(log)
    return Run(procs, logs, time.monotonic() + timeout, work)


def finish(run: Run) -> tuple[list[int], list[str]]:
    """Wait for every worker until the deadline; kill those still running
    when it passes (rc -9). Returns (exit codes, log texts) in rank order."""
    for p in run.procs:
        left = run.deadline - time.monotonic()
        try:
            p.wait(timeout=max(left, 0.01))
        except subprocess.TimeoutExpired:
            break
    for p in run.procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return [p.returncode for p in run.procs], [log.read_text() for log in run.logs]


def failure(codes, texts, what: str) -> str:
    """A message naming the failed ranks with the end of each one's log."""
    tails = "\n".join(f"--- rank {r} (rc {c}) ---\n{t[-3000:]}"
                      for r, (c, t) in enumerate(zip(codes, texts)) if c != 0)
    return f"{what}: worker exit codes {codes}\n{tails}"
