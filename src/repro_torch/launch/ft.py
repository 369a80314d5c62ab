"""Supervised relaunch of the port's launchers, the reference's
``launch/ft.py`` for ``python -m repro_torch im`` and ``serve``::

    python -m repro_torch.launch.ft [--max-restarts 5] \
        [--heartbeat-file hb] [--heartbeat-timeout 600] -- \
        python -m repro_torch serve --graph rmat:20 --save index.npz

  * **Restart**: on a non-zero exit (a lost host, an out-of-memory kill, a
    CUDA error that ends the process) the command is run again, up to
    ``--max-restarts`` times, with an exponential back-off. A server that
    saved its index (``serve --save``; ``SketchStore.load`` restores it)
    skips the cold build on the next launch.
  * **Hang**: a heartbeat file that was not touched within the timeout is
    taken for a hung process, which is killed and relaunched.
  * **Elastic**: a snapshot holds the canonical row order and the plan, so a
    relaunch on another shard grid re-plans its row blocks from it.

It supervises a local subprocess, so the restart logic itself is testable
without a cluster manager.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def supervise(cmd: list[str], *, max_restarts: int = 5, heartbeat_file: str | None = None,
              heartbeat_timeout_s: float = 600.0) -> int:
    """Run ``cmd``, relaunching it on failure. A heartbeat file not touched
    within the timeout counts as a hang: kill, then relaunch. Returns the
    last exit code (0 once a run succeeds)."""
    restarts = 0
    while True:
        proc = subprocess.Popen(cmd)
        while True:
            try:
                rc = proc.wait(timeout=30)
                break
            except subprocess.TimeoutExpired:
                if heartbeat_file and os.path.exists(heartbeat_file):
                    age = time.time() - os.path.getmtime(heartbeat_file)
                    if age > heartbeat_timeout_s:
                        print(f"[ft] heartbeat stale ({age:.0f}s) — killing straggler",
                              file=sys.stderr)
                        proc.kill()
                        proc.wait()
                        rc = -9
                        break
        if rc == 0:
            return 0
        restarts += 1
        if restarts > max_restarts:
            print(f"[ft] giving up after {max_restarts} restarts", file=sys.stderr)
            return rc
        backoff = min(2.0 ** restarts, 60.0)
        print(f"[ft] exit={rc}; restart {restarts}/{max_restarts} in {backoff:.0f}s",
              file=sys.stderr)
        time.sleep(backoff)


def main() -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.ft",
        description="supervise a long-running launch: ft [opts] -- <cmd...>")
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--heartbeat-file", default=None)
    ap.add_argument("--heartbeat-timeout", type=float, default=600.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        raise SystemExit("usage: python -m repro_torch.launch.ft [opts] -- <command ...>")
    raise SystemExit(supervise(cmd, max_restarts=args.max_restarts,
                               heartbeat_file=args.heartbeat_file,
                               heartbeat_timeout_s=args.heartbeat_timeout))


if __name__ == "__main__":
    main()
