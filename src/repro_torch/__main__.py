"""``python -m repro_torch im …``: the port's front door (see launch/im.py)."""
from __future__ import annotations

import sys


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch im [args...]\n\n"
              "commands:\n  im       run DiFuseR end to end (seed selection)\n\n"
              "run `python -m repro_torch im --help` for its flags")
        raise SystemExit(0 if argv else 2)
    if argv[0] != "im":
        raise SystemExit(f"unknown command {argv[0]!r}; options: im")
    from repro_torch.launch.im import run

    run(argv[1:])


if __name__ == "__main__":
    main()
