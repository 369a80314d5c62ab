"""``python -m repro_torch im|serve|dryrun …``: the port's front doors (see
launch/im.py, launch/serve_im.py and launch/dryrun.py)."""
from __future__ import annotations

import sys

_COMMANDS = {"im": "run DiFuseR end to end (seed selection)",
             "serve": "serve influence queries from a resident sketch index",
             "dryrun": "trace the production-mesh cells on meta tensors (no execution)"}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        lines = "".join(f"  {name:<8} {what}\n" for name, what in _COMMANDS.items())
        print("usage: python -m repro_torch {im,serve,dryrun} [args...]\n\n"
              f"commands:\n{lines}\n"
              "run `python -m repro_torch <command> --help` for its flags")
        raise SystemExit(0 if argv else 2)
    if argv[0] not in _COMMANDS:
        raise SystemExit(f"unknown command {argv[0]!r}; options: {', '.join(_COMMANDS)}")
    if argv[0] == "im":
        from repro_torch.launch.im import run
    elif argv[0] == "serve":
        from repro_torch.launch.serve_im import run
    else:
        from repro_torch.launch.dryrun import main as run
    run(argv[1:])


if __name__ == "__main__":
    main()
