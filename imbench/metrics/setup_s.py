"""``setup_s``: from the process's start to the window's: imports, the
graph made from the seed, the program's ``Graph``, and the warm-up job
(with the kernel builds of a checkout's first run)."""


def read(win):
    return win.setup_s
