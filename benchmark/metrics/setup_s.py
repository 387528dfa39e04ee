"""Set-up: process start to the window's start (host clock).  Kernel
load from the build cache, keys and inputs, the session or the files,
and one warm-up proof; in a checkout's first run also the kernel build."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run["setup_s"]
