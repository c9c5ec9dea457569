"""Seconds from the process's start to the first due request: imports,
kernel libraries (built on a checkout's first run, loaded after), the
traffic's files, the weights, the captured graphs and the caches' fill."""


def read(run):
    return run.setup_s
