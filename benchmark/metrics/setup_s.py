"""Seconds from process start to the first timed call: imports, library load
(and a first run's build), inputs, filter build, warm-up."""


def read(run):
    return run.setup_s
