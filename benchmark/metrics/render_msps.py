"""Channel-samples rendered in the window over its host seconds, in millions
a second (the window ends in a device synchronise)."""


def read(run):
    return run.window.samples / run.window.seconds / 1e6 if run.traffic["loop"] == "closed" else None
