"""Host time inside Convolver.process per block, over calls each started on
an idle device (the host's own cost; in the free loop the host waits on the
full launch queue)."""


def read(run):
    return 1e6 * sum(run.window.enqueue_s) / run.window.enqueue_blocks if run.window.enqueue_blocks else None
