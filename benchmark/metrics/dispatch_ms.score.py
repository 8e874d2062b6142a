"""dispatch_ms.score: see harness.runner.dispatch_ms."""

from harness.runner import dispatch_ms


def read(run):
    return dispatch_ms(run, train=False)
