"""dispatch_ms.train: see harness.runner.dispatch_ms."""

from harness.runner import dispatch_ms


def read(run):
    return dispatch_ms(run, train=True)
