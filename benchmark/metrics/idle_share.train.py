"""idle_share.train: see harness.runner.idle_share."""

from harness.runner import idle_share


def read(run):
    return idle_share(run, train=True)
