"""idle_share.score: see harness.runner.idle_share."""

from harness.runner import idle_share


def read(run):
    return idle_share(run, train=False)
