"""Seconds of the ``Broker.subscribe`` loop over the cell's subscriptions."""


def read(run):
    return run.setup["subscribe_s"]
