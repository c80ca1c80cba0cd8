"""The broker's hook fold a message: ``Broker.publish_batch_submit`` less
the model's submit inside it, summed over the window, over its messages."""


def read(run):
    outer = run.calls("bench.broker_submit")
    inner = run.calls("bench.model_submit")
    n = sum(c[2] for c in outer)
    if not n:
        return None
    spent = sum(b - a for a, b, _ in outer) - sum(b - a for a, b, _ in inner)
    return spent / 1e3 / n
