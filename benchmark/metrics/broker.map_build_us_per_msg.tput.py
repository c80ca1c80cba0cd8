"""The broker's delivery-map build a message: ``Broker.publish_batch_collect``
less the model's collect inside it, plus the CM dispatch, summed over the
window, over the collected messages."""


def read(run):
    outer = run.calls("bench.broker_collect")
    inner = run.calls("bench.model_collect")
    dispatch = run.calls("bench.dispatch")
    n = sum(c[2] for c in outer)
    if not n:
        return None
    spent = (sum(b - a for a, b, _ in outer) - sum(b - a for a, b, _ in inner)
             + sum(b - a for a, b, _ in dispatch))
    return spent / 1e3 / n
