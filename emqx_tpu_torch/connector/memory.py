"""In-memory connector — the test double the resource/bridge suites
drive (the reference's emqx_connector_demo / test resources). Records
queries, supports failure injection and health flapping."""

from __future__ import annotations

from typing import Any

from emqx_tpu_torch.resource.resource import Resource


class MemoryConnector(Resource):
    def __init__(self) -> None:
        self.started = False
        self.healthy = True
        self.fail_queries = False
        self.fail_start = False
        self.queries: list[Any] = []
        self.batches: list[list] = []

    def on_start(self, conf: dict) -> None:
        if self.fail_start:
            raise ConnectionError("injected start failure")
        self.started = True

    def on_stop(self) -> None:
        self.started = False

    def on_query(self, req: Any) -> Any:
        if self.fail_queries:
            raise ConnectionError("injected query failure")
        self.queries.append(req)
        return {"ok": req}

    def on_batch_query(self, reqs: list) -> list:
        if self.fail_queries:
            raise ConnectionError("injected query failure")
        self.batches.append(list(reqs))
        self.queries.extend(reqs)
        return [{"ok": r} for r in reqs]

    def on_health_check(self) -> bool:
        return self.healthy
