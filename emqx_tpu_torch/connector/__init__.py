"""Connector clients — the ``emqx_connector`` app (HTTP, MQTT bridge,
plus a memory test double standing in for the SQL/NoSQL pool clients).
"""

from emqx_tpu_torch.connector.memory import MemoryConnector     # noqa: F401
from emqx_tpu_torch.connector.http import HttpConnector         # noqa: F401
from emqx_tpu_torch.connector.mqtt import MqttConnector         # noqa: F401
