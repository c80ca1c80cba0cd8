"""Polyglot edge-protocol gateways — the ``emqx_gateway`` app
(STOMP, MQTT-SN, CoAP, LwM2M, ExProto behind shared behaviours)."""

from emqx_tpu_torch.gateway.ctx import (          # noqa: F401
    GatewayManager, GwContext, GwFrame, GwChannel, GatewayImpl,
)
