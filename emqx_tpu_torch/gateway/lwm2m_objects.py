"""LwM2M object registry — the ``apps/emqx_gateway/src/lwm2m`` XML
object-definition store (emqx_lwm2m_xml_object.erl + the OMA registry
DDF files it loads), as data.

The reference ships OMA DDF XML for the core objects and uses them to
translate numeric paths (``/3/0/0``) to names (``Device/Manufacturer``),
validate operations (Read/Write/Execute per resource), and type wire
values. This registry covers OMA core objects 0-7 with the same
surface: lookup by object id or name, resource metadata, path
translation both ways, and operation checks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class LwResource:
    rid: int
    name: str
    operations: str          # subset of "RWE"
    type: str = "String"     # String|Integer|Float|Boolean|Opaque|Time|Objlnk
    mandatory: bool = False
    multiple: bool = False


@dataclass(frozen=True)
class LwObject:
    oid: int
    name: str
    urn: str
    multiple: bool
    resources: tuple
    _by_id: dict = field(default_factory=dict, compare=False)

    def resource(self, rid: int) -> Optional[LwResource]:
        if not self._by_id:
            self._by_id.update({r.rid: r for r in self.resources})
        return self._by_id.get(rid)


def _obj(oid, name, urn, multiple, rows) -> LwObject:
    return LwObject(oid, name, urn, multiple, tuple(
        LwResource(*row) for row in rows))


# OMA LwM2M core objects (oma.org registry; column order:
# rid, name, operations, type, mandatory, multiple)
OBJECTS: dict[int, LwObject] = {o.oid: o for o in [
    _obj(0, "LWM2M Security", "urn:oma:lwm2m:oma:0", True, [
        (0, "LWM2M Server URI", "", "String", True),
        (1, "Bootstrap-Server", "", "Boolean", True),
        (2, "Security Mode", "", "Integer", True),
        (3, "Public Key or Identity", "", "Opaque", True),
        (4, "Server Public Key", "", "Opaque", True),
        (5, "Secret Key", "", "Opaque", True),
        (10, "Short Server ID", "", "Integer"),
    ]),
    _obj(1, "LWM2M Server", "urn:oma:lwm2m:oma:1", True, [
        (0, "Short Server ID", "R", "Integer", True),
        (1, "Lifetime", "RW", "Integer", True),
        (2, "Default Minimum Period", "RW", "Integer"),
        (3, "Default Maximum Period", "RW", "Integer"),
        (4, "Disable", "E"),
        (5, "Disable Timeout", "RW", "Integer"),
        (6, "Notification Storing When Disabled or Offline", "RW",
         "Boolean", True),
        (7, "Binding", "RW", "String", True),
        (8, "Registration Update Trigger", "E", "", True),
    ]),
    _obj(2, "LWM2M Access Control", "urn:oma:lwm2m:oma:2", True, [
        (0, "Object ID", "R", "Integer", True),
        (1, "Object Instance ID", "R", "Integer", True),
        (2, "ACL", "RW", "Integer", False, True),
        (3, "Access Control Owner", "RW", "Integer", True),
    ]),
    _obj(3, "Device", "urn:oma:lwm2m:oma:3", False, [
        (0, "Manufacturer", "R"),
        (1, "Model Number", "R"),
        (2, "Serial Number", "R"),
        (3, "Firmware Version", "R"),
        (4, "Reboot", "E", "", True),
        (5, "Factory Reset", "E"),
        (6, "Available Power Sources", "R", "Integer", False, True),
        (7, "Power Source Voltage", "R", "Integer", False, True),
        (8, "Power Source Current", "R", "Integer", False, True),
        (9, "Battery Level", "R", "Integer"),
        (10, "Memory Free", "R", "Integer"),
        (11, "Error Code", "R", "Integer", True, True),
        (12, "Reset Error Code", "E"),
        (13, "Current Time", "RW", "Time"),
        (14, "UTC Offset", "RW"),
        (15, "Timezone", "RW"),
        (16, "Supported Binding and Modes", "R", "String", True),
    ]),
    _obj(4, "Connectivity Monitoring", "urn:oma:lwm2m:oma:4", False, [
        (0, "Network Bearer", "R", "Integer", True),
        (1, "Available Network Bearer", "R", "Integer", True, True),
        (2, "Radio Signal Strength", "R", "Integer", True),
        (3, "Link Quality", "R", "Integer"),
        (4, "IP Addresses", "R", "String", True, True),
        (5, "Router IP Addresses", "R", "String", False, True),
        (6, "Link Utilization", "R", "Integer"),
        (7, "APN", "R", "String", False, True),
        (8, "Cell ID", "R", "Integer"),
        (9, "SMNC", "R", "Integer"),
        (10, "SMCC", "R", "Integer"),
    ]),
    _obj(5, "Firmware Update", "urn:oma:lwm2m:oma:5", False, [
        (0, "Package", "W", "Opaque", True),
        (1, "Package URI", "W", "String", True),
        (2, "Update", "E", "", True),
        (3, "State", "R", "Integer", True),
        (5, "Update Result", "R", "Integer", True),
        (6, "PkgName", "R"),
        (7, "PkgVersion", "R"),
    ]),
    _obj(6, "Location", "urn:oma:lwm2m:oma:6", False, [
        (0, "Latitude", "R", "Float", True),
        (1, "Longitude", "R", "Float", True),
        (2, "Altitude", "R", "Float"),
        (3, "Radius", "R", "Float"),
        (4, "Velocity", "R", "Opaque"),
        (5, "Timestamp", "R", "Time", True),
        (6, "Speed", "R", "Float"),
    ]),
    _obj(7, "Connectivity Statistics", "urn:oma:lwm2m:oma:7", False, [
        (0, "SMS Tx Counter", "R", "Integer"),
        (1, "SMS Rx Counter", "R", "Integer"),
        (2, "Tx Data", "R", "Integer"),
        (3, "Rx Data", "R", "Integer"),
        (4, "Max Message Size", "R", "Integer"),
        (5, "Average Message Size", "R", "Integer"),
        (6, "Start", "E", "", True),
        (7, "Stop", "E", "", True),
    ]),
]}

_BY_NAME = {o.name: o for o in OBJECTS.values()}


def object_by_id(oid: int) -> Optional[LwObject]:
    return OBJECTS.get(oid)


def object_by_name(name: str) -> Optional[LwObject]:
    return _BY_NAME.get(name)


def parse_path(path: str) -> tuple:
    """'/3/0/9' → (3, 0, 9); missing levels are None; non-numeric
    segments make the whole path unknown (None, None, None)."""
    parts = [p for p in path.split("/") if p != ""]
    out = []
    for p in parts[:3]:
        try:
            out.append(int(p))
        except ValueError:
            return (None, None, None)
    while len(out) < 3:
        out.append(None)
    return tuple(out)


def translate_path(path: str) -> Optional[str]:
    """'/3/0/0' → 'Device/0/Manufacturer' (None for unknown objects —
    the reference answers {error, no_xml_definition})."""
    oid, inst, rid = parse_path(path)
    obj = OBJECTS.get(oid)
    if obj is None:
        return None
    parts = [obj.name]
    if inst is not None:
        parts.append(str(inst))
    if rid is not None:
        res = obj.resource(rid)
        parts.append(res.name if res is not None else str(rid))
    return "/".join(parts)


def check_operation(path: str, op: str) -> bool:
    """Is ``op`` ('R'|'W'|'E') allowed at the resource?  Object/instance
    level allows R/W (covers discover/observe). VENDOR objects (outside
    the core registry) are permitted — the gateway has no definition to
    validate against, so the device decides (the reference only rejects
    when it HAS an XML def that forbids the op). A malformed path is
    rejected."""
    oid, _inst, rid = parse_path(path)
    if oid is None:
        return False                    # malformed path
    obj = OBJECTS.get(oid)
    if obj is None:
        return True                     # vendor object: forward as-is
    if rid is None:
        return op in ("R", "W")
    res = obj.resource(rid)
    if res is None:
        return False
    return op in res.operations


def parse_core_links(payload: str) -> list[dict]:
    """CoRE link-format registration payload ('</3/0>,</5>;ver=1.0') →
    [{path, oid, instance, name}] with registry names resolved."""
    out = []
    for link in payload.split(","):
        link = link.strip()
        if not link.startswith("<"):
            continue
        target = link[1:link.index(">")] if ">" in link else ""
        if not target or target == "/":
            continue
        oid, inst, _ = parse_path(target)
        if oid is None:
            continue
        obj = OBJECTS.get(oid)
        out.append({
            "path": target,
            "oid": oid,
            "instance": inst,
            "name": obj.name if obj is not None else None,
        })
    return out
