"""OMA LwM2M TLV content codec — the ``emqx_lwm2m_tlv.erl`` +
value-translation half of ``emqx_lwm2m_message.erl``.

Wire format (OMA-TS-LightweightM2M §6.4.3): each entry is

    type byte: bits 7-6 identifier kind (00 object instance,
               01 resource instance, 10 multiple resource,
               11 resource with value)
               bit 5    identifier width (0: 1 byte, 1: 2 bytes)
               bits 4-3 length width (00: bits 2-0 hold the length,
               01/10/11: 1/2/3 extra length bytes)
    identifier, [length], value  — nested for instance containers.

Values type against the object registry (lwm2m_objects.py, the XML DDF
store): Integer/Time are signed big-endian 1/2/4/8 bytes, Float is
IEEE754 4/8, Boolean one byte, String UTF-8, Opaque raw, Objlnk two
uint16s. ``tlv_to_path_values`` / ``path_values_to_tlv`` are the
JSON↔TLV halves the reference's command translator uses for Read
responses, Notify bodies and Write payloads.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

from emqx_tpu_torch.gateway import lwm2m_objects as objects

OBJ_INSTANCE, RES_INSTANCE, MULTI_RES, RESOURCE = (
    "obj_inst", "res_inst", "multi_res", "resource")
_KIND_BITS = {0: OBJ_INSTANCE, 1: RES_INSTANCE, 2: MULTI_RES, 3: RESOURCE}
_BITS_KIND = {v: k for k, v in _KIND_BITS.items()}

CONTENT_TLV = 11542          # application/vnd.oma.lwm2m+tlv
CONTENT_JSON = 11543         # application/vnd.oma.lwm2m+json
CONTENT_TEXT = 0             # text/plain (single-resource reads)
CONTENT_OPAQUE = 42


class TlvError(Exception):
    pass


# ---------------------------------------------------------------------------
# structural codec


def tlv_decode(data: bytes) -> list[dict]:
    """-> [{kind, id, value | children}] (children for containers)."""
    out, pos = [], 0
    n = len(data)
    while pos < n:
        t = data[pos]
        pos += 1
        kind = _KIND_BITS[(t >> 6) & 0x03]
        id_w = 2 if t & 0x20 else 1
        if pos + id_w > n:
            raise TlvError("truncated identifier")
        ident = int.from_bytes(data[pos:pos + id_w], "big")
        pos += id_w
        len_w = (t >> 3) & 0x03
        if len_w == 0:
            length = t & 0x07
        else:
            if pos + len_w > n:
                raise TlvError("truncated length")
            length = int.from_bytes(data[pos:pos + len_w], "big")
            pos += len_w
        if pos + length > n:
            raise TlvError("truncated value")
        body = data[pos:pos + length]
        pos += length
        if kind in (OBJ_INSTANCE, MULTI_RES):
            out.append({"kind": kind, "id": ident,
                        "children": tlv_decode(body)})
        else:
            out.append({"kind": kind, "id": ident, "value": body})
    return out


def tlv_encode(entries: list[dict]) -> bytes:
    out = bytearray()
    for e in entries:
        kind = e["kind"]
        if kind in (OBJ_INSTANCE, MULTI_RES):
            body = tlv_encode(e["children"])
        else:
            body = bytes(e["value"])
        ident = int(e["id"])
        t = _BITS_KIND[kind] << 6
        id_bytes = 2 if ident > 0xFF else 1
        if id_bytes == 2:
            t |= 0x20
        n = len(body)
        if n < 8:
            t |= n
            len_bytes = b""
        else:
            ln_w = 1 if n < (1 << 8) else 2 if n < (1 << 16) else 3
            t |= ln_w << 3
            len_bytes = n.to_bytes(ln_w, "big")
        out.append(t)
        out += ident.to_bytes(id_bytes, "big")
        out += len_bytes
        out += body
    return bytes(out)


# ---------------------------------------------------------------------------
# value codec (resource data types from the registry)


def decode_value(raw: bytes, rtype: str) -> Any:
    if rtype in ("Integer", "Time"):
        if len(raw) not in (1, 2, 4, 8):
            raise TlvError(f"bad integer width {len(raw)}")
        return int.from_bytes(raw, "big", signed=True)
    if rtype == "Float":
        if len(raw) == 4:
            return struct.unpack(">f", raw)[0]
        if len(raw) == 8:
            return struct.unpack(">d", raw)[0]
        raise TlvError(f"bad float width {len(raw)}")
    if rtype == "Boolean":
        if len(raw) != 1 or raw[0] > 1:
            raise TlvError("bad boolean")
        return raw[0] == 1
    if rtype == "Objlnk":
        if len(raw) != 4:
            raise TlvError("bad objlnk")
        oid, iid = struct.unpack(">HH", raw)
        return f"{oid}:{iid}"
    if rtype == "Opaque":
        return raw.hex()
    return raw.decode("utf-8", "replace")            # String


def encode_value(value: Any, rtype: str) -> bytes:
    if rtype in ("Integer", "Time"):
        v = int(value)
        for w in (1, 2, 4, 8):
            if -(1 << (8 * w - 1)) <= v < (1 << (8 * w - 1)):
                return v.to_bytes(w, "big", signed=True)
        raise TlvError(f"integer out of range: {value}")
    if rtype == "Float":
        return struct.pack(">d", float(value))
    if rtype == "Boolean":
        truthy = value in (True, 1, "1", "true", "True")
        return b"\x01" if truthy else b"\x00"
    if rtype == "Objlnk":
        oid, _, iid = str(value).partition(":")
        return struct.pack(">HH", int(oid), int(iid or 0))
    if rtype == "Opaque":
        return bytes.fromhex(value) if isinstance(value, str) else \
            bytes(value)
    return str(value).encode()                       # String


# ---------------------------------------------------------------------------
# path-addressed translation (emqx_lwm2m_message tlv_to_json/json_to_tlv)


def _rtype(oid: int, rid: int) -> str:
    obj = objects.OBJECTS.get(oid)
    res = obj.resource(rid) if obj else None
    return res.type if res else "Opaque"


def tlv_to_path_values(base_path: str, data: bytes) -> list[dict]:
    """TLV body of a Read/Observe response on ``base_path``
    (``/oid[/iid[/rid]]``) → [{path, name, value}] rows, values typed
    by the registry."""
    segs = [s for s in base_path.split("/") if s]
    if not segs:
        raise TlvError("TLV needs an object path")
    oid = int(segs[0])
    rows: list[dict] = []

    def emit(iid: Optional[int], rid: int, raw: bytes,
             sub: Optional[int] = None) -> None:
        rtype = _rtype(oid, rid)
        path = f"/{oid}" + (f"/{iid}" if iid is not None else "") + \
            f"/{rid}" + (f"/{sub}" if sub is not None else "")
        rows.append({"path": path,
                     "name": objects.translate_path(f"/{oid}/0/{rid}"),
                     "value": decode_value(raw, rtype)})

    entries = tlv_decode(data)
    iid_ctx = int(segs[1]) if len(segs) > 1 else None
    for e in entries:
        if e["kind"] == OBJ_INSTANCE:
            for r in e["children"]:
                if r["kind"] == MULTI_RES:
                    for ri in r["children"]:
                        emit(e["id"], r["id"], ri["value"], ri["id"])
                else:
                    emit(e["id"], r["id"], r["value"])
        elif e["kind"] == MULTI_RES:
            for ri in e["children"]:
                emit(iid_ctx, e["id"], ri["value"], ri["id"])
        elif e["kind"] == RESOURCE:
            emit(iid_ctx, e["id"], e["value"])
        else:                                        # bare res_inst
            rid = int(segs[2]) if len(segs) > 2 else e["id"]
            emit(iid_ctx, rid, e["value"], e["id"])
    return rows


def path_values_to_tlv(base_path: str, values: list[dict]) -> bytes:
    """[{path, value}] rows under ``base_path`` → a TLV Write body.

    Row paths are absolute (``/oid/iid/rid[/sub]``) or relative to the
    base. Nesting follows the base depth: an object base groups rows
    into OBJ_INSTANCE containers; multi-resource sub-ids nest as
    MULTI_RES → RES_INSTANCE. Malformed rows raise TlvError (never
    KeyError/IndexError — callers fall back on TlvError)."""
    base = [s for s in base_path.split("/") if s]
    if not base:
        raise TlvError("TLV needs an object path")
    try:
        oid = int(base[0])
    except ValueError as e:
        raise TlvError(f"bad object id in {base_path!r}") from e

    # normalize every row to (iid|None, rid, sub|None, value)
    norm: list[tuple[Optional[int], int, Optional[int], Any]] = []
    for row in values:
        if not isinstance(row, dict) or "path" not in row \
                or "value" not in row:
            raise TlvError(f"write row needs path+value: {row!r}")
        raw_p = str(row["path"])
        p = [s for s in raw_p.split("/") if s]
        if not p:
            raise TlvError(f"empty write path in row {row!r}")
        segs = p if raw_p.startswith("/") else base + p
        try:
            nums = [int(s) for s in segs]
        except ValueError as e:
            raise TlvError(f"non-numeric path {raw_p!r}") from e
        if nums[0] != oid or len(nums) < 2 or len(nums) > 4:
            raise TlvError(f"path {raw_p!r} outside base {base_path!r}")
        iid = nums[1] if len(nums) >= 3 else None
        rid = nums[2] if len(nums) >= 3 else nums[1]
        sub = nums[3] if len(nums) == 4 else None
        norm.append((iid, rid, sub, row["value"]))

    def resource_entries(rows) -> list[dict]:
        by_rid: dict[int, list] = {}
        for _iid, rid, sub, value in rows:
            by_rid.setdefault(rid, []).append((sub, value))
        out = []
        for rid, items in by_rid.items():
            rtype = _rtype(oid, rid)
            subs = [sub for sub, _v in items]
            if len(set(subs)) != len(subs):
                raise TlvError(
                    f"duplicate write target resource {rid}")
            if any(s is not None for s in subs):
                if any(s is None for s in subs):
                    # a whole-resource row mixed with res-instance rows
                    # has no defined TLV encoding
                    raise TlvError(
                        f"resource {rid}: mixed instance and "
                        "whole-resource rows")
                out.append({"kind": MULTI_RES, "id": rid, "children": [
                    {"kind": RES_INSTANCE, "id": sub,
                     "value": encode_value(v, rtype)}
                    for sub, v in items]})
            else:
                ((_s, v),) = items
                out.append({"kind": RESOURCE, "id": rid,
                            "value": encode_value(v, rtype)})
        return out

    if len(base) >= 2:                    # instance (or deeper) base:
        return tlv_encode(resource_entries(norm))    # flat resources
    by_iid: dict[int, list] = {}
    for row in norm:
        by_iid.setdefault(row[0] or 0, []).append(row)
    return tlv_encode([
        {"kind": OBJ_INSTANCE, "id": iid,
         "children": resource_entries(rows)}
        for iid, rows in by_iid.items()])
