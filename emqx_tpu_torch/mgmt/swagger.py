"""OpenAPI generator — the ``emqx_dashboard_swagger.erl`` analogue.

The reference derives its swagger document from the HOCON schemas that
also validate the config; here the same ``Struct``/``Field`` tree
(emqx_tpu_torch/config/schema.py) becomes OpenAPI component schemas, and the
ManagementApi route table becomes the path list — one source of truth
for validation, docs, and the REST surface.
"""

from __future__ import annotations

from typing import Any

from emqx_tpu_torch.config.schema import Field, Struct

_TYPE_MAP = {
    "bool": {"type": "boolean"},
    "int": {"type": "integer"},
    "float": {"type": "number"},
    "string": {"type": "string"},
    "duration": {"type": "string",
                 "description": "duration (e.g. 30s, 5m, 1h)"},
    "bytesize": {"type": "string",
                 "description": "byte size (e.g. 16MB, 1024KB)"},
    "map": {"type": "object", "additionalProperties": True},
}


def field_to_openapi(f: "Field | Struct") -> dict[str, Any]:
    if isinstance(f, Struct):
        return struct_to_openapi(f)
    spec = dict(_TYPE_MAP.get(f.type, {"type": "string"}))
    if f.type == "enum":
        spec = {"type": "string", "enum": list(f.enum or [])}
    if f.type == "array":
        spec = {"type": "array",
                "items": field_to_openapi(f.item) if f.item is not None
                else {"type": "string"}}
    if f.default is not None:
        spec["default"] = (f.default if not isinstance(f.default, bytes)
                           else f.default.decode("utf-8", "replace"))
    if f.desc:
        spec["description"] = f.desc
    return spec


def struct_to_openapi(s: Struct) -> dict[str, Any]:
    required = [k for k, f in s.fields.items()
                if isinstance(f, Field) and f.required]
    spec: dict[str, Any] = {
        "type": "object",
        "properties": {k: field_to_openapi(f) for k, f in s.fields.items()},
    }
    if required:
        spec["required"] = required
    if s.open:
        spec["additionalProperties"] = True
    if s.desc:
        spec["description"] = s.desc
    return spec


def generate(api, title: str = "EMQX-TPU Management API",
             version: str = "5.0.14-tpu") -> dict[str, Any]:
    """Build the OpenAPI 3.0 document from a ManagementApi instance."""
    from emqx_tpu_torch.config.schema import root_schema

    paths: dict[str, dict] = {}
    for method, _pat, names, fn, desc in api._routes:
        # desc carries the original path template (route() default)
        template = desc if desc.startswith("/") else None
        if template is None:
            continue
        op = {
            "summary": (fn.__doc__ or fn.__name__).strip().split("\n")[0],
            "security": [{"bearerAuth": []}],
            "responses": {"200": {"description": "success"}},
        }
        if names:
            op["parameters"] = [
                {"name": n, "in": "path", "required": True,
                 "schema": {"type": "string"}} for n in names
            ]
        if method in ("POST", "PUT"):
            op["requestBody"] = {"content": {"application/json": {
                "schema": {"type": "object"}}}}
        paths.setdefault(template, {})[method.lower()] = op
    return {
        "openapi": "3.0.3",
        "info": {"title": title, "version": version},
        "paths": dict(sorted(paths.items())),
        "components": {
            "securitySchemes": {
                "bearerAuth": {"type": "http", "scheme": "bearer",
                               "bearerFormat": "JWT"},
            },
            "schemas": {
                "Config": struct_to_openapi(root_schema()),
            },
        },
    }
